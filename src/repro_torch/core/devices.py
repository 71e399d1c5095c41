"""Server/device profiles — the heterogeneous hardware pool (paper Table II).

The paper evaluates CPU-only, CPU+NMP and CPU+GPU servers with real
measurement plus a cycle-level NMP LUT; here the same role is played by
analytic profiles: each profile carries the roofline constants (compute
rate, stream bandwidth, random-gather bandwidth, host link bandwidth) and
the power envelope. ``repro_torch.core.perfmodel`` executes a model's
operator profile against a profile.  (Numpy copy of ``repro.core.devices``;
the constants are the reference's, not measurements of the port.)

Profiles T1–T10 mirror Table II; TPU v5e is added as the TPU-era extension
with a SparseCore-style gather-offload standing in for NMP rank parallelism.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CPUSpec:
    cores: int
    gflops_per_core: float     # effective dense GFLOP/s per physical core
    tdp_w: float
    idle_w: float


@dataclasses.dataclass(frozen=True)
class MemSpec:
    bw_gbs: float              # stream bandwidth
    gather_eff: float          # random-gather fraction of stream bw
    nmp_factor: float          # gather-bandwidth multiplier (rank parallelism)
    capacity_gb: float
    tdp_w: float
    idle_w: float


@dataclasses.dataclass(frozen=True)
class AccelSpec:
    peak_gflops: float         # dense compute
    hbm_gbs: float
    gather_eff: float
    link_gbs: float            # host<->device (PCIe) or ICI
    capacity_gb: float
    tdp_w: float
    idle_w: float
    kernel_overhead_us: float  # per-op launch overhead
    max_colocate: int = 8      # MPS-style co-location limit


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    cpu: CPUSpec
    mem: MemSpec
    accel: AccelSpec | None = None

    @property
    def has_accel(self) -> bool:
        return self.accel is not None

    @property
    def peak_power_w(self) -> float:
        p = self.cpu.tdp_w + self.mem.tdp_w
        if self.accel:
            p += self.accel.tdp_w
        return p

    @property
    def idle_power_w(self) -> float:
        p = self.cpu.idle_w + self.mem.idle_w
        if self.accel:
            p += self.accel.idle_w
        return p


# -- component library (paper Table II) -------------------------------------

# Xeon D-2191: 18 cores @ 1.6 GHz. Effective DL GEMM throughput per core
# (AVX-512 with frequency throttling, ~60% efficiency): ~31 GFLOP/s f32.
CPU_T1 = CPUSpec(cores=18, gflops_per_core=31.0, tdp_w=86.0, idle_w=25.0)
# Xeon Gold 6138: 20 cores @ 2.0 GHz, 2 FMA units: ~77 GFLOP/s effective.
CPU_T2 = CPUSpec(cores=20, gflops_per_core=77.0, tdp_w=125.0, idle_w=36.0)

DDR4_T1 = MemSpec(bw_gbs=77.0, gather_eff=0.35, nmp_factor=1.0,
                  capacity_gb=64.0, tdp_w=28.0, idle_w=8.0)
DDR4_T2 = MemSpec(bw_gbs=85.0, gather_eff=0.35, nmp_factor=1.0,
                  capacity_gb=128.0, tdp_w=50.0, idle_w=14.0)


def _nmp(n: int) -> MemSpec:
    """RecNMP-style DIMM: N-rank parallel gather-reduce. Random-gather
    bandwidth scales ~N× (rank-level parallelism + on-DIMM pooling also
    removes the CPU-side reduce traffic); stream bandwidth unchanged."""
    return MemSpec(bw_gbs=85.0, gather_eff=0.8, nmp_factor=float(n),
                   capacity_gb=128.0 * n, tdp_w=50.0 * n, idle_w=14.0 * n)


P100 = AccelSpec(peak_gflops=9_300.0, hbm_gbs=732.0, gather_eff=0.5,
                 link_gbs=16.0, capacity_gb=16.0, tdp_w=300.0, idle_w=30.0,
                 kernel_overhead_us=8.0)
V100 = AccelSpec(peak_gflops=14_000.0, hbm_gbs=900.0, gather_eff=0.5,
                 link_gbs=16.0, capacity_gb=16.0, tdp_w=300.0, idle_w=30.0,
                 kernel_overhead_us=8.0)

# TPU v5e: bf16 MXU 197 TFLOP/s, 819 GB/s HBM, 16 GB; host link modeled at
# PCIe-class 32 GB/s; SparseCore-style gather offload -> high gather_eff.
TPU_V5E = AccelSpec(peak_gflops=197_000.0, hbm_gbs=819.0, gather_eff=0.75,
                    link_gbs=32.0, capacity_gb=16.0, tdp_w=250.0, idle_w=40.0,
                    kernel_overhead_us=4.0)


SERVER_TYPES: dict[str, DeviceProfile] = {
    "T1": DeviceProfile("T1", CPU_T1, DDR4_T1),
    "T2": DeviceProfile("T2", CPU_T2, DDR4_T2),
    "T3": DeviceProfile("T3", CPU_T2, _nmp(2)),
    "T4": DeviceProfile("T4", CPU_T2, _nmp(4)),
    "T5": DeviceProfile("T5", CPU_T2, _nmp(8)),
    "T6": DeviceProfile("T6", CPU_T1, DDR4_T1, P100),
    "T7": DeviceProfile("T7", CPU_T2, DDR4_T2, V100),
    "T8": DeviceProfile("T8", CPU_T2, _nmp(2), V100),
    "T9": DeviceProfile("T9", CPU_T2, _nmp(4), V100),
    "T10": DeviceProfile("T10", CPU_T2, _nmp(8), V100),
    # TPU-era extension
    "T11-v5e": DeviceProfile("T11-v5e", CPU_T2, DDR4_T2, TPU_V5E),
}

# Paper §III-C / §VI availability limits N_h.
DEFAULT_AVAILABILITY: dict[str, int] = {
    "T1": 100, "T2": 100, "T3": 15, "T4": 10, "T5": 5,
    "T6": 10, "T7": 5, "T8": 6, "T9": 4, "T10": 2,
    "T11-v5e": 4,
}
