"""HW-aware model partition (paper §IV-B, Figure 10).

Splits a workload's operator profile into placed stages under the device's
memory-capacity constraint:

- ``cpu_model``      : whole graph G_m on host threads (model-based).
- ``cpu_sd``         : SparseNet pool + DenseNet pool on host, pipelined
                       through an intermediate queue (Fig. 10b).
- ``accel_sd``       : G_s on host, G_d on accelerator (Fig. 10c); link
                       carries the pooled [F, D] embeddings.
- ``accel_hot``      : locality-aware split (Fig. 10a/d): hot embedding rows
                       + G_d on the accelerator, cold rows pooled on host and
                       shipped as a partial sum (Psum) over the link.
- ``accel_full``     : entire model on the accelerator (small models only —
                       this is the Baymax/DeepRecSys regime and why they
                       "do not scale to large recommendation models").

hot_frac is sized from the capacity budget per co-located thread:
(capacity / m − dense weights − margin) / table_size (paper: "capacity
budget per thread = memory capacity / model co-location").
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.devices import DeviceProfile
from repro_torch.core.workload import ModelProfile, OpCost


@dataclasses.dataclass(frozen=True)
class Placement:
    """Operator placement + link traffic for one partition plan."""

    plan: str                      # cpu_model | cpu_sd | accel_sd | accel_hot | accel_full
    host_sparse: tuple[OpCost, ...]
    host_dense: tuple[OpCost, ...]
    accel_ops: tuple[OpCost, ...]
    link_bytes_per_item: float     # host -> accel transfer per ranked item
    hot_frac: float = 0.0
    pipelined: bool = False        # host-side S-D pipelining

    @property
    def uses_accel(self) -> bool:
        return bool(self.accel_ops)

    @property
    def host_ops(self) -> tuple[OpCost, ...]:
        return self.host_sparse + self.host_dense


HBM_MARGIN_GB = 1.0  # activations/workspace reserve per accelerator


def hot_capacity_frac(profile: ModelProfile, device: DeviceProfile, colocate: int) -> float:
    """Fraction of the embedding table that fits on the accelerator."""
    acc = device.accel
    if acc is None or profile.table_gb <= 0:
        return 0.0
    budget = acc.capacity_gb / max(colocate, 1) - profile.weight_gb - HBM_MARGIN_GB
    return max(0.0, min(1.0, budget / profile.table_gb))


def _scale_gather(ops, factor):
    return tuple(
        dataclasses.replace(
            op,
            gather_bytes=op.gather_bytes * factor,
            flops=op.flops * factor if op.stage == "sparse" else op.flops,
            host_bytes=op.host_bytes * factor,
        )
        for op in ops
    )


def sparse_output_bytes(profile: ModelProfile) -> float:
    """Pooled SparseNet output per item (the S-D intermediate payload)."""
    return sum(op.stream_bytes for op in profile.sparse_ops)


def sparse_id_bytes(profile: ModelProfile) -> float:
    return sum(op.host_bytes for op in profile.sparse_ops)


def dense_input_bytes(profile: ModelProfile) -> float:
    return sum(op.host_bytes for op in profile.dense_ops)


def enumerate_placements(
    profile: ModelProfile, device: DeviceProfile, colocate: int = 1
) -> list[Placement]:
    """All feasible partition plans for (workload, server, co-location)."""
    s_ops, d_ops = profile.sparse_ops, profile.dense_ops
    out = [
        Placement("cpu_model", s_ops, d_ops, (), 0.0),
    ]
    if s_ops and d_ops:
        out.append(Placement("cpu_sd", s_ops, d_ops, (), 0.0, pipelined=True))
    acc = device.accel
    if acc is None:
        return out

    total_gb = profile.table_gb + profile.weight_gb
    weights_fit = profile.weight_gb + HBM_MARGIN_GB <= acc.capacity_gb / max(colocate, 1)
    if not weights_fit:
        return out

    if s_ops:
        # Fig 10c: sparse on host, dense on accel; link = pooled embeddings
        # + the dense features.
        out.append(Placement(
            "accel_sd", s_ops, (), d_ops,
            link_bytes_per_item=sparse_output_bytes(profile) + dense_input_bytes(profile),
        ))
        hf = hot_capacity_frac(profile, device, colocate)
        if 0.0 < hf < 1.0:
            hit = profile.hot_hit_rate(hf)
            accel_sparse = _scale_gather(s_ops, hit)
            host_cold = _scale_gather(s_ops, 1.0 - hit)
            # Fig 10d link: cold Psum [F, D] + hot ids + dense features.
            link = (
                sparse_output_bytes(profile)
                + sparse_id_bytes(profile) * hit
                + dense_input_bytes(profile)
            )
            out.append(Placement(
                "accel_hot", host_cold, (), accel_sparse + d_ops,
                link_bytes_per_item=link, hot_frac=hf,
            ))
        if hf >= 1.0 or total_gb + HBM_MARGIN_GB <= acc.capacity_gb / max(colocate, 1):
            out.append(Placement(
                "accel_full", (), (), s_ops + d_ops,
                link_bytes_per_item=sparse_id_bytes(profile) + dense_input_bytes(profile),
            ))
    else:
        out.append(Placement(
            "accel_full", (), (), d_ops,
            link_bytes_per_item=dense_input_bytes(profile),
        ))
    return out
