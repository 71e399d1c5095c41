from repro_torch.kernels.fleet_fifo.ops import fleet_fifo
from repro_torch.kernels.fleet_fifo.ref import fleet_fifo_ref

__all__ = ["fleet_fifo", "fleet_fifo_ref"]
