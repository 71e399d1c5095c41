"""k1_ms: device milliseconds a step of the operations launched inside
the port's own K1 span (``repro_torch.k1``, K1's forward entries in
``kernels/embedding_bag/ops.py``)."""
from bench.progtrace import span_ms


def read(run):
    return span_ms(run, "k1")
