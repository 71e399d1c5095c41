"""mlp_ms: device milliseconds a step of the operations launched inside
the port's MLP spans (``repro_torch.mlp``, each ``models/layers.apply_mlp``
call: its GEMMs, bias adds and activations)."""
from bench.progtrace import span_ms


def read(run):
    return span_ms(run, "mlp")
