"""dense_self_ms: device milliseconds a step of the operations launched
inside the port's DenseNet span (``repro_torch.dense``) and outside its
MLP spans: DLRM's casts, ``cat``, ``bmm`` and pair gather; MT-WnD's
``cat``, wide GEMV and sum, and the towers' stack."""
from bench.progtrace import span_ms


def read(run):
    return span_ms(run, "dense")
