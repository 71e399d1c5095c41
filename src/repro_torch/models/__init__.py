"""Model families of the port on torch tensors."""
from repro_torch.models import din, dlrm, mind, widedeep

# the model library of each recsys interaction (the reference's
# RECSYS_INIT / RECSYS_APPLY)
RECSYS_MODELS = {
    "dot": dlrm,
    "concat": widedeep,
    "target-attn": din,
    "multi-interest": mind,
}
