from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_decode,
    flash_decode_int8,
    flash_decode_int8_partials,
    flash_decode_partials,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    flash_decode_int8_partials_ref,
    flash_decode_int8_ref,
    flash_decode_partials_ref,
    flash_decode_ref,
    lse_combine,
)

__all__ = ["flash_attention", "flash_decode", "flash_decode_int8",
           "flash_decode_int8_partials", "flash_decode_partials",
           "attention_ref", "flash_decode_int8_partials_ref",
           "flash_decode_int8_ref",
           "flash_decode_partials_ref", "flash_decode_ref", "lse_combine"]
