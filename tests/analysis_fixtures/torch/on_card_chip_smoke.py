"""Stands in for ``chip_smoke.py`` beside the kernel pass's corpus (parsed,
never run): the kernel entries it names are held on the card."""
from repro_torch.kernels.bad_kernels import ops as bad
from repro_torch.kernels.clean_kernels import ops as clean


def check_bad(q, k, v, kq, ks, vq, vs):
    bad.flash_attention(q, k, v)
    bad.flash_decode(q, k, v, kv_len=7)
    bad.flash_decode_partials(q, k, v, kv_len=7)
    bad.flash_decode_int8(q, kq, ks, vq, vs, kv_len=7)
    bad.flash_decode_unchecked(q, k, v, kv_len=7)


def check_clean(q, k, v):
    clean.flash_attention(q, k, v)
    clean.flash_decode(q, k, v, kv_len=7)


def check_other(bad, q, k, v):
    # this ``bad`` is the parameter, not the import: it names no entry
    bad.flash_decode_shadowed(q, k, v, kv_len=7)
