"""Stands in for ``tests/test_torch_cuda.py`` beside the kernel pass's
corpus (parsed, never run): the kernel entries it names are held on the
card."""


def check_bad(q, k, v, kq, ks, vq, vs):
    from repro_torch.kernels.bad_kernels import ops
    ops.flash_attention(q, k, v)
    ops.flash_decode(q, k, v, kv_len=7)
    ops.flash_decode_partials(q, k, v, kv_len=7)
    ops.flash_decode_int8(q, kq, ks, vq, vs, kv_len=7)
    ops.flash_decode_shadowed(q, k, v, kv_len=7)


def check_clean(q, k, v):
    from repro_torch.kernels.clean_kernels.ops import (
        flash_attention,
        flash_decode,
    )
    flash_attention(q, k, v)
    flash_decode(q, k, v, kv_len=7)


def check_other(ops, q, k, v):
    # this ``ops`` is the parameter, not check_bad's import: it names no
    # entry
    ops.flash_decode_unchecked(q, k, v, kv_len=7)


def check_local(load, q, k, v):
    ops = load()  # a local, not check_bad's import: it names no entry
    ops.flash_decode_unchecked(q, k, v, kv_len=7)
