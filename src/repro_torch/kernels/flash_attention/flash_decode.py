"""ctypes launcher of the CUDA split-KV decode kernel (``csrc/flash_decode.cu``).

The counterpart of the reference's ``flash_decode_partials`` and
``flash_decode_pallas``: it takes checked tensors from ``ops`` and launches
on PyTorch's current stream, from a cache in q's dtype or from the int8
cache and its f32 scales (the int8 entry).  The split of the KV rows is
the kernel's own choice (the reference's ``bk`` does not enter): only the
live rows ``[0, kv_len - kv_offset)`` are split, into enough pieces that
the card has about ``TARGET_BLOCKS`` blocks (some two waves of the two
blocks each of the 132 SMs holds at head size 128), each at least
``MIN_SPLIT`` rows (four 64-row tiles) long.  A long cache gets long
splits that amortise the fill of a block's ring of tiles; a short one, as
the LM tenant's, gets more blocks than a longer floor would give it, for
more bytes in flight.  ``tools/torch_tenant_step.py --sweep`` times the
plans at the tenant's and the decode_32k shapes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

TARGET_BLOCKS = 512
MIN_SPLIT = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("flash_decode")
        fn = lib.repro_flash_decode
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int64] * 11 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.repro_cuda_error_string)
    return _fn


def split_plan(n_live: int, bh: int) -> tuple[int, int]:
    """(split_len, n_splits) for ``n_live`` live rows of ``bh`` kv heads."""
    if n_live <= 0:
        return MIN_SPLIT, 0
    want = max(1, -(-TARGET_BLOCKS // bh))
    split_len = max(MIN_SPLIT, -(-n_live // want))
    return split_len, -(-n_live // split_len)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(q, k, v, *, kv_len: int, kv_offset: int, out, partials,
            scales=None):
    """Split kernel then merge kernel: into ``out`` (the attention, q's
    dtype) or, with ``out`` None, into ``partials`` = (m, l, o) in f32.
    ``scales`` = (ks, vs) makes k/v the int8 cache."""
    fn, err_str = _kernel()
    B, _, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    n_live = max(0, min(S, kv_len - kv_offset))
    split_len, n_splits = split_plan(n_live, B * KVH)
    f32 = dict(dtype=torch.float32, device=q.device)
    pm = torch.empty((B * KVH * n_splits * G,), **f32)
    pl = torch.empty_like(pm)
    po = torch.empty((B * KVH * n_splits * G * hd,), **f32)
    m, l, o = partials if partials is not None else (None, None, None)
    ks, vs = scales if scales is not None else (None, None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs),
             pm.data_ptr(), pl.data_ptr(), po.data_ptr(), _ptr(m), _ptr(l),
             _ptr(o), _ptr(out), B, S, KVH, G, hd, n_live, split_len,
             n_splits, _DTYPE_CODE[q.dtype], int(scales is not None),
             q.device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_decode kernel launch failed: {err_str(err).decode()} "
            f"(cuda error {err})")


def flash_decode_partials_cuda(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, kv_len: int,
                               kv_offset: int):
    """Checked q [B, 1, H, hd], k/v [B, S, KVH, hd] on one CUDA device ->
    f32 (m, l [B, KVH, G, 1], o [B, KVH, G, hd]) merged over the splits."""
    B, _, H, hd = q.shape
    KVH = k.shape[2]
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.empty((B, KVH, H // KVH, 1), **f32)
    l = torch.empty_like(m)
    o = torch.empty((B, KVH, H // KVH, hd), **f32)
    _launch(q, k, v, kv_len=kv_len, kv_offset=kv_offset, out=None,
            partials=(m, l, o))
    return m, l, o


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      kv_len: int, kv_offset: int) -> torch.Tensor:
    """Checked inputs as above -> attention [B, 1, H, hd] in q's dtype."""
    out = torch.empty_like(q)
    _launch(q, k, v, kv_len=kv_len, kv_offset=kv_offset, out=out,
            partials=None)
    return out


def flash_decode_int8_partials_cuda(q: torch.Tensor, kq: torch.Tensor,
                                    ks: torch.Tensor, vq: torch.Tensor,
                                    vs: torch.Tensor, *, kv_len: int,
                                    kv_offset: int):
    """Checked q [B, 1, H, hd], int8 kq/vq [B, S, KVH, hd] and f32 scales
    ks/vs [B, S, KVH, 1] on one CUDA device -> f32 (m, l [B, KVH, G, 1],
    o [B, KVH, G, hd]) merged over the splits."""
    B, _, H, hd = q.shape
    KVH = kq.shape[2]
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.empty((B, KVH, H // KVH, 1), **f32)
    l = torch.empty_like(m)
    o = torch.empty((B, KVH, H // KVH, hd), **f32)
    _launch(q, kq, vq, kv_len=kv_len, kv_offset=kv_offset, out=None,
            partials=(m, l, o), scales=(ks, vs))
    return m, l, o


def flash_decode_int8_cuda(q: torch.Tensor, kq: torch.Tensor,
                           ks: torch.Tensor, vq: torch.Tensor,
                           vs: torch.Tensor, *, kv_len: int,
                           kv_offset: int) -> torch.Tensor:
    """Checked q [B, 1, H, hd], int8 kq/vq [B, S, KVH, hd] and f32 scales
    ks/vs [B, S, KVH, 1] on one CUDA device -> attention [B, 1, H, hd] in
    q's dtype."""
    out = torch.empty_like(q)
    _launch(q, kq, vq, kv_len=kv_len, kv_offset=kv_offset, out=out,
            partials=None, scales=(ks, vs))
    return out
