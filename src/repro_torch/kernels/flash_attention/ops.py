"""Flash attention (K2) and split-KV flash decode (K3): the plain versions
on CPU tensors, the CUDA kernels on CUDA tensors.

Replaces ``repro/kernels/flash_attention/ops.py`` (``flash_attention`` and
``flash_decode``, Pallas on a TPU and interpret mode elsewhere) and the
reference's ``flash_decode_partials``, whose partials the sequence-sharded
decode merges across shards.  ``flash_decode_int8`` is K3 read from the
int8 KV cache and its scales: the reference dequantises the cache eagerly
and then calls K3 (``repro.models.transformer._block_apply``); this entry
computes that same function in one kernel that reads the int8 bytes.

On an H100, K3 is bound by bytes (each live K/V row is read once for a few
flops) and K2 at prefill lengths by tensor-core operations; the designs are
in ``csrc/flash_decode.cu`` and ``csrc/flash_attention.cu``.

Which version runs is decided by where the caller put the tensors, never
by what is installed: a CUDA tensor launches the kernel or raises, and a
``meta`` tensor takes the shape-only path (``repro_torch.kernels.fake``:
the outputs, and one launch's work reported).  Each
wrapper call that launches adds one to ``launches[name]`` (K3's one call
runs a split kernel and a small merge kernel).  ``bq``/``bk`` are the
reference's tile arguments: the kernels choose their own tiles and mask
their own edges, so they never change the result.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fake
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import (
    MAX_HEAD_DIM,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.flash_decode import (
    flash_decode_cuda,
    flash_decode_int8_cuda,
    flash_decode_int8_partials_cuda,
    flash_decode_partials_cuda,
)

# Kernel launches since the last reset (set an entry to 0 to start a count).
launches = {"flash_attention": 0, "flash_decode": 0, "flash_decode_int8": 0,
            "flash_decode_int8_partials": 0}

_MAX_GROUP = 8
# K3's tensor-core variant (bf16 q); other bf16 head sizes from a bf16
# cache take its CUDA-core variant, as f32 does
_MMA_HEAD_DIMS = (64, 128, 256)


def _check(q, k, v, name: str, kv_dtype=None) -> bool:
    """Validate shapes and placement; True when the kernel is to run."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: expected q [B, T, H, hd] and k/v "
                         f"[B, S, KVH, hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)} (H must be a multiple of KVH)")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v on {q.device}, {k.device}, "
                         f"{v.device}")
    if q.device.type == "cpu":
        return False
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    want_kv = q.dtype if kv_dtype is None else kv_dtype
    if not (k.dtype == v.dtype == want_kv) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: kernel takes q float32 or bfloat16 and "
                        f"k, v {want_kv}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: kernel takes contiguous q, k, v")
    if q.device.type == "cuda" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: kernel takes 16-byte aligned q, k, v")
    return True


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """Blocked GQA attention: q [B, Tq, H, hd], k/v [B, Tk, KVH, hd] ->
    [B, Tq, H, hd] in q's dtype."""
    if bq <= 0 or bk <= 0:
        raise ValueError(f"bq and bk must be positive, got {bq}, {bk}")
    if not _check(q, k, v, "flash_attention"):
        return ref.attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    hd = q.shape[3]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} > {MAX_HEAD_DIM}")
    if q.numel() == 0:
        return torch.empty_like(q)
    if fake.is_fake(q):
        B, Tq, H, _ = q.shape
        pairs = Tq * k.shape[1]
        if causal:  # query i sees keys j <= q_offset + i
            pairs = sum(min(max(q_offset + i + 1, 0), k.shape[1])
                        for i in range(Tq))
        fake.report("k2", flops=4 * B * H * pairs * hd, dtype=q.dtype,
                    nbytes=2 * fake.nbytes(q) + fake.nbytes(k, v))
        return torch.empty_like(q)
    out = flash_attention_cuda(q, k, v, causal=causal, q_offset=int(q_offset))
    launches["flash_attention"] += 1
    return out


def _check_decode(q, k, v, kv_len, kv_offset, bk, kv_dtype=None) -> bool:
    if bk <= 0:
        raise ValueError(f"bk must be positive, got {bk}")
    on_card = _check(q, k, v, "flash_decode", kv_dtype)
    if q.shape[1] != 1:
        raise ValueError(f"flash_decode: one query token, got q "
                         f"{tuple(q.shape)}")
    if not on_card:
        return False
    hd, group = q.shape[3], q.shape[2] // k.shape[2]
    simt = hd >= 4 and hd % 4 == 0 and 32 % (hd // 4) == 0
    if q.dtype == torch.bfloat16 and hd not in _MMA_HEAD_DIMS and (
            kv_dtype == torch.int8 or not simt):
        raise ValueError(f"flash_decode: bf16 head_dim {hd} not in "
                         f"{_MMA_HEAD_DIMS}" + ("" if kv_dtype else
                                                " nor 4 x a divisor of 32"))
    if q.dtype == torch.float32 and not simt:
        raise ValueError(f"flash_decode: f32 head_dim {hd} must be 4 x a "
                         "divisor of 32")
    if not 1 <= group <= _MAX_GROUP:
        raise ValueError(f"flash_decode: group {group} outside 1..{_MAX_GROUP}")
    if q.shape[0] == 0:
        raise ValueError("flash_decode: empty batch")
    return True


def _fake_decode(name: str, q, cache: tuple, kv_len: int, kv_offset: int,
                 partials: bool = False):
    """K3's shape-only launch over a cache slice of global rows
    [kv_offset, kv_offset + S): 4 * B * H * live * hd operations over its
    live rows (those below ``kv_len``), which with q are read once and the
    output written once; the output, or the float32 partials."""
    B, _, H, hd = q.shape
    S, KVH = cache[0].shape[1], cache[0].shape[2]
    live = min(max(kv_len - kv_offset, 0), S)
    if partials:
        G = H // KVH
        out = tuple(torch.empty((B, KVH, G, n), dtype=torch.float32,
                                device=q.device) for n in (1, 1, hd))
    else:
        out = torch.empty_like(q)
    rows = sum(t.numel() // S * live * t.element_size() for t in cache)
    written = fake.nbytes(*out) if partials else fake.nbytes(out)
    fake.report(name, flops=4 * B * H * live * hd, dtype=q.dtype,
                nbytes=fake.nbytes(q) + rows + written)
    return out


def flash_decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, kv_len: int, kv_offset: int = 0, bk: int = 512):
    """Per-(batch, kv-head, group) softmax partials over a KV slice.

    q [B, 1, H, hd]; k/v [B, S, KVH, hd] holding global positions
    [kv_offset, kv_offset + S); kv_len masks against global position.
    Returns float32 (m, l [B, KVH, group, 1], o [B, KVH, group, hd]),
    merged over the local splits; a slice with no live row gives exactly
    m = -1e30, l = 0, o = 0.
    """
    if not _check_decode(q, k, v, kv_len, kv_offset, bk):
        return ref.flash_decode_partials_ref(q, k, v, kv_len=kv_len,
                                             kv_offset=kv_offset, bk=bk)
    if fake.is_fake(q):
        return _fake_decode("k3_partials", q, (k, v), kv_len, kv_offset,
                            partials=True)
    out = flash_decode_partials_cuda(q, k, v, kv_len=int(kv_len),
                                     kv_offset=int(kv_offset))
    launches["flash_decode"] += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 kv_len: int, kv_offset: int = 0, bk: int = 512
                 ) -> torch.Tensor:
    """Split-KV decode: q [B, 1, H, hd] against cache k/v [B, S, KVH, hd]
    -> [B, 1, H, hd] in q's dtype.

    kv_offset: global position of k/v row 0 (non-zero for a shard of a
    sequence-sharded cache); kv_len masks against global position.
    """
    if not _check_decode(q, k, v, kv_len, kv_offset, bk):
        return ref.flash_decode_ref(q, k, v, kv_len=kv_len,
                                    kv_offset=kv_offset, bk=bk)
    if fake.is_fake(q):
        return _fake_decode("k3", q, (k, v), kv_len, kv_offset)
    out = flash_decode_cuda(q, k, v, kv_len=int(kv_len),
                            kv_offset=int(kv_offset))
    launches["flash_decode"] += 1
    return out


def _check_int8(q, kq, ks, vq, vs, kv_len, kv_offset, bk) -> bool:
    """Validate the int8 entries' inputs; True when the kernel is to run."""
    if kq.dtype != torch.int8 or vq.dtype != torch.int8:
        raise TypeError(f"flash_decode_int8: k/v must be int8, got "
                        f"{kq.dtype}, {vq.dtype}")
    want = (*kq.shape[:3], 1)
    for name, s in (("ks", ks), ("vs", vs)):
        if tuple(s.shape) != want:
            raise ValueError(f"flash_decode_int8: {name} {tuple(s.shape)}, "
                             f"expected {want}")
        if s.dtype != torch.float32:
            raise TypeError(f"flash_decode_int8: {name} must be float32, "
                            f"got {s.dtype}")
        if s.device != q.device:
            raise ValueError(f"flash_decode_int8: {name} on {s.device}, q "
                             f"on {q.device}")
    on_card = _check_decode(q, kq, vq, kv_len, kv_offset, bk,
                            kv_dtype=torch.int8)
    if on_card and not (ks.is_contiguous() and vs.is_contiguous()):
        raise ValueError("flash_decode_int8: kernel takes contiguous scales")
    return on_card


def flash_decode_int8(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                      vq: torch.Tensor, vs: torch.Tensor, *, kv_len: int,
                      kv_offset: int = 0, bk: int = 512) -> torch.Tensor:
    """Split-KV decode from the int8 cache: q [B, 1, H, hd] against int8
    kq/vq [B, S, KVH, hd] with f32 scales ks/vs [B, S, KVH, 1] (the layout
    of ``models.transformer._quantize_kv``) -> [B, 1, H, hd] in q's dtype.

    The same function as ``flash_decode(q, kq.to(q.dtype) * ks.to(q.dtype),
    vq.to(q.dtype) * vs.to(q.dtype), ...)``, rounded as that eager
    dequantisation rounds, without the dequantised copy."""
    if not _check_int8(q, kq, ks, vq, vs, kv_len, kv_offset, bk):
        return ref.flash_decode_int8_ref(q, kq, ks, vq, vs, kv_len=kv_len,
                                         kv_offset=kv_offset, bk=bk)
    if fake.is_fake(q):
        return _fake_decode("k3_int8", q, (kq, ks, vq, vs), kv_len, kv_offset)
    out = flash_decode_int8_cuda(q, kq, ks, vq, vs, kv_len=int(kv_len),
                                 kv_offset=int(kv_offset))
    launches["flash_decode_int8"] += 1
    return out


def flash_decode_int8_partials(q: torch.Tensor, kq: torch.Tensor,
                               ks: torch.Tensor, vq: torch.Tensor,
                               vs: torch.Tensor, *, kv_len: int,
                               kv_offset: int = 0, bk: int = 512):
    """``flash_decode_partials`` over the int8 cache: q [B, 1, H, hd]
    against int8 kq/vq [B, S, KVH, hd] with f32 scales ks/vs [B, S, KVH, 1]
    holding global positions [kv_offset, kv_offset + S); kv_len masks
    against global position.  Returns float32 (m, l [B, KVH, group, 1],
    o [B, KVH, group, hd]) merged over the local splits, the partials one
    shard of a sequence-sharded cache contributes; a slice with no live
    row gives exactly m = -1e30, l = 0, o = 0."""
    if not _check_int8(q, kq, ks, vq, vs, kv_len, kv_offset, bk):
        return ref.flash_decode_int8_partials_ref(
            q, kq, ks, vq, vs, kv_len=kv_len, kv_offset=kv_offset, bk=bk)
    if fake.is_fake(q):
        return _fake_decode("k3_int8_partials", q, (kq, ks, vq, vs), kv_len,
                            kv_offset, partials=True)
    out = flash_decode_int8_partials_cuda(q, kq, ks, vq, vs,
                                          kv_len=int(kv_len),
                                          kv_offset=int(kv_offset))
    launches["flash_decode_int8_partials"] += 1
    return out
