"""Plain PyTorch versions of the attention kernels K2 and K3.

Counterpart of ``repro.kernels.flash_attention.ref`` (``attention_ref``),
plus the whole-tensor form of the split-KV decode partials and the
``lse_combine`` merge of ``repro.kernels.flash_attention.flash_decode``.
``flash_decode_int8_ref`` is the int8 entry's plain version: the eager
dequantisation the reference runs around its K3 call
(``repro.models.transformer._block_apply``), then ``flash_decode_ref``.
They are the CPU path of ``ops`` and the oracles the CUDA kernels are held
against on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0, kv_len=None
                  ) -> torch.Tensor:
    """q [B, Tq, H, hd]; k/v [B, Tk, KVH, hd] -> [B, Tq, H, hd].

    Query i's absolute position is q_offset + i; with causal it attends to
    kv j <= q_offset + i.  kv_len (int or [B] tensor; its first entry is
    used, as in the reference) masks the cache tail.  Scores are formed in
    q's dtype and softmaxed in float32, as the reference does.
    """
    B, Tq, H, hd = q.shape
    Tk, KVH = k.shape[1], k.shape[2]
    qg = q.reshape(B, Tq, KVH, H // KVH, hd)
    logits = (torch.einsum("btkgh,bskh->bkgts", qg, k) / math.sqrt(hd)).float()
    jpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = jpos <= (torch.arange(Tq, device=q.device)[:, None] + q_offset)
    if kv_len is not None:
        first = int(torch.as_tensor(kv_len).reshape(-1)[0])
        mask = mask & (jpos < first)
    logits = torch.where(mask[None, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v)
    return out.reshape(B, Tq, H, hd)


def lse_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, axis: int):
    """Merge split-softmax partials along ``axis``.

    m/l: [..., n, group, 1]; o: [..., n, group, hd] -> combined
    [..., group, hd] plus the combined (m, l) for further hierarchical
    merging.  Permutation-invariant and associative, like the reference."""
    m_max = m.amax(dim=axis, keepdim=True)
    alpha = torch.exp(m - m_max)
    return m_max.squeeze(axis), (l * alpha).sum(dim=axis), (o * alpha).sum(dim=axis)


def flash_decode_partials_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, kv_len: int,
                              kv_offset: int = 0, bk: int = 512):
    """The split-KV decode partials of ``flash_decode_partials``, computed
    on whole tensors: q [B, 1, H, hd]; k/v [B, S, KVH, hd] holding global
    positions [kv_offset, kv_offset + S); rows at or past ``kv_len`` are
    masked.  Returns float32 (m, l [B, KVH, group, 1], o [B, KVH, group, hd]).

    A slice with no live row gives exactly m = -1e30, l = 0, o = 0.  ``bk``
    (the reference's chunk) does not change the merged partials and is
    accepted for the reference's signature."""
    if bk <= 0:
        raise ValueError(f"bk must be positive, got {bk}")
    B, _, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    qf = q.reshape(B, KVH, H // KVH, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qf, k.float()) * (1.0 / math.sqrt(hd))
    live = (kv_offset + torch.arange(S, device=q.device)) < kv_len   # [S]
    s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    return m, l, o


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: int, kv_offset: int = 0, bk: int = 512
                     ) -> torch.Tensor:
    """q [B, 1, H, hd] against cache k/v [B, S, KVH, hd] -> [B, 1, H, hd]
    in q's dtype: the partials, then o / max(l, 1e-30)."""
    B, _, H, hd = q.shape
    _, l, o = flash_decode_partials_ref(q, k, v, kv_len=kv_len,
                                        kv_offset=kv_offset, bk=bk)
    out = (o / l.clamp_min(1e-30)).to(q.dtype)
    return out.reshape(B, 1, H, hd)


def dequantize_kv(xq: torch.Tensor, xs: torch.Tensor, dtype: torch.dtype
                  ) -> torch.Tensor:
    """The int8 cache in ``dtype``: int8 x scale, both cast to ``dtype``
    first, as the reference's model dequantises its cache."""
    return xq.to(dtype) * xs.to(dtype)


def flash_decode_int8_ref(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                          vq: torch.Tensor, vs: torch.Tensor, *, kv_len: int,
                          kv_offset: int = 0, bk: int = 512) -> torch.Tensor:
    """q [B, 1, H, hd] against the int8 cache kq/vq [B, S, KVH, hd] with
    f32 scales ks/vs [B, S, KVH, 1] -> [B, 1, H, hd] in q's dtype."""
    return flash_decode_ref(q, dequantize_kv(kq, ks, q.dtype),
                            dequantize_kv(vq, vs, q.dtype), kv_len=kv_len,
                            kv_offset=kv_offset, bk=bk)
