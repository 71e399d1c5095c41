"""Decode attention: the model-facing entry of the split-KV decode (K3).

Counterpart of ``repro.dist.decode``.  The reference picks, at trace time,
between the local split-KV kernel and a ``shard_map`` over a
sequence-sharded cache (per-shard partials, an all-gather, ``lse_combine``).
The port has the single-device branch; the sequence-sharded one
(``flash_decode_sharded``) waits for the ``torch.distributed`` layer and
raises if asked for.  ``decode_attention_int8`` is the same decode over
the int8 cache, read by K3's int8 entry without a dequantised copy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import (
    flash_decode,
    flash_decode_int8,
)


def flash_decode_sharded(*args, **kwargs):
    raise NotImplementedError(
        "sequence-sharded flash decode is not ported yet; the port serves "
        "decode from one device (decode_attention)")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: int, bk: int = 512) -> torch.Tensor:
    """q [B, 1, H, hd] against the whole local cache k/v [B, S, KVH, hd];
    rows at or past ``kv_len`` are masked.  Returns [B, 1, H, hd]."""
    return flash_decode(q, k, v, kv_len=kv_len, bk=bk)


def decode_attention_int8(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                          vq: torch.Tensor, vs: torch.Tensor, *, kv_len: int,
                          bk: int = 512) -> torch.Tensor:
    """``decode_attention`` over the whole local int8 cache kq/vq
    [B, S, KVH, hd] with f32 scales ks/vs [B, S, KVH, 1], dequantised in q's
    dtype as the model's eager path does.  Returns [B, 1, H, hd]."""
    return flash_decode_int8(q, kq, ks, vq, vs, kv_len=kv_len, bk=bk)
