"""Flash attention (K2) and split-KV flash decode (K3): the plain versions
on CPU tensors, the CUDA kernels on CUDA tensors.

Replaces ``repro/kernels/flash_attention/ops.py`` (``flash_attention`` and
``flash_decode``, Pallas on a TPU and interpret mode elsewhere) and the
reference's ``flash_decode_partials``, whose partials the sequence-sharded
decode merges across shards.

On an H100, K3 is bound by bytes (each live K/V row is read once for a few
flops) and K2 at prefill lengths by tensor-core operations; the designs are
in ``csrc/flash_decode.cu`` and ``csrc/flash_attention.cu``.

Which version runs is decided by where the caller put the tensors, never
by what is installed: a CUDA tensor launches the kernel or raises.  Each
wrapper call that launches adds one to ``launches[name]`` (K3's one call
runs a split kernel and a small merge kernel).  ``bq``/``bk`` are the
reference's tile arguments: the kernels choose their own tiles and mask
their own edges, so they never change the result.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import (
    MAX_HEAD_DIM,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.flash_decode import (
    flash_decode_cuda,
    flash_decode_partials_cuda,
)

# Kernel launches since the last reset (set an entry to 0 to start a count).
launches = {"flash_attention": 0, "flash_decode": 0}

_MAX_GROUP = 8


def _check(q, k, v, name: str) -> bool:
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
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: kernel takes q, k, v all float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: kernel takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
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
    out = flash_attention_cuda(q, k, v, causal=causal, q_offset=int(q_offset))
    launches["flash_attention"] += 1
    return out


def _check_decode(q, k, v, kv_len, kv_offset, bk) -> bool:
    if bk <= 0:
        raise ValueError(f"bk must be positive, got {bk}")
    on_card = _check(q, k, v, "flash_decode")
    if q.shape[1] != 1:
        raise ValueError(f"flash_decode: one query token, got q "
                         f"{tuple(q.shape)}")
    if not on_card:
        return False
    hd, group = q.shape[3], q.shape[2] // k.shape[2]
    vec = 16 // q.element_size()
    if hd % vec or 32 % (hd // vec):
        raise ValueError(f"flash_decode: head_dim {hd} must be {vec} x a "
                         f"divisor of 32 for {q.dtype}")
    if not 1 <= group <= _MAX_GROUP:
        raise ValueError(f"flash_decode: group {group} outside 1..{_MAX_GROUP}")
    if q.shape[0] == 0:
        raise ValueError("flash_decode: empty batch")
    return True


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
    out = flash_decode_cuda(q, k, v, kv_len=int(kv_len),
                            kv_offset=int(kv_offset))
    launches["flash_decode"] += 1
    return out
