"""Decode attention over a local or a sequence-sharded KV cache.

Counterpart of ``repro.dist.decode``.  The long-context decode cells
(``decode_32k``, ``long_500k``) keep the KV cache sequence-sharded: each
rank holds rows [i * S_local, (i + 1) * S_local) of the S-long cache, i
its block along the "kv_seq" axes (``repro_torch.dist.sharding.
kv_seq_axes``), with every kv head.  Each rank runs K3's partials on its
own slice, passing its global base ``kv_offset`` so that a ``kv_len``
ending inside a shard masks right and a shard wholly past it contributes
the empty partial (m = -1e30, l = 0, o = 0); one ``all_gather`` of the
partials over the seq group (a [B, KVH, G, hd + 2] float32 block a rank,
whatever S is) and the same ``lse_combine`` the kernel merges its splits
with give every rank the attention.  The merge is permutation-invariant,
so the gather's order never matters.

A decode cell on a mesh is also tensor-parallel over "model", as the
reference's is: a rank holds its block of every weight, so it projects
only its q heads and kv heads (``dist.sharding.HeadSplit``), while its
cache slice holds every kv head.  ``gather_heads`` makes the whole
token: one ``all_gather`` over the heads' group of this rank's q heads
and new k/v rows, packed, put back in global head order (a padded q
slot dropped, a replicated kv head taken once).  The attention then
runs K3's partials for all H heads on the slice, as the reference's
``flash_decode_sharded`` does with its q gathered by GSPMD, and
``own_heads`` gives back this rank's heads of the merged output, zero in
a padded slot, for the row-parallel ``wo``.

``decode_attention`` and ``decode_attention_int8`` are the model-facing
entries: with a mesh bound and a non-empty "kv_seq" rule they take the
sharded path, else K3 on the whole local cache.  ``kv_shard`` gives the
model the slice's global base, for the cache write.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.dist import collectives, logical
from repro_torch.kernels.flash_attention.ops import (
    flash_decode,
    flash_decode_int8,
    flash_decode_int8_partials,
    flash_decode_partials,
)
from repro_torch.kernels.flash_attention.ref import lse_combine


def seq_shard_index(mesh, seq_axes) -> int:
    """This rank's block along a dimension sharded over ``seq_axes``: the
    rows [i * S_local, (i + 1) * S_local) of i = idx(major) * size(minor)
    + idx(minor), the order of a ``PartitionSpec`` over several axes."""
    return logical.shard_index(mesh, seq_axes)


def kv_shard(s_local: int) -> tuple[int, int]:
    """(global position of local cache row 0, global cache length) for a
    local cache of ``s_local`` rows under the active binding: (0,
    s_local) without a "kv_seq" rule."""
    mesh, seq_axes = logical.current_mesh(), logical.bound_axes("kv_seq")
    if mesh is None or not seq_axes:
        return 0, s_local
    return (seq_shard_index(mesh, seq_axes) * s_local,
            logical.shards(seq_axes, mesh) * s_local)


def _merge(q: torch.Tensor, m, l, o, mesh, seq_axes) -> torch.Tensor:
    """All-gather the partials over the seq group and merge them."""
    B, _, H, hd = q.shape
    packed = torch.cat([m, l, o], dim=-1)             # [B, KVH, G, hd + 2]
    everyone = collectives.all_gather(packed, mesh.group(seq_axes))
    m_all, l_all, o_all = everyone.split([1, 1, hd], dim=-1)
    _, l_c, o_c = lse_combine(m_all, l_all, o_all, axis=0)
    out = (o_c / l_c.clamp_min(1e-30)).to(q.dtype)
    return out.reshape(B, 1, H, hd)


def whole_heads(slots: torch.Tensor, split, kv: bool = False
                ) -> torch.Tensor:
    """Every rank's head slots [B, T, ranks * n_local, hd], in rank order,
    as the global heads [B, T, n, hd] of ``split`` (a ``HeadSplit``): the
    q slots (``q_local`` a rank) less their padding, or the kv slots
    (``kv``, ``kv_local`` a rank) with a replicated head taken from the
    first rank that holds it.  Contiguous, as K3 takes its q."""
    B, T, _, hd = slots.shape
    groups = slots.reshape(B, T, split.n_kv_heads, -1, hd)
    heads = groups[:, :, :, 0] if kv else groups[:, :, :, :split.group]
    return heads.reshape(B, T, -1, hd).contiguous()


def own_heads(out: torch.Tensor, split, i: int) -> torch.Tensor:
    """Rank i's q slots [B, T, q_local, hd] (``split.q_heads(i)``) of an
    output of all the heads [B, T, H, hd], zero in a padded slot."""
    B, T, _, hd = out.shape
    groups = out.reshape(B, T, split.n_kv_heads, split.group, hd)
    pad = split.group_slots - split.group
    if pad:
        groups = F.pad(groups, (0, 0, 0, pad))
    slots = groups.reshape(B, T, -1, hd)
    return slots[:, :, i * split.q_local:(i + 1) * split.q_local]


def gather_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, split,
                 i: int, group) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The whole token from every rank's heads: q [B, T, q_local, hd] and
    the new k/v rows [B, T, kv_local, hd] of this rank (block i of
    ``split`` over the heads' ``group``), packed into one ``all_gather``
    over the group, come back as q [B, T, H, hd] and k/v [B, T, KVH, hd]
    in global head order."""
    if dist.get_group_rank(group, dist.get_rank()) != i:
        raise ValueError(f"rank {dist.get_rank()} is rank "
                         f"{dist.get_group_rank(group, dist.get_rank())} of "
                         f"the heads' group, not its head block {i}")
    B, T, _, hd = q.shape
    everyone = collectives.all_gather(torch.cat([q, k, v], dim=2), group)
    # [W, B, T, slots, hd] -> [B, T, W, slots, hd], the ranks in order
    q, k, v = everyone.permute(1, 2, 0, 3, 4).split(
        [split.q_local, split.kv_local, split.kv_local], dim=3)
    return (whole_heads(q.reshape(B, T, -1, hd), split),
            whole_heads(k.reshape(B, T, -1, hd), split, kv=True),
            whole_heads(v.reshape(B, T, -1, hd), split, kv=True))


def flash_decode_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, kv_len: int, mesh, seq_axes, bk: int = 512
                         ) -> torch.Tensor:
    """Decode with this rank's sequence slice k/v [B, S_local, KVH, hd] of a
    cache sharded over ``seq_axes`` (q [B, 1, H, hd] replicated over them;
    B is this rank's batch block when the batch is sharded too).  ``kv_len``
    is the GLOBAL live length.  Returns [B, 1, H, hd] in q's dtype, the
    same on every rank of the seq group.  With no ``seq_axes`` it is
    ``flash_decode`` on the local cache."""
    seq_axes = logical.as_axes(seq_axes)
    if not seq_axes:
        return flash_decode(q, k, v, kv_len=kv_len, bk=bk)
    offset = seq_shard_index(mesh, seq_axes) * k.shape[1]
    m, l, o = flash_decode_partials(q, k, v, kv_len=kv_len, kv_offset=offset,
                                    bk=bk)
    return _merge(q, m, l, o, mesh, seq_axes)


def flash_decode_sharded_int8(q: torch.Tensor, kq: torch.Tensor,
                              ks: torch.Tensor, vq: torch.Tensor,
                              vs: torch.Tensor, *, kv_len: int, mesh,
                              seq_axes, bk: int = 512
                              ) -> torch.Tensor:
    """``flash_decode_sharded`` over this rank's slice of the int8 cache
    kq/vq [B, S_local, KVH, hd] with f32 scales ks/vs [B, S_local, KVH, 1],
    through K3's int8 partials."""
    seq_axes = logical.as_axes(seq_axes)
    if not seq_axes:
        return flash_decode_int8(q, kq, ks, vq, vs, kv_len=kv_len, bk=bk)
    offset = seq_shard_index(mesh, seq_axes) * kq.shape[1]
    m, l, o = flash_decode_int8_partials(q, kq, ks, vq, vs, kv_len=kv_len,
                                         kv_offset=offset, bk=bk)
    return _merge(q, m, l, o, mesh, seq_axes)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: int, bk: int = 512) -> torch.Tensor:
    """q [B, 1, H, hd] against the cache k/v [B, S, KVH, hd] (this rank's
    sequence slice when "kv_seq" is bound); rows at or past the global
    ``kv_len`` are masked.  Returns [B, 1, H, hd]."""
    mesh, seq_axes = logical.current_mesh(), logical.bound_axes("kv_seq")
    if mesh is None or not seq_axes:
        return flash_decode(q, k, v, kv_len=kv_len, bk=bk)
    return flash_decode_sharded(q, k, v, kv_len=kv_len, mesh=mesh,
                                seq_axes=seq_axes, bk=bk)


def decode_attention_int8(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                          vq: torch.Tensor, vs: torch.Tensor, *, kv_len: int,
                          bk: int = 512) -> torch.Tensor:
    """``decode_attention`` over the int8 cache kq/vq [B, S, KVH, hd] with
    f32 scales ks/vs [B, S, KVH, 1], dequantised in q's dtype as the
    model's eager path does.  Returns [B, 1, H, hd]."""
    mesh, seq_axes = logical.current_mesh(), logical.bound_axes("kv_seq")
    if mesh is None or not seq_axes:
        return flash_decode_int8(q, kq, ks, vq, vs, kv_len=kv_len, bk=bk)
    return flash_decode_sharded_int8(q, kq, ks, vq, vs, kv_len=kv_len,
                                     mesh=mesh, seq_axes=seq_axes, bk=bk)
