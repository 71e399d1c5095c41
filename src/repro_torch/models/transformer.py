"""Decoder-only LM family, dense (llama3 / qwen2 / deepseek) and MoE
(qwen2-moe, olmoe): forward, the training loss, KV cache, prefill and
one-token decode.

Counterpart of ``repro.models.transformer``.  Parameters keep the
reference's pytree: ``{"embed": [V, d], "blocks": {...}, "final_norm":
{...}}`` with every block leaf stacked on a leading layer axis ``[L, ...]``
and weights ``[in, out]``, so ``params_from_reference`` carries reference
weights across unchanged.  The reference's ``lax.scan`` over layers is a
Python loop over views ``t[i]``; with ``remat`` (as the reference's
``jax.checkpoint``) each block of a training forward runs under
``torch.utils.checkpoint``, so only its input is kept for the backward.
Unrolling and sharding annotations have no counterpart on one device.

Three deliberate differences, all for memory on the card:

- the KV cache is written in place (the reference returns a new cache from
  ``dynamic_update_slice``); the functions still return the cache so the
  call sites read the same.  A write past the cache's end raises, where
  ``dynamic_update_slice`` would clamp the start;
- ``prefill`` and ``decode_step`` apply the final norm and the head to the
  last position only, since they return only ``logits[:, -1]``: at
  prefill_32k that saves the [B, 32768, 128256] logits of ``forward``;
- ``_attention_chunked`` runs its elementwise steps in place where grad is
  off (prefill), and out of place, with the same arithmetic, under
  autograd.

Decode attention with ``decode_impl="flash"`` goes through
``repro_torch.dist.decode.decode_attention``, i.e. kernel K3 on the card;
with the int8 cache through ``decode_attention_int8``, K3's int8 entry,
which reads the cache itself instead of a dequantised copy of it.  Under a
"kv_seq" binding (``repro_torch.dist.logical``) the cache a step gets is
this rank's sequence slice: only the rank whose slice holds ``pos`` writes
the new token's K/V (at local row ``pos - kv_offset``), and the attention
is the sequence-sharded decode.

Tensor parallelism follows ``repro_torch.dist.sharding.param_spec_tree``'s
placements where "heads" (and "kv_heads", "ffn", "vocab", all on the same
mesh axes) is bound, as a train or prefill cell on a mesh binds it: a
rank holds wq/wk/wv (and bq/bk/bv) columns of whole heads and kv_heads
and wo's matching rows (``head_split``: GQA groups whole where the
kv_heads split over the ranks; where the ranks outnumber the kv_heads,
each kv head replicated on the ranks that share it and its q heads,
padded with zero heads to a multiple of them, split over them),
w_gate/w_up's column and w_down's row block of the FFN, and its
vocabulary rows of ``embed`` (its columns of ``lm_head``).
Each column-parallel input passes through ``collectives.enter`` (the
gradient summed over the group), each row-parallel product through one
``all_reduce`` of its float32 partial, rounded to the activations' dtype
once after the sum as one device rounds the whole product once (a bf16
partial would be rounded on each rank and again after the sum), the
token embedding through ``sharded_row_gather``, and
the logits are this rank's vocabulary slice, which the vocab-parallel
``ce_loss`` takes.  Under ``remat`` the checkpointed block runs its
collectives again in the backward.  A decode cell on a mesh binds those
names and "kv_seq" together, as the reference's does: its weights are
this rank's blocks, but its cache slice holds every kv head along its
rows, so the block gathers the token's q heads and new k/v rows over the
heads' ranks in one ``all_gather`` (``dist.decode.gather_heads``), the
rank whose slice holds ``pos`` writes the whole new row, the attention
runs over all heads, and each rank keeps its own heads of the output
for its ``wo`` rows.

``seq_shard`` (Megatron-style sequence parallelism): a cell of such a
config binds "residual_seq" to "model", and where a step's T splits over
the "model" ranks (``sequence_split``) the residual stream between and
inside the blocks is this rank's sequence block [B, T / W, d]: the
token embedding's sum is reduce-scattered into it, the norms run on it,
each column-parallel input is gathered along T (``collectives.gather``,
in ``enter``'s place), each row-parallel product's float32 partials are
reduce-scattered (``collectives.reduce_scatter``, in the
``all_reduce``'s place) and then rounded, the MoE layer gathers and
reduce-scatters likewise, and the final norm's output is gathered for
the head.  So the checkpointed block keeps a 1/W block of its input.
The norms (and a MoE router) then see only this rank's tokens, and their
gradients are summed over "model" by the cell (``collectives.
reduce_grads``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.convert import tree_from_numpy
from repro_torch.common.init import normal_init
from repro_torch.common.types import TensorSpec
from repro_torch.dist import collectives, logical
from repro_torch.dist.decode import (
    decode_attention,
    decode_attention_int8,
    gather_heads,
    kv_shard,
    own_heads,
)
from repro_torch.dist.loss import cast_grad, ce_loss
from repro_torch.dist.moe import moe_apply
from repro_torch.dist.sharding import HeadSplit
from repro_torch.models.layers import (
    AttentionConfig,
    MoEConfig,
    apply_rmsnorm,
    apply_rope,
    init_moe,
    init_rmsnorm,
    qkv_projection,
    rope_angles,
)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    # recompute each block in the backward of a training forward
    remat: bool = True
    # attention schedule for Tq > 1: "naive" materializes [Tq, Tk] scores;
    # "chunked" is the online-softmax loop over KV chunks
    attn_impl: str = "naive"
    attn_chunk: int = 1024
    # shard the residual stream between blocks by sequence over the "model"
    # axis (Megatron-style sequence parallelism): each tensor-parallel
    # all-reduce becomes a reduce-scatter and an all-gather, and the
    # activations a block keeps are 1/TP of the sequence
    seq_shard: bool = False
    # KV-cache quantization: "none" | "int8" (per token and head, symmetric)
    kv_quant: str = "none"
    # one-token decode attention: "naive" or "flash" (kernel K3)
    decode_impl: str = "naive"
    dtype: torch.dtype = torch.bfloat16

    @property
    def attn(self) -> AttentionConfig:
        return AttentionConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta)

    def param_count(self) -> int:
        """Total parameters, from the shapes ``init`` makes (MoE experts
        counted at their padded number, as the reference counts them)."""
        d, hd = self.d_model, self.head_dim
        q_dim, kv_dim = self.n_heads * hd, self.n_kv_heads * hd
        block = (2 * d                                   # ln1, ln2
                 + d * q_dim + 2 * d * kv_dim + q_dim * d)  # wq, wk, wv, wo
        if self.qkv_bias:
            block += q_dim + 2 * kv_dim
        m = self.moe
        if m is None:
            block += 3 * d * self.d_ff                   # swiglu
        else:
            block += d * m.n_experts + 3 * m.n_experts_padded * d * m.d_ff
            if m.n_shared:
                block += 3 * d * m.shared_width
        total = self.vocab * d + self.n_layers * block + d
        if not self.tie_embeddings:
            total += d * self.vocab
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: the routed top-k and the shared
        expert only), by the reference's formula."""
        total = self.param_count()
        if self.moe is None:
            return total
        m = self.moe
        inactive = (m.n_experts - m.top_k) * 3 * self.d_model * m.d_ff \
            * self.n_layers
        return total - inactive


def init(cfg: LMConfig, *, generator: torch.Generator,
         device: torch.device) -> dict:
    """Random parameters on ``device`` with the reference's scales (normal
    0.02 weights, unit norms), drawn from ``generator``; block leaves are
    stacked [L, ...]."""
    L = cfg.n_layers
    kw = dict(generator=generator, device=device, dtype=cfg.dtype)

    # one draw per stacked leaf ([L, in, out] at once), the shapes of
    # layers.init_attention and layers.init_swiglu
    d, hd = cfg.d_model, cfg.head_dim
    q_dim, kv_dim = cfg.n_heads * hd, cfg.n_kv_heads * hd
    blocks = {
        "ln1": {"scale": torch.ones((L, d), dtype=cfg.dtype, device=device)},
        "ln2": {"scale": torch.ones((L, d), dtype=cfg.dtype, device=device)},
        "attn": {
            "wq": normal_init((L, d, q_dim), **kw),
            "wk": normal_init((L, d, kv_dim), **kw),
            "wv": normal_init((L, d, kv_dim), **kw),
            "wo": normal_init((L, q_dim, d), **kw),
        },
    }
    if cfg.moe is None:
        blocks["ffn"] = {"w_gate": normal_init((L, d, cfg.d_ff), **kw),
                         "w_up": normal_init((L, d, cfg.d_ff), **kw),
                         "w_down": normal_init((L, cfg.d_ff, d), **kw)}
    else:
        blocks["ffn"] = init_moe(cfg.moe, stack=(L,), **kw)
    if cfg.qkv_bias:
        for name, n in (("bq", q_dim), ("bk", kv_dim), ("bv", kv_dim)):
            blocks["attn"][name] = torch.zeros((L, n), dtype=cfg.dtype,
                                               device=device)
    params = {
        "embed": normal_init((cfg.vocab, d), **kw),
        "blocks": blocks,
        "final_norm": init_rmsnorm(d, device=device, dtype=cfg.dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init((d, cfg.vocab), **kw)
    return params


def params_from_reference(tree, *, device: torch.device) -> dict:
    """The reference ``transformer.init`` pytree (leaves as numpy arrays,
    ml_dtypes bf16 included) as the port's parameters on ``device``."""
    return tree_from_numpy(tree, device)


def _layers(tree, n: int) -> list:
    """The ``n`` layers of a stacked pytree, as views from one
    ``torch.unbind`` a leaf: the backward stacks the layers' gradients
    into each leaf once, where a view ``t[i]`` a layer would add a
    zero-filled leaf-sized gradient a layer (bytes quadratic in depth)."""
    if isinstance(tree, dict):
        per_key = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def head_split(cfg: LMConfig, ranks: int) -> HeadSplit:
    """How ``cfg``'s heads lie on ``ranks`` tensor-parallel ranks
    (``repro_torch.dist.sharding.HeadSplit``); raises, naming the config,
    where no whole-head split exists."""
    return HeadSplit.of(cfg.name, cfg.n_heads, cfg.n_kv_heads, ranks)


def _tensor_parallel(cfg: LMConfig):
    """(group, head split, this rank's index over the heads' axes) of the
    mesh axes "heads" is bound to, or (None, None, 0) without tensor
    parallelism.  Raises when "kv_heads", "ffn" or "vocab" is bound
    elsewhere, when the heads have no whole-head split over the ranks
    (``head_split``), or when the FFN width (a dense model's, or a MoE
    model's shared expert) or the vocabulary does not split over them.
    "kv_seq" may share the heads' axes (a decode cell binds both to
    "model"): the heads' group is then also part of the cache's seq
    group, and ``_block_apply`` gathers the token's heads over it."""
    axes = logical.bound_axes("heads")
    if not axes:
        return None, None, 0
    for name in ("kv_heads", "ffn", "vocab"):
        if logical.bound_axes(name) != axes:
            raise ValueError(f'"{name}" is bound to '
                             f"{logical.bound_axes(name)}, not to the heads' "
                             f"{axes}")
    mesh = logical.current_mesh()
    w = logical.shards(axes, mesh)
    split = head_split(cfg, w)
    ffn = cfg.d_ff if cfg.moe is None else cfg.moe.shared_width
    for name, n in (("ffn", ffn), ("vocab", cfg.vocab)):
        if n % w:
            raise ValueError(f"{cfg.name}: {n} {name} do not split over the "
                             f"{w} ranks of {axes}")
    return logical.group(axes), split, logical.shard_index(mesh, axes)


def sequence_split(T: int) -> bool:
    """Whether a step over T tokens runs sequence-parallel: "residual_seq"
    is bound (a ``seq_shard`` cell on a mesh), to the heads' axes, and T
    splits over its more than one rank.  Otherwise (decode's one token, a
    length that is not a multiple) the residual stream stays whole on
    every rank, the all-reduce form: the same values, as the reference's
    constraint changes only the layout."""
    axes = logical.bound_axes("residual_seq")
    if not axes:
        return False
    if axes != logical.bound_axes("heads"):
        raise ValueError(f'"residual_seq" is bound to {axes}, not to the '
                         f"heads' {logical.bound_axes('heads')}")
    w = logical.shards(axes, logical.current_mesh())
    return w > 1 and T % w == 0


def _enter(x, group, seq: bool = False):
    """x as the input of this rank's column-parallel work: x itself on one
    device, entered (``collectives.enter``) where it is replicated, its
    sequence blocks gathered (``collectives.gather``) where it is this
    rank's block ([B, T / W, ...])."""
    if group is None:
        return x
    if seq:
        return collectives.gather(x, group, 1)
    return collectives.enter(x, group)


def _tp_sum(x, group, seq: bool = False):
    """The sum of the ranks' partials x [B, T, ...]: whole on every rank,
    or this rank's sequence block of it under ``seq``."""
    if group is None:
        return x
    if seq:
        return collectives.reduce_scatter(x, group, 1)
    return collectives.all_reduce(x.contiguous(), group)


def _residual(x, T: int, seq: bool):
    """The reference's constraint of the residual stream to ("batch",
    "residual_seq", "embed"), as a check: ``x`` is this rank's batch block
    and, under ``seq``, its sequence block of a [B, T, d] stream."""
    mesh = logical.current_mesh()
    if mesh is None:
        return x
    B = x.shape[0] * logical.shards(logical.bound_axes("batch"), mesh)
    return logical.constrain(x, ("batch", "residual_seq" if seq else None,
                                 "embed"), shape=(B, T, x.shape[2]))


class _Float32Product(torch.autograd.Function):
    """x [..., k] @ w [k, n] of a 16-bit dtype, accumulated and returned in
    float32 (no rounding to the inputs' dtype).  The backward takes the
    cotangent in the inputs' dtype, as the rounded product's would be, so
    its matmuls are one device's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.device.type != "cpu":  # the card's (and the dry run's) path
            out = torch.mm(x2, w, out_dtype=torch.float32)
        else:
            out = x2.float() @ w.float()
        return out.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        dx = g @ w.transpose(0, 1) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = x.reshape(-1, x.shape[-1]).transpose(0, 1) @ g.reshape(
                -1, g.shape[-1])
        return dx, dw


def _row_parallel(x, w, group, seq: bool = False):
    """x [B, T, k] @ w with the contraction split over ``group`` (x and w
    this rank's blocks): the float32 partials summed by one ``all_reduce``
    (under ``seq`` a ``reduce_scatter`` into this rank's sequence block)
    and rounded to x's dtype once."""
    if group is None:
        return x @ w
    if x.dtype == torch.float32:
        return _tp_sum(x @ w, group, seq)
    return _tp_sum(_Float32Product.apply(x, w), group, seq).to(x.dtype)


def _block_apply(params_l, x, cos, sin, cfg: LMConfig, cache_l=None,
                 pos=None, seq: bool = False):
    """One transformer block. cache_l: {"k","v"(,"ks","vs")} [B, S, KVH, *]
    views, written in place at ``pos``, or None.  Under a "heads" binding
    the block runs this rank's heads and FFN columns (module docstring);
    the cache then holds this rank's kv_heads, or, under "kv_seq" too,
    every kv head of this rank's sequence slice.  ``seq``: x (and the
    block's output) is this rank's sequence block [B, T / W, d]
    (``sequence_split``).

    Returns (x, cache_l, aux): aux is the MoE router's load-balance loss,
    None for a dense block."""
    B, T, _ = x.shape
    tp, split, tp_i = _tensor_parallel(cfg)
    if seq:
        T *= logical.shards(logical.bound_axes("residual_seq"),
                            logical.current_mesh())
    attn_cfg = cfg.attn
    if tp is not None:
        attn_cfg = dataclasses.replace(attn_cfg, n_heads=split.q_local,
                                       n_kv_heads=split.kv_local)
        want = attn_cfg.n_heads * cfg.head_dim
        if params_l["attn"]["wq"].shape[-1] != want:
            raise ValueError(f"wq holds {params_l['attn']['wq'].shape[-1]} "
                             f"columns; this rank's heads need {want}")
    h = apply_rmsnorm(params_l["ln1"], x)
    q, k, v = qkv_projection(params_l["attn"], _enter(h, tp, seq), attn_cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    # chunked attention serves Tq > 1 (train, prefill); decode is one block
    attn_fn = _attention_chunked if cfg.attn_impl == "chunked" and T > 1 \
        else _attention
    if cache_l is not None:
        # under a "kv_seq" binding the cache is this rank's sequence slice:
        # global rows [off, off + s_local) of an S-row cache
        s_local = cache_l["k"].shape[1]
        off, S = kv_shard(s_local)
        if not 0 <= pos <= S - T:
            raise ValueError(f"cache write [{pos}, {pos + T}) outside [0, {S})")
        # decode attends kv positions j <= pos, i.e. kv_len = pos + 1
        flash = cfg.decode_impl == "flash" and T == 1 and isinstance(pos, int)
        if S != s_local and not flash:
            raise ValueError("a sequence-sharded cache is read only by the "
                             "flash decode (decode_impl='flash', one token "
                             "at an int pos)")
        gathered = tp is not None and bool(logical.bound_axes("kv_seq"))
        if gathered:
            # the slice holds every kv head: the whole token, gathered
            if not flash:
                raise ValueError("a tensor-parallel decode over a "
                                 "sequence-sharded cache needs the flash "
                                 "decode")
            if cache_l["k"].shape[2] != cfg.n_kv_heads:
                raise ValueError(f"the cache slice holds "
                                 f"{cache_l['k'].shape[2]} kv heads; a "
                                 f"sequence-sharded one holds all "
                                 f"{cfg.n_kv_heads}")
            q, k, v = gather_heads(q, k, v, split, tp_i, tp)

        def write(name, t):
            """Rows [pos, pos + T) of the cache, where this slice holds
            them (every rank of an unsharded cache)."""
            if S == s_local:
                cache_l[name][:, pos:pos + T] = t
                return
            lo, hi = max(pos, off), min(pos + T, off + s_local)
            if lo < hi:
                cache_l[name][:, lo - off:hi - off] = t[:, lo - pos:hi - pos]

        if cfg.kv_quant == "int8":
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            for name, t in (("k", kq), ("v", vq), ("ks", ks), ("vs", vs)):
                write(name, t)
            if flash:
                # K3's int8 entry reads the cache itself: the same function
                # as the dequantisation below followed by decode_attention,
                # without the dequantised copy of the whole cache
                attn = decode_attention_int8(
                    q, cache_l["k"], cache_l["ks"], cache_l["v"],
                    cache_l["vs"], kv_len=pos + 1)
            else:
                kc = cache_l["k"].to(x.dtype) * cache_l["ks"].to(x.dtype)
                vc = cache_l["v"].to(x.dtype) * cache_l["vs"].to(x.dtype)
                attn = attn_fn(q, kc, vc, q_offset=pos, chunk=cfg.attn_chunk)
        else:
            write("k", k)
            write("v", v)
            kc, vc = cache_l["k"], cache_l["v"]
            attn = decode_attention(q, kc, vc, kv_len=pos + 1) if flash \
                else attn_fn(q, kc, vc, q_offset=pos, chunk=cfg.attn_chunk)
        if gathered:
            attn = own_heads(attn, split, tp_i)
    else:
        attn = attn_fn(q, k, v, q_offset=0, chunk=cfg.attn_chunk)
    x = _residual(x + _row_parallel(attn.reshape(B, T, -1),
                                    params_l["attn"]["wo"], tp, seq), T, seq)
    h2 = apply_rmsnorm(params_l["ln2"], x)
    if cfg.moe is None:
        p, h2 = params_l["ffn"], _enter(h2, tp, seq)
        hidden = F.silu(h2 @ p["w_gate"]) * (h2 @ p["w_up"])
        out, aux = _row_parallel(hidden, p["w_down"], tp, seq), None
    else:
        out, aux = moe_apply(params_l["ffn"], h2.reshape(-1, cfg.d_model),
                             cfg.moe, seq_batch=B if seq else None)
    return _residual(x + out.reshape(x.shape), T, seq), cache_l, aux


def _attention(q, k, v, *, q_offset, chunk=None):
    """Causal GQA attention with a query-position offset (for KV caches).

    q: [B, Tq, H, hd]; k/v: [B, Tk, KVH, hd]. Query i's global position is
    q_offset + i; it attends to kv positions j <= q_offset + i.
    """
    B, Tq, H, hd = q.shape
    Tk, KVH = k.shape[1], k.shape[2]
    qg = q.reshape(B, Tq, KVH, H // KVH, hd)
    logits = torch.einsum("btkgh,bskh->bkgts", qg, k) * (1.0 / math.sqrt(hd))
    jpos = torch.arange(Tk, device=q.device)[None, :]
    ipos = torch.arange(Tq, device=q.device)[:, None] + q_offset
    neg = torch.tensor(NEG_INF, device=q.device).to(logits.dtype)
    logits = torch.where((jpos <= ipos)[None, None, None], logits, neg)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v)
    return out.reshape(B, Tq, H, hd)


def _attention_chunked(q, k, v, *, q_offset, chunk=1024):
    """Online-softmax attention as a loop over KV chunks (the reference's
    ``lax.scan``): never materializes the [Tq, Tk] scores, only
    [B, KVH, g, Tq, chunk] per step.  Scores and the running max and sum
    are f32; the accumulator stays in q's dtype, as in the reference.
    Where grad is off, the elementwise steps run in place on the step's
    score tensor; under autograd (whose saved scores they would overwrite)
    out of place, with the same arithmetic."""
    B, Tq, H, hd = q.shape
    Tk, KVH = k.shape[1], k.shape[2]
    chunk = min(chunk, Tk)
    if Tk % chunk:
        raise ValueError(f"Tk {Tk} % chunk {chunk} != 0")
    group = H // KVH
    qg = q.reshape(B, Tq, KVH, group, hd)
    scale = 1.0 / math.sqrt(hd)
    qpos = (q_offset + torch.arange(Tq, device=q.device))[:, None]  # [Tq, 1]
    in_place = not torch.is_grad_enabled()

    m = torch.full((B, KVH, group, Tq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KVH, group, Tq, hd), dtype=q.dtype, device=q.device)
    for i in range(Tk // chunk):
        k_i = k[:, i * chunk:(i + 1) * chunk]
        v_i = v[:, i * chunk:(i + 1) * chunk]
        s = torch.einsum("btkgh,bskh->bkgts", qg, k_i).float()
        kpos = i * chunk + torch.arange(chunk, device=q.device)[None, :]
        masked = ~(kpos <= qpos)
        s = s.mul_(scale).masked_fill_(masked, NEG_INF) if in_place \
            else (s * scale).masked_fill(masked, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = s.sub_(m_new[..., None]).exp_() if in_place \
            else (s - m_new[..., None]).exp()
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgts,bskh->bkgth", p.to(q.dtype), v_i)
        acc = acc * alpha[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None].to(acc.dtype)
    # [B, KVH, g, Tq, hd] -> [B, Tq, H, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, hd)


def _vocab_group(cfg: LMConfig):
    """The group "vocab" is bound to (the "model" axis of a mesh cell), or
    None on one device."""
    axes = logical.bound_axes("vocab")
    if not axes:
        return None
    if axes != logical.as_axes(logical.model_axis_name()):
        raise ValueError(f'"vocab" is bound to {axes}, not to the "model" '
                         f"axis the row-sharded gather uses")
    if cfg.vocab % logical.shards(axes, logical.current_mesh()):
        raise ValueError(f"{cfg.name}: a vocabulary of {cfg.vocab} does not "
                         f"split over {axes}")
    return logical.group(axes)


def _embed_tokens(params, tokens: torch.Tensor, cfg: LMConfig,
                  seq: bool = False) -> torch.Tensor:
    # tied or not, the table is vocab-row-sharded under a "vocab" binding
    # (the reference's masked local gather and psum, for its tied table);
    # under ``seq`` the sum is reduce-scattered into this rank's sequence
    # block
    if _vocab_group(cfg) is not None:
        from repro_torch.dist.sharded_embedding import sharded_row_gather

        return sharded_row_gather(params["embed"], tokens,
                                  scatter_dim=1 if seq else None)
    return params["embed"][tokens]


def _lm_logits(params, x: torch.Tensor, cfg: LMConfig,
               seq: bool = False) -> torch.Tensor:
    """x [..., d] -> logits [..., V], or this rank's vocabulary slice of
    them under a "vocab" binding (the head column-sharded); under ``seq``
    x [B, T / W, d] is this rank's sequence block, gathered along T for
    the head."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return _enter(x, _vocab_group(cfg), seq) @ head


def _hidden(params, tokens: torch.Tensor, cfg: LMConfig, cache, pos,
            seq: bool = False):
    """Embedding and every block: tokens [B, T] -> (x [B, T, d], the sum
    of the blocks' aux losses, f32); under ``seq`` x is this rank's
    sequence block [B, T / W, d]."""
    B, T = tokens.shape
    x = _residual(_embed_tokens(params, tokens, cfg, seq), T, seq)
    pos0 = 0 if pos is None else pos
    positions = pos0 + torch.arange(T, device=tokens.device)
    cos, sin = rope_angles(positions[None, :], cfg.head_dim, cfg.rope_theta)
    half = cfg.head_dim // 2
    cos, sin = cos.expand(B, T, half), sin.expand(B, T, half)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    binding = logical.current_binding()

    def block(params_l, x, cos, sin, cfg):
        # the recompute runs in the backward, on the autograd engine's
        # thread for a CUDA graph: under the binding of the forward
        with logical.rebind(binding):
            return _block_apply(params_l, x, cos, sin, cfg, seq=seq)

    caches = None if cache is None else _layers(cache, cfg.n_layers)
    for i, params_l in enumerate(_layers(params["blocks"], cfg.n_layers)):
        if remat:
            x, _, aux_l = checkpoint(block, params_l, x, cos, sin, cfg,
                                     use_reentrant=False)
        else:
            cache_l = None if caches is None else caches[i]
            x, _, aux_l = _block_apply(params_l, x, cos, sin, cfg,
                                       cache_l=cache_l, pos=pos0, seq=seq)
        if aux_l is not None:
            aux = aux + aux_l
    return x, aux


def forward(params, tokens: torch.Tensor, cfg: LMConfig, *, cache=None,
            pos: int | None = None):
    """tokens [B, T] -> (logits [B, T, V], cache, aux_loss): aux_loss is
    the f32 sum of the MoE blocks' load-balance losses (0 for a dense
    model).

    cache: stacked {"k","v"} [L, B, S, KVH, hd] (+ "ks","vs" for int8),
    written in place from position ``pos``, or None.  Sequence-parallel
    (``sequence_split``), the final norm runs on this rank's block, which
    is then gathered along the sequence for the head, so that the logits
    (this rank's vocabulary slice) cover every position."""
    seq = sequence_split(tokens.shape[1])
    x, aux = _hidden(params, tokens, cfg, cache, pos, seq)
    x = apply_rmsnorm(params["final_norm"], x)
    return _lm_logits(params, x, cfg, seq), cache, aux


def lm_loss(params, batch, cfg: LMConfig) -> torch.Tensor:
    """Next-token cross entropy. batch: {"tokens": [B, T]} (shifted here).

    Loss over positions 0..T-2 predicting 1..T-1, mean per token, in f32
    with the gradient back in the logits' dtype; the MoE aux loss added
    with weight 0.01."""
    tokens = batch["tokens"]
    logits, _, aux = forward(params, tokens, cfg)
    ce = ce_loss(cast_grad(logits[:, :-1]), tokens[:, 1:])
    return ce + 0.01 * aux


def _last_logits(params, tokens, cache, pos, cfg):
    seq = sequence_split(tokens.shape[1])
    x, _ = _hidden(params, tokens, cfg, cache, pos, seq)
    if seq:
        # the last position is the last row of the last rank's block: each
        # rank's last row gathered for the head, not the whole sequence
        x = apply_rmsnorm(params["final_norm"], x[:, -1:])
        return _lm_logits(params, x, cfg, seq)[:, -1]
    x = apply_rmsnorm(params["final_norm"], x[:, -1])
    return _lm_logits(params, x, cfg)


def _quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8: x [B, T, KVH, hd] -> (int8 values,
    f32 scales [B, T, KVH, 1])."""
    x32 = x.float()
    s = (x32.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.round(x32 / s).clamp(-127, 127).to(torch.int8)
    return q, s


def kv_cache_specs(cfg: LMConfig, batch: int, seq: int, dtype=None
                   ) -> dict[str, TensorSpec]:
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_quant == "int8":
        sshape = (*shape[:-1], 1)
        return {"k": TensorSpec(shape, torch.int8),
                "v": TensorSpec(shape, torch.int8),
                "ks": TensorSpec(sshape, torch.float32),
                "vs": TensorSpec(sshape, torch.float32)}
    return {"k": TensorSpec(shape, dtype), "v": TensorSpec(shape, dtype)}


def init_kv_cache(cfg: LMConfig, batch: int, seq: int, dtype=None, *,
                  device: torch.device) -> dict[str, torch.Tensor]:
    """Zero values (and unit scales for int8) on ``device``."""
    return cache_from_specs(kv_cache_specs(cfg, batch, seq, dtype), device)


def cache_from_specs(specs: dict[str, TensorSpec], device: torch.device
                     ) -> dict[str, torch.Tensor]:
    """A cache of ``kv_cache_specs``' leaves (or a rank's block of them):
    zero values, unit int8 scales."""
    return {name: (torch.ones if name in ("ks", "vs") else torch.zeros)(
                spec.shape, dtype=spec.dtype, device=device)
            for name, spec in specs.items()}


def prefill(params, tokens: torch.Tensor, cache, cfg: LMConfig):
    """Fill the cache from position 0; returns (last-token logits, cache)."""
    return _last_logits(params, tokens, cache, 0, cfg), cache


def decode_step(params, token: torch.Tensor, cache, pos: int, cfg: LMConfig):
    """One decode step. token [B, 1]; pos: write position (a Python int)."""
    return _last_logits(params, token, cache, pos, cfg), cache



def input_specs(cfg: LMConfig, batch: int, seq: int) -> dict[str, TensorSpec]:
    return {"tokens": TensorSpec((batch, seq), torch.int32)}
