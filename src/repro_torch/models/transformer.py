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
which reads the cache itself instead of a dequantised copy of it.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.convert import tree_from_numpy
from repro_torch.common.init import normal_init
from repro_torch.common.types import TensorSpec
from repro_torch.dist.decode import decode_attention, decode_attention_int8
from repro_torch.dist.loss import cast_grad, ce_loss
from repro_torch.dist.moe import moe_apply
from repro_torch.models.layers import (
    AttentionConfig,
    MoEConfig,
    apply_rmsnorm,
    apply_rope,
    apply_swiglu,
    attention_output,
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


def _layer(tree, i: int):
    """Layer ``i`` of a stacked pytree, as views."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _block_apply(params_l, x, cos, sin, cfg: LMConfig, cache_l=None,
                 pos=None):
    """One transformer block. cache_l: {"k","v"(,"ks","vs")} [B, S, KVH, *]
    views, written in place at ``pos``, or None.

    Returns (x, cache_l, aux): aux is the MoE router's load-balance loss,
    None for a dense block."""
    B, T, _ = x.shape
    h = apply_rmsnorm(params_l["ln1"], x)
    q, k, v = qkv_projection(params_l["attn"], h, cfg.attn)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    # chunked attention serves Tq > 1 (train, prefill); decode is one block
    attn_fn = _attention_chunked if cfg.attn_impl == "chunked" and T > 1 \
        else _attention
    if cache_l is not None:
        S = cache_l["k"].shape[1]
        if not 0 <= pos <= S - T:
            raise ValueError(f"cache write [{pos}, {pos + T}) outside [0, {S})")
        # decode attends kv positions j <= pos, i.e. kv_len = pos + 1
        flash = cfg.decode_impl == "flash" and T == 1 and isinstance(pos, int)
        if cfg.kv_quant == "int8":
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            for name, t in (("k", kq), ("v", vq), ("ks", ks), ("vs", vs)):
                cache_l[name][:, pos:pos + T] = t
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
            cache_l["k"][:, pos:pos + T] = k
            cache_l["v"][:, pos:pos + T] = v
            kc, vc = cache_l["k"], cache_l["v"]
            attn = decode_attention(q, kc, vc, kv_len=pos + 1) if flash \
                else attn_fn(q, kc, vc, q_offset=pos, chunk=cfg.attn_chunk)
    else:
        attn = attn_fn(q, k, v, q_offset=0, chunk=cfg.attn_chunk)
    x = x + attention_output(params_l["attn"], attn)
    h2 = apply_rmsnorm(params_l["ln2"], x)
    if cfg.moe is None:
        return x + apply_swiglu(params_l["ffn"], h2), cache_l, None
    out, aux = moe_apply(params_l["ffn"], h2.reshape(B * T, cfg.d_model),
                         cfg.moe)
    return x + out.reshape(B, T, cfg.d_model), cache_l, aux


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


def _embed_tokens(params, tokens: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    # tied or not, the table is whole on one device: a local row gather
    return params["embed"][tokens]


def _lm_logits(params, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def _hidden(params, tokens: torch.Tensor, cfg: LMConfig, cache, pos):
    """Embedding and every block: tokens [B, T] -> (x [B, T, d], the sum
    of the blocks' aux losses, f32)."""
    B, T = tokens.shape
    x = _embed_tokens(params, tokens, cfg)
    pos0 = 0 if pos is None else pos
    positions = pos0 + torch.arange(T, device=tokens.device)
    cos, sin = rope_angles(positions[None, :], cfg.head_dim, cfg.rope_theta)
    half = cfg.head_dim // 2
    cos, sin = cos.expand(B, T, half), sin.expand(B, T, half)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(cfg.n_layers):
        params_l = _layer(params["blocks"], i)
        if remat:
            x, _, aux_l = checkpoint(_block_apply, params_l, x, cos, sin, cfg,
                                     use_reentrant=False)
        else:
            cache_l = None if cache is None else _layer(cache, i)
            x, _, aux_l = _block_apply(params_l, x, cos, sin, cfg,
                                       cache_l=cache_l, pos=pos0)
        if aux_l is not None:
            aux = aux + aux_l
    return x, aux


def forward(params, tokens: torch.Tensor, cfg: LMConfig, *, cache=None,
            pos: int | None = None):
    """tokens [B, T] -> (logits [B, T, V], cache, aux_loss): aux_loss is
    the f32 sum of the MoE blocks' load-balance losses (0 for a dense
    model).

    cache: stacked {"k","v"} [L, B, S, KVH, hd] (+ "ks","vs" for int8),
    written in place from position ``pos``, or None."""
    x, aux = _hidden(params, tokens, cfg, cache, pos)
    x = apply_rmsnorm(params["final_norm"], x)
    return _lm_logits(params, x, cfg), cache, aux


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
    x, _ = _hidden(params, tokens, cfg, cache, pos)
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
    return {name: (torch.ones if name in ("ks", "vs") else torch.zeros)(
                spec.shape, dtype=spec.dtype, device=device)
            for name, spec in kv_cache_specs(cfg, batch, seq, dtype).items()}


def prefill(params, tokens: torch.Tensor, cache, cfg: LMConfig):
    """Fill the cache from position 0; returns (last-token logits, cache)."""
    return _last_logits(params, tokens, cache, 0, cfg), cache


def decode_step(params, token: torch.Tensor, cache, pos: int, cfg: LMConfig):
    """One decode step. token [B, 1]; pos: write position (a Python int)."""
    return _last_logits(params, token, cache, pos, cfg), cache



def input_specs(cfg: LMConfig, batch: int, seq: int) -> dict[str, TensorSpec]:
    return {"tokens": TensorSpec((batch, seq), torch.int32)}
