"""Building blocks: the recsys MLP and the LM blocks (norms, rotary
embedding, GQA attention, SwiGLU, the mixture of experts).

Counterpart of ``repro.models.layers``, MoE included.  Weights
keep the reference's ``[in, out]`` layout and the forward computes
``x @ w + b``, so reference parameters load without a transpose.  Each
function keeps the reference's dtype discipline: norms and rotary angles
in float32, the products in the activations' dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.init import he_init, normal_init


def init_mlp(sizes: Sequence[int], *, generator: torch.Generator,
             device: torch.device, dtype: torch.dtype = torch.float32
             ) -> list[dict[str, torch.Tensor]]:
    """sizes = [in, h1, ..., out]; ReLU hidden, linear output."""
    return [
        {"w": he_init((sizes[i], sizes[i + 1]), generator=generator,
                      device=device, dtype=dtype),
         "b": torch.zeros((sizes[i + 1],), dtype=dtype, device=device)}
        for i in range(len(sizes) - 1)
    ]


def apply_mlp(params, x: torch.Tensor, *, final_activation: str | None = None
              ) -> torch.Tensor:
    """ReLU between layers; ``final_activation`` in {None,'relu','sigmoid'}."""
    n = len(params)
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < n - 1 or final_activation == "relu":
            x = torch.relu(x)
        elif final_activation == "sigmoid":
            x = torch.sigmoid(x)
    return x


class MLP(nn.Module):
    """The layers of ``init_mlp`` as a module (``w[i]`` is [in, out])."""

    def __init__(self, params):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(p["w"]) for p in params])
        self.b = nn.ParameterList([nn.Parameter(p["b"]) for p in params])

    def layers(self) -> list[dict[str, torch.Tensor]]:
        return [{"w": w, "b": b} for w, b in zip(self.w, self.b)]

    def forward(self, x: torch.Tensor, final_activation: str | None = None
                ) -> torch.Tensor:
        return apply_mlp(self.layers(), x, final_activation=final_activation)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(dim: int, *, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def apply_rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


def init_layernorm(dim: int, *, device: torch.device,
                   dtype: torch.dtype = torch.float32) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def apply_layernorm(params, x: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    # the reference adds scale and bias without a cast: f32 if they are
    return (out * params["scale"] + params["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float = 10000.0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [*, T] -> (cos, sin) each [*, T, head_dim/2] in f32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.float()[..., None] * freqs               # [*, T, half]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [..., T, n_heads, head_dim]; cos/sin: [..., T, head_dim/2], cast
    to x's dtype before the products, as the reference does."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False  # qwen2 uses bias on QKV
    rope_theta: float = 10000.0


def init_attention(cfg: AttentionConfig, *, generator: torch.Generator,
                   device: torch.device, dtype: torch.dtype = torch.float32
                   ) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {
        "wq": normal_init((d, h * hd), **kw),
        "wk": normal_init((d, kvh * hd), **kw),
        "wv": normal_init((d, kvh * hd), **kw),
        "wo": normal_init((h * hd, d), **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kvh * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kvh * hd,), dtype=dtype, device=device)
    return p


def qkv_projection(params, x: torch.Tensor, cfg: AttentionConfig):
    """x [B, T, d] -> q [B, T, H, hd], k/v [B, T, KVH, hd]."""
    B, T, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return (q.reshape(B, T, cfg.n_heads, cfg.head_dim),
            k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim))


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, kv_valid_len: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Plain dot-product GQA attention (the reference's ``gqa_attention``).

    q: [B, Tq, H, hd]; k/v: [B, Tk, KVH, hd]. H must be a multiple of KVH.
    kv_valid_len: optional [B] — mask KV positions >= this (decode cache).
    """
    B, Tq, H, hd = q.shape
    Tk, KVH = k.shape[1], k.shape[2]
    group = H // KVH
    qg = q.reshape(B, Tq, KVH, group, hd)
    # the reference rounds 1/sqrt(hd) to q's dtype before the product
    scale = torch.tensor(1.0 / math.sqrt(hd), device=q.device).to(q.dtype)
    logits = torch.einsum("btkgh,bskh->bkgts", qg, k) * scale
    neg = torch.tensor(-1e30, device=q.device).to(logits.dtype)
    if causal and Tq > 1:
        # offset alignment: query i attends kv j <= i + (Tk - Tq)
        ar_k = torch.arange(Tk, device=q.device)
        ar_q = torch.arange(Tq, device=q.device)
        mask = ar_k[None, :] <= (ar_q[:, None] + (Tk - Tq))
        logits = torch.where(mask[None, None, None], logits, neg)
    if kv_valid_len is not None:
        mask = (torch.arange(Tk, device=q.device)[None, :]
                < kv_valid_len.to(q.device)[:, None])           # [B, Tk]
        logits = torch.where(mask[:, None, None, None], logits, neg)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v)
    return out.reshape(B, Tq, H, hd)


def attention_output(params, attn_out: torch.Tensor) -> torch.Tensor:
    B, T = attn_out.shape[:2]
    return attn_out.reshape(B, T, -1) @ params["wo"]


# ---------------------------------------------------------------------------
# SwiGLU FFN + MoE
# ---------------------------------------------------------------------------


def init_swiglu(d_model: int, d_ff: int, *, generator: torch.Generator,
                device: torch.device, dtype: torch.dtype = torch.float32
                ) -> dict:
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "w_gate": normal_init((d_model, d_ff), **kw),
        "w_up": normal_init((d_model, d_ff), **kw),
        "w_down": normal_init((d_ff, d_model), **kw),
    }


def apply_swiglu(params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert FFN width
    n_experts: int
    top_k: int
    n_shared: int = 0         # shared (always-on) experts, qwen2-moe style
    shared_d_ff: int = 0      # width of the fused shared expert (0 = d_ff * n_shared)
    router_dtype: torch.dtype = torch.float32
    capacity_factor: float = 1.25
    # expert arrays are stored zero-padded to a multiple of this (the
    # reference's even split over an expert-parallel axis); the router only
    # ever routes to the first n_experts.
    pad_to: int = 16

    @property
    def n_experts_padded(self) -> int:
        return -(-self.n_experts // self.pad_to) * self.pad_to

    @property
    def shared_width(self) -> int:
        return self.shared_d_ff or self.d_ff * self.n_shared


def init_moe(cfg: MoEConfig, *, generator: torch.Generator,
             device: torch.device, dtype: torch.dtype = torch.float32,
             stack: tuple[int, ...] = ()) -> dict:
    """The reference's ``init_moe`` leaves, each with the leading dims
    ``stack`` (a transformer's ``(n_layers,)``): a float32 router
    [d, n_experts] (normal, std 0.006), experts stacked [E_pad, ...] with
    the rows from ``n_experts`` on zero, and the fused shared expert."""
    E, d, f = cfg.n_experts_padded, cfg.d_model, cfg.d_ff
    kw = dict(generator=generator, device=device, dtype=dtype)

    def experts(shape):
        w = normal_init((*stack, E, *shape), **kw)
        w[..., cfg.n_experts:, :, :] = 0    # never routed to
        return w

    params = {
        "router": normal_init((*stack, d, cfg.n_experts), stddev=0.006,
                              generator=generator, device=device,
                              dtype=torch.float32),
        "experts": {"w_gate": experts((d, f)), "w_up": experts((d, f)),
                    "w_down": experts((f, d))},
    }
    if cfg.n_shared:
        sf = cfg.shared_width
        params["shared"] = {"w_gate": normal_init((*stack, d, sf), **kw),
                            "w_up": normal_init((*stack, d, sf), **kw),
                            "w_down": normal_init((*stack, sf, d), **kw)}
    return params


def moe_router(params, x: torch.Tensor, cfg: MoEConfig):
    """x [N, d] -> (topk_idx [N, k], topk_weight [N, k] in x's dtype, the
    Switch load-balance aux loss): router in ``router_dtype``, the top-k
    probabilities renormalised."""
    logits = x.to(cfg.router_dtype) @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = torch.topk(probs, cfg.top_k, dim=-1)
    topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    E = cfg.n_experts
    me = probs.mean(dim=0)                                   # mean router prob
    flat = topk_idx.reshape(-1)
    ce = torch.zeros((E,), dtype=probs.dtype, device=x.device).index_add_(
        0, flat, torch.full(flat.shape, 1.0 / flat.numel(), dtype=probs.dtype,
                            device=x.device))              # token fraction
    aux = E * (me * ce).sum()
    return topk_idx, topk_w.to(x.dtype), aux


def apply_moe_dense(params, x: torch.Tensor, cfg: MoEConfig):
    """Dense-dispatch MoE: every expert runs on every token, mixed by the
    routing weights (O(E·N·d·f); the oracle of the grouped dispatch in
    ``repro_torch.dist.moe``).  x: [N, d] -> ([N, d], aux_loss)."""
    topk_idx, topk_w, aux = moe_router(params, x, cfg)
    E = cfg.n_experts
    # combine[n, e] = weight of expert e for token n (0 if not routed)
    combine = torch.zeros((x.shape[0], E), dtype=x.dtype,
                          device=x.device).scatter_add(1, topk_idx, topk_w)
    ex = {k: v[:E] for k, v in params["experts"].items()}
    h = F.silu(torch.einsum("nd,edf->enf", x, ex["w_gate"])) * torch.einsum(
        "nd,edf->enf", x, ex["w_up"])
    y_e = torch.einsum("enf,efd->end", h, ex["w_down"])      # [E, N, d]
    y = torch.einsum("end,ne->nd", y_e, combine)
    if cfg.n_shared:
        y = y + apply_swiglu(params["shared"], x)
    return y, aux
