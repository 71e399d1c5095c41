"""Plain PyTorch pieces shared by the recsys references: the weights drawn
from a seed at the port's init scales, the embedding-bag pooling, the
linear layers, and the precisions a reference is computed in.

Imports torch and nothing of the program.  A precision is one of:

- ``"float32"``: every product in float32, TF32 off (the reference);
- ``"tf32"``: the control of a float32 configuration: matrix products in
  TF32 (on a card cuBLAS's TF32 path; on the CPU the operands rounded to
  TF32's 10-bit mantissa, which is what the tensor cores take);
- ``"fp8"``: the control of a bfloat16 configuration: every operand of a
  product, the gathered rows and the pooled vectors rounded to
  float8_e4m3fn after scaling by their absolute maximum (one scale a
  tensor), then computed in float32.
"""
from __future__ import annotations

import contextlib
import math

import torch

PRECISIONS = ("float32", "tf32", "fp8")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# elements drawn at once into a table of another dtype than float32
DRAW_CHUNK = 1 << 27
_FP8_MAX = 448.0


def total_rows(sizes: dict) -> int:
    """Rows of the combined table: every feature's rows, padded to a
    multiple of ``row_pad``."""
    raw = sum(sizes["vocab_sizes"])
    pad = sizes["row_pad"]
    return -(-raw // pad) * pad


def row_offsets(sizes: dict) -> list[int]:
    """Start row of each feature in the combined table."""
    out, acc = [], 0
    for v in sizes["vocab_sizes"]:
        out.append(acc)
        acc += v
    return out


def _fill_uniform(dst: torch.Tensor, scale: float, gen: torch.Generator):
    """``dst`` drawn from U(-scale, scale): in place for float32, else a
    float32 chunk of DRAW_CHUNK elements at a time, cast."""
    if dst.dtype == torch.float32:
        dst.uniform_(-scale, scale, generator=gen)
        return
    flat = dst.view(-1)
    for lo in range(0, flat.numel(), DRAW_CHUNK):
        hi = min(lo + DRAW_CHUNK, flat.numel())
        flat[lo:hi].copy_(torch.empty(hi - lo, dtype=torch.float32,
                                      device=dst.device).uniform_(
            -scale, scale, generator=gen))


def draw_table(sizes: dict, dim: int, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """A combined [total_rows, dim] table in the configuration's table
    dtype: feature f's rows ~ U(-1/sqrt(V_f), 1/sqrt(V_f)), padding rows
    U(-1, 1) (the DLRM init the port uses)."""
    table = torch.empty((total_rows(sizes), dim),
                        dtype=DTYPES[sizes["table_dtype"]], device=device)
    off = row_offsets(sizes)
    for f, v in enumerate(sizes["vocab_sizes"]):
        _fill_uniform(table[off[f]:off[f] + v], 1.0 / math.sqrt(v), gen)
    end = off[-1] + sizes["vocab_sizes"][-1]
    if end < table.shape[0]:
        _fill_uniform(table[end:], 1.0, gen)
    return table


def draw_mlp(dims, dtype: torch.dtype, gen: torch.Generator,
             device: torch.device) -> list[dict[str, torch.Tensor]]:
    """Layers ``[{"w": [in, out], "b": [out]}]`` for sizes ``dims``: He
    normal weights (std sqrt(2 / in)), zero biases, in ``dtype``."""
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=gen, device=device,
                        dtype=torch.float32).mul_(math.sqrt(2.0 / a))
        layers.append({"w": w.to(dtype),
                       "b": torch.zeros((b,), dtype=dtype, device=device)})
    return layers


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest (ties to even) at TF32's 10-bit
    mantissa."""
    bits = x.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    return ((bits + 0xFFF + keep) & ~0x1FFF).view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.abs().max().clamp_min(1e-30)
    s = amax / _FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as float32, rounded as ``precision`` rounds its operands."""
    x = x.float()
    if precision == "fp8":
        return _round_fp8(x)
    if precision == "tf32" and x.device.type != "cuda":
        return _round_tf32(x)
    return x


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return rounded(a, precision) @ rounded(b, precision)


def linear(x: torch.Tensor, layer: dict, precision: str) -> torch.Tensor:
    return matmul(x, layer["w"], precision) + layer["b"].float()


def mlp(x: torch.Tensor, layers, precision: str, *, final_relu: bool
        ) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = linear(x, layer, precision)
        if i < len(layers) - 1 or final_relu:
            x = torch.relu(x)
    return x


def pool(table: torch.Tensor, ids: torch.Tensor, sizes: dict,
         precision: str) -> torch.Tensor:
    """Sum pooling of every bag: ids [n, F, P] (-1 padded) of feature f
    read rows ``row_offsets[f] + id`` -> [n, F, D] float32."""
    off = torch.tensor(row_offsets(sizes), dtype=torch.int64,
                       device=ids.device)[None, :, None]
    live = ids >= 0
    rows = table[torch.where(live, ids.long() + off, 0)]   # [n, F, P, D]
    rows = rounded(rows, precision)
    return (rows * live[..., None].float()).sum(dim=2)


@contextlib.contextmanager
def precision_context(precision: str):
    """TF32 on for the ``"tf32"`` precision, off otherwise, restored
    after."""
    cuda, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def gather_bytes(sizes: dict, dim: int) -> int:
    """Bytes of the gathered rows of one item in ``pool``'s float32 form
    (the reference's largest temporary, for sizing its row blocks)."""
    return len(sizes["pooling"]) * max(sizes["pooling"]) * dim * 4


def flops_by_dtype(*parts: tuple[str, int]) -> dict[str, int]:
    """FLOPs summed by the dtype they run in."""
    out: dict[str, int] = {}
    for dtype, n in parts:
        out[dtype] = out.get(dtype, 0) + n
    return out
