"""Plain reference of DLRM (arXiv:1906.00091): the scores of a batch, and
the work its inputs need.

Dense features -> bottom MLP (ReLU after every layer) -> a D-vector;
sparse features -> one sum-pooled D-vector a table; the pairwise dot
products of the n = F + 1 vectors, pairs (i < j) in row-major order; the
bottom vector and the dots -> top MLP (ReLU between layers, linear output)
-> one logit an item.  Every product in float32 unless a lower precision
is asked for (``common.PRECISIONS``).  Imports torch and nothing of the
program.
"""
from __future__ import annotations

import torch

from bench.reference import common


def draw_params(sizes: dict, gen: torch.Generator, device: torch.device
                ) -> dict:
    """The parameter tree, in the layout the port's model takes."""
    dtype = common.DTYPES[sizes["dtype"]]
    d = sizes["embed_dim"]
    n_vec = len(sizes["vocab_sizes"]) + 1
    top_in = n_vec * (n_vec - 1) // 2 + d
    return {
        "embedding": {"table": common.draw_table(sizes, d, gen, device)},
        "bottom_mlp": common.draw_mlp(
            [sizes["n_dense"], *sizes["bottom_mlp"]], dtype, gen, device),
        "top_mlp": common.draw_mlp(
            [top_in, *sizes["top_mlp"], 1], dtype, gen, device),
    }


def scores(params: dict, batch: dict, sizes: dict, precision: str
           ) -> torch.Tensor:
    """Logits [n] float32 of a batch of n items."""
    x = common.mlp(batch["dense"], params["bottom_mlp"], precision,
                   final_relu=True)
    pooled = common.pool(params["embedding"]["table"], batch["sparse_ids"],
                         sizes, precision)
    v = torch.cat([x[:, None, :], pooled], dim=1)          # [n, F + 1, D]
    z = common.matmul(v, v.transpose(1, 2), precision)
    i, j = torch.triu_indices(v.shape[1], v.shape[1], offset=1,
                              device=v.device)
    top_in = torch.cat([x, z[:, i, j]], dim=-1)
    return common.mlp(top_in, params["top_mlp"], precision,
                      final_relu=False)[:, 0]


def _mlp_flops(dims) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def _weight_bytes(dims, elem: int) -> int:
    return sum((a + 1) * b * elem for a, b in zip(dims[:-1], dims[1:]))


def work(sizes: dict, stats: dict) -> dict:
    """What a batch needs, from its sizes and ``stats`` (``items``,
    ``live`` ids, ``distinct`` rows touched): each input byte read once,
    each output byte written once, every multiply-add counted twice.

    ``k1``: one entry a K1 launch (the pooling of all bags): its bytes and
    float32 adds.  ``step``: the whole step's FLOPs by the dtype they run
    in, and its bytes."""
    n = stats["items"]
    F = len(sizes["vocab_sizes"])
    P = max(sizes["pooling"])
    d = sizes["embed_dim"]
    tab = common.DTYPES[sizes["table_dtype"]].itemsize
    elem = common.DTYPES[sizes["dtype"]].itemsize
    ids = n * F * P * 4
    rows = stats["distinct"] * d * tab
    k1 = {"bytes": ids + F * 8 + rows + n * F * d * tab,
          "flops": {"float32": stats["live"] * d}}
    bottom = [sizes["n_dense"], *sizes["bottom_mlp"]]
    n_vec = F + 1
    top = [n_vec * (n_vec - 1) // 2 + d, *sizes["top_mlp"], 1]
    dense = n * (_mlp_flops(bottom) + _mlp_flops(top)
                 + 2 * (n_vec * (n_vec - 1) // 2) * d)
    step = {"bytes": ids + rows + n * sizes["n_dense"] * 4
            + _weight_bytes(bottom, elem) + _weight_bytes(top, elem)
            + n * elem,
            "flops": common.flops_by_dtype(("float32", stats["live"] * d),
                                           (sizes["dtype"], dense))}
    return {"k1": [k1], "step": step}
