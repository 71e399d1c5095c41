"""Plain reference of Wide & Deep (arXiv:1606.07792) with multi-task heads
(MT-WnD, Hercules Table I): the scores of a batch, and the work its inputs
need.

Wide: one scalar weight an id, summed over every feature's bag, plus the
dense features times a weight vector.  Deep: the F pooled D-vectors and the
dense features, concatenated, through an MLP with ReLU after every layer;
then one linear head a task.  A task's logit is its head's output plus the
wide sum.  Every product in float32 unless a lower precision is asked for
(``common.PRECISIONS``).  Imports torch and nothing of the program.
"""
from __future__ import annotations

import torch

from bench.reference import common


def _deep_dims(sizes: dict) -> list[int]:
    deep_in = len(sizes["vocab_sizes"]) * sizes["embed_dim"] + sizes["n_dense"]
    return [deep_in, *sizes["top_mlp"]]


def draw_params(sizes: dict, gen: torch.Generator, device: torch.device
                ) -> dict:
    """The parameter tree, in the layout the port's model takes (the
    port's init: zero ``wide_dense`` and zero biases)."""
    dtype = common.DTYPES[sizes["dtype"]]
    return {
        "embedding": {"table": common.draw_table(
            sizes, sizes["embed_dim"], gen, device)},
        "wide": {"table": common.draw_table(sizes, 1, gen, device)},
        "wide_dense": torch.zeros((sizes["n_dense"],), dtype=dtype,
                                  device=device),
        "deep_mlp": common.draw_mlp(_deep_dims(sizes), dtype, gen, device),
        "towers": [common.draw_mlp([sizes["top_mlp"][-1], 1], dtype, gen,
                                   device)
                   for _ in range(sizes["n_tasks"])],
    }


def scores(params: dict, batch: dict, sizes: dict, precision: str
           ) -> torch.Tensor:
    """Logits [n, n_tasks] float32 ([n] for one task) of n items."""
    ids, dense = batch["sparse_ids"], batch["dense"].float()
    deep = common.pool(params["embedding"]["table"], ids, sizes, precision)
    wide = common.pool(params["wide"]["table"], ids, sizes, precision)
    deep_in = torch.cat([deep.reshape(deep.shape[0], -1), dense], dim=-1)
    wide_logit = wide.sum(dim=(1, 2)) + common.matmul(
        dense, params["wide_dense"][:, None], precision)[:, 0]
    hidden = common.mlp(deep_in, params["deep_mlp"], precision,
                        final_relu=True)
    logits = torch.stack([common.mlp(hidden, t, precision,
                                     final_relu=False)[:, 0]
                          for t in params["towers"]], dim=-1)
    logits = logits + wide_logit[:, None]
    return logits[:, 0] if sizes["n_tasks"] == 1 else logits


def work(sizes: dict, stats: dict) -> dict:
    """What a batch needs (see ``dlrm.work``): two K1 launches, the deep
    table's and the dim-1 wide table's, over the same ids."""
    n = stats["items"]
    F = len(sizes["vocab_sizes"])
    P = max(sizes["pooling"])
    d = sizes["embed_dim"]
    tab = common.DTYPES[sizes["table_dtype"]].itemsize
    elem = common.DTYPES[sizes["dtype"]].itemsize
    ids = n * F * P * 4
    k1 = [{"bytes": ids + F * 8 + stats["distinct"] * dim * tab
           + n * F * dim * tab,
           "flops": {"float32": stats["live"] * dim}} for dim in (d, 1)]
    deep = _deep_dims(sizes)
    heads = [sizes["top_mlp"][-1], 1]
    mlp_flops = sum(2 * a * b for a, b in zip(deep[:-1], deep[1:])) \
        + sizes["n_tasks"] * 2 * heads[0] + 2 * sizes["n_dense"]
    weights = sum((a + 1) * b for a, b in zip(deep[:-1], deep[1:])) \
        + sizes["n_tasks"] * (heads[0] + 1) + sizes["n_dense"]
    step = {"bytes": ids + stats["distinct"] * (d + 1) * tab
            + n * sizes["n_dense"] * 4 + weights * elem
            + n * sizes["n_tasks"] * elem,
            "flops": common.flops_by_dtype(
                ("float32", stats["live"] * (d + 1)),
                (sizes["dtype"], n * mlp_flops))}
    return {"k1": k1, "step": step}
