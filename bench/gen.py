"""The traffic generator: click-log batches drawn on the device from a seed.

A frozen copy of the distributions of the port's click log
(``repro_torch/data/clicklog.py``, Hercules Fig. 2), written in torch so
that a pool of batches is drawn where it is served:

- ids are log-uniform Zipf over each table's rows, id 0 hottest:
  ``id = floor(V ** (u ** alpha)) - 1`` for ``u ~ U(0, 1)``, clipped to
  ``[0, V)`` (drawn in float64, so that the coldest rows stay reachable);
- a bag's count of ids is lognormal around ``share x nominal`` (nominal at
  least 2) with ``sigma``, truncated to an integer and clipped to ``[1,
  nominal]``; a nominal pooling of 1 gives one id; slots past the count
  hold -1;
- dense features are N(0, 1) in float32.

The traffic file holds the parameters; this module reads them and nothing
else.  The same seed, device and torch give the same batches.
"""
from __future__ import annotations

import numpy as np
import torch

# slots drawn at once: the float64 temporaries of a block stay near 1.5 GB
BLOCK_SLOTS = 1 << 26


def subseed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of draws (weights, traffic, ...) of a
    run's ``seed``, which may be any whole number."""
    ss = np.random.SeedSequence([seed & (2**64 - 1), *stream])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def draw_batch(sizes: dict, traffic: dict, rows: int, gen: torch.Generator,
               device: torch.device) -> dict[str, torch.Tensor]:
    """One batch of ``rows`` items: ``sparse_ids`` [rows, F, P] int32
    (-1 padded) and, where the model has dense features, ``dense`` [rows,
    n_dense] float32.  ``sizes`` is a configuration file's content."""
    vocab = torch.tensor(sizes["vocab_sizes"], dtype=torch.float64,
                         device=device)
    pooling = list(sizes["pooling"])
    F, P = len(pooling), max(pooling)
    nominal = torch.tensor(pooling, dtype=torch.float64, device=device)
    mu = torch.log(nominal.clamp_min(2.0) * traffic["pooling_share"])
    one_hot = nominal <= 1
    slot = torch.arange(P, device=device)
    batch = {}
    if sizes.get("n_dense"):
        batch["dense"] = torch.randn((rows, sizes["n_dense"]), generator=gen,
                                     device=device, dtype=torch.float32)
    ids = torch.empty((rows, F, P), dtype=torch.int32, device=device)
    block = max(1, BLOCK_SLOTS // (F * P))
    for r0 in range(0, rows, block):
        n = min(block, rows - r0)
        z = torch.randn((n, F), generator=gen, device=device,
                        dtype=torch.float64)
        counts = torch.exp(mu + traffic["pooling_sigma"] * z).floor()
        counts = torch.minimum(counts.clamp_min(1.0), nominal)
        counts = torch.where(one_hot, torch.ones_like(counts), counts)
        u = torch.rand((n, F, P), generator=gen, device=device,
                       dtype=torch.float64)
        x = torch.exp(u.pow_(traffic["zipf_alpha"]).mul_(
            torch.log(vocab)[None, :, None])).floor_().sub_(1.0)
        x = torch.minimum(x.clamp_min_(0.0), (vocab - 1.0)[None, :, None])
        live = slot[None, None, :] < counts[:, :, None]
        ids[r0:r0 + n] = torch.where(live, x.to(torch.int32),
                                     torch.full((), -1, dtype=torch.int32,
                                                device=device))
    batch["sparse_ids"] = ids
    return batch


def draw_pool(sizes: dict, traffic: dict, seed: int, device: torch.device
              ) -> list[dict[str, torch.Tensor]]:
    """The traffic's pool: ``traffic["pool"]`` distinct batches of
    ``traffic["batch"]`` items, batch i from its own stream of ``seed``."""
    return [draw_batch(sizes, traffic, traffic["batch"],
                       generator(subseed(seed, 2, i), device), device)
            for i in range(traffic["pool"])]
