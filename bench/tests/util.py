"""Small cells for the CPU tests: every width as the configuration file
states it, the tables cut to a few thousand rows and the batches small."""
from bench import harness
from bench.reference.common import DTYPES

SMALL_ROWS = 3000
SMALL_BATCH = 96


def small_cell(name: str, root=harness.ROOT, **traffic):
    cell = harness.load_cell(name, root)
    n = len(cell.sizes["vocab_sizes"])
    tr = {"batch": SMALL_BATCH, "pool": 2, **traffic}
    return harness.load_cell(name, root, sizes={"vocab_sizes":
                                                [SMALL_ROWS] * n},
                             traffic=tr)


def sizes_of(cfg, family: str) -> dict:
    """A configuration file's content for a port RecsysConfig."""
    emb = cfg.embedding
    dt = {v: k for k, v in DTYPES.items()}
    return {"name": cfg.name, "family": family,
            "vocab_sizes": list(emb.vocab_sizes), "pooling": list(emb.pooling),
            "embed_dim": emb.dim, "table_dtype": dt[emb.dtype],
            "row_pad": emb.row_pad, "n_dense": cfg.n_dense,
            "bottom_mlp": list(cfg.bottom_mlp), "top_mlp": list(cfg.top_mlp),
            "interaction": cfg.interaction, "n_tasks": cfg.n_tasks,
            "dtype": dt[cfg.dtype]}
