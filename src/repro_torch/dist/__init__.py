"""Distributed layer of the port, on ``torch.distributed``: the logical
axis binding (``logical``), the sharding rules and spec trees
(``sharding``), the layer's collectives (``collectives``), and the
explicit dataflows of the reference's GSPMD and ``shard_map`` code: the
row-sharded SparseNet (``sharded_embedding``), the sequence-sharded decode
(``decode``), the expert-parallel MoE (``moe``), the vocab-parallel loss
(``loss``) and the sharded GraphSAGE (``gnn``).  Without a bound mesh each
is the single-device function."""
