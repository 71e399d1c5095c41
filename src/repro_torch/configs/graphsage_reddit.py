"""graphsage-reddit [gnn]: n_layers=2 d_hidden=128 aggregator=mean
sample_sizes=25-10 [arXiv:1706.02216; paper].

The four shape cells change the execution mode (and d_feat/n_classes):
full_graph_sm is cora-scale (d_feat 1433, 7 classes), minibatch_lg is
reddit (602 feats, 41 classes, fanout 15-10 per the shape), ogb_products
is full-batch at 2.45M nodes (100 feats, 47 classes), molecule is
graph-classification over packed small graphs.

Counterpart of ``repro.configs.graphsage_reddit``."""
from repro_torch.common.types import ArchKind
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn import GNNConfig

ARCH_ID = "graphsage-reddit"
KIND = ArchKind.GNN
SHAPES = GNN_SHAPES

FULL = GNNConfig(
    name=ARCH_ID,
    d_feat=602,
    d_hidden=128,
    n_layers=2,
    n_classes=41,
    aggregator="mean",
    fanout=(25, 10),
    mode="mini",
)

# per-shape variants (mode/d_feat/classes depend on the dataset cell)
SHAPE_CONFIGS = {
    "full_graph_sm": GNNConfig(
        name=ARCH_ID, d_feat=1433, d_hidden=128, n_layers=2, n_classes=7,
        aggregator="mean", mode="full"),
    "minibatch_lg": GNNConfig(
        name=ARCH_ID, d_feat=602, d_hidden=128, n_layers=2, n_classes=41,
        aggregator="mean", fanout=(15, 10), mode="mini"),
    "ogb_products": GNNConfig(
        name=ARCH_ID, d_feat=100, d_hidden=128, n_layers=2, n_classes=47,
        aggregator="mean", mode="full"),
    "molecule": GNNConfig(
        name=ARCH_ID, d_feat=64, d_hidden=128, n_layers=2, n_classes=2,
        aggregator="mean", mode="batched", readout="graph"),
}

SMOKE = GNNConfig(
    name=ARCH_ID + "-smoke", d_feat=16, d_hidden=32, n_layers=2, n_classes=5,
    aggregator="mean", fanout=(5, 3), mode="mini")
