from repro_torch.kernels.embedding_bag.ops import embedding_bag_features, hot_embedding_bag
from repro_torch.kernels.embedding_bag.ref import (
    embedding_bag_features_ref,
    hot_embedding_bag_ref,
)

__all__ = ["embedding_bag_features", "embedding_bag_features_ref",
           "hot_embedding_bag", "hot_embedding_bag_ref"]
