from repro_torch.kernels.embedding_bag.ops import (
    embedding_bag_features,
    embedding_bag_features_grad,
    hot_embedding_bag,
    hot_embedding_bag_grad,
)
from repro_torch.kernels.embedding_bag.ref import (
    embedding_bag_features_grad_ref,
    embedding_bag_features_ref,
    hot_embedding_bag_grad_ref,
    hot_embedding_bag_ref,
)

__all__ = ["embedding_bag_features", "embedding_bag_features_grad",
           "embedding_bag_features_grad_ref", "embedding_bag_features_ref",
           "hot_embedding_bag", "hot_embedding_bag_grad",
           "hot_embedding_bag_grad_ref", "hot_embedding_bag_ref"]
