from repro_torch.kernels.embedding_bag.ops import hot_embedding_bag
from repro_torch.kernels.embedding_bag.ref import hot_embedding_bag_ref

__all__ = ["hot_embedding_bag", "hot_embedding_bag_ref"]
