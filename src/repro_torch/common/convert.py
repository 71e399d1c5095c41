"""numpy -> torch conversion of reference parameters (pytrees of arrays)."""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    """``a`` (anything ``np.asarray`` takes, ml_dtypes bfloat16 included)
    as a tensor of the same dtype on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch.from_numpy rejects it
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def tree_from_numpy(tree, device: torch.device):
    """A pytree of dicts, lists and tuples with array leaves -> the same
    pytree with tensor leaves on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device) for v in tree]
    return tensor_from_numpy(tree, device)
