"""Dense building blocks: the MLP of the recsys DenseNet.

Counterpart of ``repro.models.layers`` (``init_mlp`` and ``apply_mlp``;
the LM blocks come with the LM slice).  Weights keep the reference's
``[in, out]`` layout and the forward computes ``x @ w + b``, so reference
parameters load without a transpose.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from repro_torch.common.init import he_init


def init_mlp(sizes: Sequence[int], *, generator: torch.Generator,
             device: torch.device, dtype: torch.dtype = torch.float32
             ) -> list[dict[str, torch.Tensor]]:
    """sizes = [in, h1, ..., out]; ReLU hidden, linear output."""
    return [
        {"w": he_init((sizes[i], sizes[i + 1]), generator=generator,
                      device=device, dtype=dtype),
         "b": torch.zeros((sizes[i + 1],), dtype=dtype, device=device)}
        for i in range(len(sizes) - 1)
    ]


def apply_mlp(params, x: torch.Tensor, *, final_activation: str | None = None
              ) -> torch.Tensor:
    """ReLU between layers; ``final_activation`` in {None,'relu','sigmoid'}."""
    n = len(params)
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < n - 1 or final_activation == "relu":
            x = torch.relu(x)
        elif final_activation == "sigmoid":
            x = torch.sigmoid(x)
    return x


class MLP(nn.Module):
    """The layers of ``init_mlp`` as a module (``w[i]`` is [in, out]).

    Parameters are frozen: the port serves, and its kernels have no
    backward yet."""

    def __init__(self, params):
        super().__init__()
        self.w = nn.ParameterList(
            [nn.Parameter(p["w"], requires_grad=False) for p in params])
        self.b = nn.ParameterList(
            [nn.Parameter(p["b"], requires_grad=False) for p in params])

    def layers(self) -> list[dict[str, torch.Tensor]]:
        return [{"w": w, "b": b} for w, b in zip(self.w, self.b)]

    def forward(self, x: torch.Tensor, final_activation: str | None = None
                ) -> torch.Tensor:
        return apply_mlp(self.layers(), x, final_activation=final_activation)
