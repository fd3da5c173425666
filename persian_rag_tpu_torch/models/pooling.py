"""Sentence-embedding pooling heads (sentence-transformers semantics).

The counterpart of ``persian_rag_tpu.models.pooling``:

* MiniLM-L12 paraphrase: masked mean pooling, no projection, no normalize.
* distiluse-v2: masked mean pooling -> Dense(768->512, tanh), no normalize.
* multilingual-e5-base: masked mean pooling, L2 normalize.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the sequence dim: (B, S, H) -> (B, H)."""
    mask = attention_mask[:, :, None].to(hidden.dtype)
    summed = torch.sum(hidden * mask, dim=1)
    counts = torch.clamp(torch.sum(mask, dim=1), min=1e-9)
    return summed / counts


def cls_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    del attention_mask
    return hidden[:, 0, :]


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=eps)


class PoolingHead(nn.Module):
    """pool -> optional dense(tanh) projection -> optional normalize."""

    def __init__(
        self,
        hidden_size: int,
        pooling: str = "mean",
        projection_dim: Optional[int] = None,
        projection_activation: str = "tanh",
        normalize: bool = False,
    ):
        super().__init__()
        if pooling not in ("mean", "cls"):
            raise ValueError(f"unknown pooling {pooling}")
        self.pooling = pooling
        self.projection_activation = projection_activation
        self.normalize = normalize
        self.projection = (
            nn.Linear(hidden_size, projection_dim) if projection_dim else None
        )

    def forward(
        self, hidden: torch.Tensor, attention_mask: torch.Tensor
    ) -> torch.Tensor:
        if self.pooling == "mean":
            x = mean_pool(hidden, attention_mask)
        else:
            x = cls_pool(hidden, attention_mask)
        if self.projection is not None:
            x = self.projection(x)
            if self.projection_activation == "tanh":
                x = torch.tanh(x)
        if self.normalize:
            x = l2_normalize(x)
        return x
