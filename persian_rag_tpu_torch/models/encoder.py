"""Transformer text encoder as torch ``nn.Module``s.

The counterpart of ``persian_rag_tpu.models.encoder``: one configurable
post-LayerNorm encoder for the three architectures the system serves.

* BERT family — paraphrase-multilingual-MiniLM-L12-v2
  (12 layers, hidden 384, heads 12, token-type embeddings)
* DistilBERT — distiluse-base-multilingual-cased-v2
  (6 layers, hidden 768, no token types, + a 512-d tanh projection head)
* XLM-RoBERTa — intfloat/multilingual-e5-base
  (12 layers, hidden 768, position ids offset past padding_idx)

Module and parameter names follow the Flax modules (``models/convert.py``
maps one onto the other). Everything runs in float32; attention is a
plain einsum + softmax with the same additive -1e9 mask, so outputs agree
with the Flax encoder to f32 summation order. `EncoderConfig` has the
Flax config's fields but `compute_dtype`, so both packages read and write
the same ``config.json`` of a fine-tuned model. This module has no
hand-written kernel: the JAX encoder has no Pallas kernel either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2          # 0 disables token-type embeddings
    layer_norm_eps: float = 1e-12
    # RoBERTa-style position offset: positions start at pad_token_id+1 and
    # padding positions keep the pad position id. 0 disables (BERT style).
    position_offset: int = 0
    pad_token_id: int = 0
    hidden_act: str = "gelu"          # exact erf gelu (HF default)
    # recompute each layer in the backward pass (torch.utils.checkpoint,
    # the JAX package's nn.remat): activation memory for FLOPs. Only a
    # forward with grad enabled checkpoints; it is part of config.json.
    remat: bool = False

    @classmethod
    def minilm_l12(cls, **kw) -> "EncoderConfig":
        """paraphrase-multilingual-MiniLM-L12-v2 backbone (BERT, 384-d)."""
        return cls(
            vocab_size=250037, hidden_size=384, num_layers=12, num_heads=12,
            intermediate_size=1536, **kw,
        )

    @classmethod
    def distilbert_base(cls, **kw) -> "EncoderConfig":
        """distiluse-base-multilingual-cased-v2 backbone (DistilBERT)."""
        return cls(
            vocab_size=119547, hidden_size=768, num_layers=6, num_heads=12,
            intermediate_size=3072, type_vocab_size=0, **kw,
        )

    @classmethod
    def xlmr_base(cls, **kw) -> "EncoderConfig":
        """multilingual-e5-base backbone (XLM-RoBERTa base)."""
        return cls(
            vocab_size=250002, hidden_size=768, num_layers=12, num_heads=12,
            intermediate_size=3072, max_position_embeddings=514,
            type_vocab_size=1, layer_norm_eps=1e-5, position_offset=2,
            pad_token_id=1, **kw,
        )


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x, approximate="none")
    if name == "gelu_new":
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {name}")


class Embeddings(nn.Module):
    def __init__(self, config: EncoderConfig):
        super().__init__()
        c = config
        self.config = c
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(
            c.max_position_embeddings, c.hidden_size
        )
        self.token_type_embeddings = (
            nn.Embedding(c.type_vocab_size, c.hidden_size)
            if c.type_vocab_size else None
        )
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(
        self,
        input_ids: torch.Tensor,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        c = self.config
        b, s = input_ids.shape
        if c.position_offset:
            # RoBERTa: sequential ids past the offset for non-pad tokens,
            # pad positions pinned at pad_token_id.
            mask = (input_ids != c.pad_token_id).long()
            positions = torch.cumsum(mask, dim=1) * mask + c.pad_token_id
        else:
            positions = torch.arange(
                s, device=input_ids.device
            ).unsqueeze(0).expand(b, s)
        x = self.word_embeddings(input_ids) + self.position_embeddings(
            positions
        )
        if self.token_type_embeddings is not None:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + self.token_type_embeddings(token_type_ids)
        return self.layer_norm(x)


class SelfAttention(nn.Module):
    def __init__(self, config: EncoderConfig):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.output = nn.Linear(h, h)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape
        head_dim = h // self.num_heads

        def proj(layer):
            return layer(x).reshape(b, s, self.num_heads, head_dim)

        q, k, v = proj(self.query), proj(self.key), proj(self.value)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(head_dim)
        scores = scores + attn_bias  # (b, 1, 1, s) additive mask
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h)
        return self.output(ctx)


class EncoderLayer(nn.Module):
    def __init__(self, config: EncoderConfig):
        super().__init__()
        c = config
        self.hidden_act = c.hidden_act
        self.attention = SelfAttention(c)
        self.attention_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.intermediate = nn.Linear(c.hidden_size, c.intermediate_size)
        self.ffn_output = nn.Linear(c.intermediate_size, c.hidden_size)
        self.output_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        x = self.attention_norm(x + self.attention(x, attn_bias))
        inter = _act(self.hidden_act, self.intermediate(x))
        return self.output_norm(x + self.ffn_output(inter))


class TransformerEncoder(nn.Module):
    """Returns per-token hidden states (B, S, H)."""

    def __init__(self, config: EncoderConfig):
        super().__init__()
        self.config = config
        self.embeddings = Embeddings(config)
        self.layers = nn.ModuleList(
            EncoderLayer(config) for _ in range(config.num_layers)
        )

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        bias = torch.where(
            attention_mask[:, None, None, :] > 0, 0.0, -1e9
        ).to(torch.float32)
        remat = self.config.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, bias, use_reentrant=False)
            else:
                x = layer(x, bias)
        return x


def init_encoder_(
    module: nn.Module, generator: torch.Generator, std: float = 0.02
) -> nn.Module:
    """Seeded random weights, BERT style: N(0, std) for every Linear and
    Embedding weight, zero biases, unit LayerNorm scales. Draws on the
    CPU from `generator` in module order, so a seed gives the same
    weights whatever device the module later moves to."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                w.normal_(0.0, std, generator=generator)
                m.weight.copy_(w)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return module
