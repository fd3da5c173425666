"""Llama-family decoder (the generation model) in PyTorch.

The counterpart of ``persian_rag_tpu.models.decoder``: RMSNorm, rotary
embeddings (HF half-split), SwiGLU MLP and grouped-query attention, with

* a full-sequence forward (prefill, embeddings),
* an incremental step over a fixed-length KV cache written at a scalar
  slot or at per-row slots,
* float, fused (q/k/v and gate/up concatenated), int8-quantized and
  int4-quantized weights (layer projections two nibbles a byte; the
  embedding and an untied lm_head stay int8), and an optional int8 KV
  cache.

Parameters keep the JAX package's names and layouts: a Dense ``kernel`` is
(in, out), quantized pairs are ``values`` int8 / ``scale`` f32, the tree is
``embed_tokens``, ``layer_{i}`` / ``attention`` / ``mlp`` / norms,
``final_norm`` (and ``lm_head`` when untied); an int4 Dense keeps the
name ``values`` for its packed (K/2, N) bytes. The tree functions here
(`fuse_params`, `cast_params`, `quantize_decoder_params`,
`random_quantized_params`, `params_from_llama`) work on nested dicts of
tensors in that layout; ``models.convert.decoder_params_from_flax`` turns a
tree into the module's ``state_dict`` (``layer_{i}`` -> ``layers.{i}``).

The arithmetic keeps the JAX order so that bf16 streams agree: RMSNorm
multiplies by an f32 rsqrt, casts back, then applies the scale; RoPE works
in f32 and casts; attention scores are an f32 product divided by
sqrt(head_dim) plus an additive -1e9 bias, softmax in f32, and the
probabilities are cast to the compute type before the value product.
Both attention products stay ``torch.einsum`` (the JAX package computes
them outside any kernel too); every quantized Dense goes through
``ops.quant_matmul``.

The KV cache is updated in place (the JAX package returns a new pytree).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from persian_rag_tpu_torch.core.device import resolve_device
from persian_rag_tpu_torch.models.convert import as_tensor
from persian_rag_tpu_torch.ops import quant_matmul

@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 128_256
    hidden_size: int = 2048
    num_layers: int = 16
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 8192
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500_000.0
    tie_word_embeddings: bool = True
    compute_dtype: Any = torch.float32
    # serving-time transform: q/k/v concatenated into ONE projection and
    # gate/up into another (7 -> 4 weight matmuls per layer); use
    # fuse_params() to convert an unfused tree.
    fused_projections: bool = False
    # serving-time quantized weights: every Dense kernel and the tied
    # embedding are {values int8, scale f32} (quantize_decoder_params),
    # consumed by the weight-streaming kernels of ops/quant_matmul.py.
    # quantized_bits=4 packs the layer projections two int4 values a byte
    # (K/2, N); the embedding and an untied lm_head stay int8.
    quantized_weights: bool = False
    quantized_bits: int = 8
    # KV-cache storage: "compute" (compute_dtype) or "int8" (symmetric
    # per-(token, kv-head) scales; the dequant folds into the attention
    # products).
    kv_cache_dtype: str = "compute"

    @classmethod
    def llama32_1b(cls, **kw) -> "DecoderConfig":
        return cls(**kw)  # the defaults above are Llama-3.2-1B

    @classmethod
    def llama32_3b(cls, **kw) -> "DecoderConfig":
        fields = dict(
            hidden_size=3072, num_layers=28, num_heads=24,
            num_kv_heads=8, intermediate_size=8192,
        )
        fields.update(kw)
        return cls(**fields)

    @classmethod
    def llama31_8b(cls, **kw) -> "DecoderConfig":
        fields = dict(
            hidden_size=4096, num_layers=32, num_heads=32,
            num_kv_heads=8, intermediate_size=14336,
            tie_word_embeddings=False,
        )
        fields.update(kw)
        return cls(**fields)

    @classmethod
    def from_hf(cls, cfg: Dict[str, Any], **kw) -> "DecoderConfig":
        """Map an HF LlamaForCausalLM config.json dict to a DecoderConfig."""
        fields = dict(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg.get(
                "num_key_value_heads", cfg["num_attention_heads"]
            ),
            intermediate_size=cfg["intermediate_size"],
            max_position_embeddings=cfg.get("max_position_embeddings", 4096),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            rope_theta=cfg.get("rope_theta", 500_000.0),
            tie_word_embeddings=cfg.get("tie_word_embeddings", True),
        )
        fields.update(kw)
        return cls(**fields)

    @classmethod
    def tiny(cls, **kw) -> "DecoderConfig":
        defaults = dict(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128,
            max_position_embeddings=128, rope_theta=10_000.0,
        )
        defaults.update(kw)
        return cls(**defaults)


def _rope_tables(positions: torch.Tensor, d: int, theta: float):
    """(cos, sin), each (B, S, 1, D/2) f32, of the rotary angles at
    `positions` (B, S). The same for every layer and for q and k, so a
    forward computes them once."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                               device=positions.device) / d)
    )
    angles = positions[..., None].float() * inv_freq  # (B, S, D/2)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotary embedding, HF 'half-split' convention, in f32 and cast back.
    x: (B, S, H, D)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
    ).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    return _apply_rope(x, *_rope_tables(positions, x.shape[-1], theta))


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))

    def forward(self, x):
        var = x.float().pow(2).mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.scale


def _quantize_kv(x: torch.Tensor):
    """Symmetric int8 over the head dim: x (B, S, H, D) -> (values int8,
    scale f32 (B, S, H)). An all-zero vector maps to values 0 / scale 0."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    inv = torch.where(amax > 0, 127.0 / amax, torch.zeros_like(amax))
    values = torch.round(xf * inv[..., None]).to(torch.int8)
    return values, amax / 127.0


class Dense(nn.Module):
    """Bias-free Dense with the kernel stored (in, out)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))

    def forward(self, x):
        return x @ self.kernel


class QuantDense(nn.Module):
    """Dense over quantized weights (serving only): buffers values (K, N)
    int8, or with bits=4 the packed (K/2, N) int4 pairs, and scale (1, N)
    f32, never trained. The product runs in ops.quant_matmul (f32 result),
    cast back to x's type."""

    def __init__(self, in_features: int, features: int, bits: int = 8):
        super().__init__()
        if bits not in (4, 8):
            raise ValueError(f"quantized weights are int8 or int4, not {bits}")
        self.bits = bits
        rows = in_features // 2 if bits == 4 else in_features
        self.register_buffer(
            "values", torch.zeros((rows, features), dtype=torch.int8))
        self.register_buffer(
            "scale", torch.ones((1, features), dtype=torch.float32))

    def forward(self, x):
        matmul = (quant_matmul.w4a16_matmul if self.bits == 4
                  else quant_matmul.w8a16_matmul)
        return matmul(x, self.values, self.scale).to(x.dtype)


class Embed(nn.Module):
    def __init__(self, vocab_size: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab_size, features))

    def forward(self, ids):
        return self.embedding[ids]

    def attend(self, x):
        """x (..., H) -> f32 logits (..., V). Both operands are widened to
        f32 (bf16 logits would tie), which copies the table per call: the
        float path is not the served one."""
        return x.float() @ self.embedding.float().T


class QuantEmbed(nn.Module):
    """Tied embedding over one int8 table: a row gather times the row's
    scale for the token embedding, the (N, K) kernel for the lm_head."""

    def __init__(self, vocab_size: int, features: int):
        super().__init__()
        self.register_buffer(
            "values", torch.zeros((vocab_size, features), dtype=torch.int8))
        self.register_buffer(
            "scale", torch.ones((vocab_size, 1), dtype=torch.float32))

    def forward(self, ids):
        return self.values[ids].float() * self.scale[ids]

    def attend(self, x):
        return quant_matmul.w8a16_matmul_nt(x, self.values, self.scale)


def _dense(c: DecoderConfig, in_features: int, features: int,
           bits: Optional[int] = None) -> nn.Module:
    """A layer projection (`bits` None: the config's width) or, with
    bits=8, the untied lm_head, which stays int8 in 4-bit mode: the logits'
    argmax is the quality-critical product."""
    if c.quantized_weights:
        return QuantDense(in_features, features,
                          c.quantized_bits if bits is None else bits)
    return Dense(in_features, features)


class DecoderAttention(nn.Module):
    def __init__(self, config: DecoderConfig):
        super().__init__()
        c = self.config = config
        h = c.hidden_size
        self.head_dim = h // c.num_heads
        q_out = c.num_heads * self.head_dim
        kv_out = c.num_kv_heads * self.head_dim
        if c.fused_projections:
            self.qkv_proj = _dense(c, h, q_out + 2 * kv_out)
        else:
            self.q_proj = _dense(c, h, q_out)
            self.k_proj = _dense(c, h, kv_out)
            self.v_proj = _dense(c, h, kv_out)
        self.o_proj = _dense(c, q_out, h)

    def forward(self, x, rope, attn_bias, cache=None):
        c = self.config
        b, s, h = x.shape
        head_dim = self.head_dim
        if c.fused_projections:
            q, k, v = torch.split(
                self.qkv_proj(x),
                [c.num_heads * head_dim, c.num_kv_heads * head_dim,
                 c.num_kv_heads * head_dim],
                dim=-1,
            )
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q = q.reshape(b, s, c.num_heads, head_dim)
        k = k.reshape(b, s, c.num_kv_heads, head_dim)
        v = v.reshape(b, s, c.num_kv_heads, head_dim)
        q = _apply_rope(q, *rope)
        k = _apply_rope(k, *rope)

        k_scale = v_scale = None
        if cache is not None:
            k_cache, v_cache, cache_pos, k_scale, v_scale = cache
            quant_kv = k_scale is not None
            if quant_kv:
                k_new, ks_new = _quantize_kv(k)
                v_new, vs_new = _quantize_kv(v)
            else:
                k_new, v_new = k.to(k_cache.dtype), v.to(v_cache.dtype)
            if not isinstance(cache_pos, torch.Tensor) or cache_pos.dim() == 0:
                # one shared slot: the block lands at cache_pos, moved back
                # where it would pass the end (dynamic_update_slice)
                start = max(0, min(int(cache_pos), k_cache.shape[1] - s))
                k_cache[:, start:start + s] = k_new
                v_cache[:, start:start + s] = v_new
                if quant_kv:
                    k_scale[:, start:start + s] = ks_new
                    v_scale[:, start:start + s] = vs_new
            else:
                # (B,) per-row block starts; slots outside [0, L) are
                # dropped. Without a host sync: a dropped entry rewrites
                # the value already at slot mod L, which no kept entry of
                # its row writes while the block is at most L wide.
                length = k_cache.shape[1]
                if s > length:
                    raise ValueError(f"a block of {s} tokens exceeds the "
                                     f"cache length {length}")
                slots = cache_pos[:, None] + torch.arange(s, device=x.device)
                rows = torch.arange(b, device=x.device)[:, None].expand_as(slots)
                keep = (slots >= 0) & (slots < length)
                at = (rows, slots.remainder(length))
                for buf, new in ((k_cache, k_new), (v_cache, v_new)) + (
                        ((k_scale, ks_new), (v_scale, vs_new))
                        if quant_kv else ()):
                    mask = keep.reshape(keep.shape + (1,) * (new.dim() - 2))
                    buf[at] = torch.where(mask, new, buf[at])
            k, v = k_cache, v_cache

        # grouped-query attention without repeating K/V: query head h reads
        # kv head h // groups. q: (B, S, KV, G, D), k: (B, L, KV, D).
        groups = c.num_heads // c.num_kv_heads
        qg = q.reshape(b, s, c.num_kv_heads, groups, head_dim)
        scores = torch.einsum(
            "bqhgd,bkhd->bhgqk", qg.float(), k.float()
        ) / math.sqrt(head_dim)
        if k_scale is not None:
            # scale (B, L, KV) -> (B, KV, 1, 1, L)
            scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None]
        # attn_bias is (B|1, 1, S, L); the group axis broadcasts
        scores = scores + attn_bias[:, :, None]
        probs = torch.softmax(scores, dim=-1)
        if v_scale is not None:
            probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None]
        probs = probs.to(x.dtype)
        v_mat = v.to(x.dtype) if v_scale is not None else v
        ctx = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_mat).to(x.dtype)
        return self.o_proj(ctx.reshape(b, s, c.num_heads * head_dim))


class DecoderMLP(nn.Module):
    def __init__(self, config: DecoderConfig):
        super().__init__()
        c = self.config = config
        if c.fused_projections:
            self.gateup_proj = _dense(c, c.hidden_size, 2 * c.intermediate_size)
        else:
            self.gate_proj = _dense(c, c.hidden_size, c.intermediate_size)
            self.up_proj = _dense(c, c.hidden_size, c.intermediate_size)
        self.down_proj = _dense(c, c.intermediate_size, c.hidden_size)

    def forward(self, x):
        if self.config.fused_projections:
            gate, up = torch.chunk(self.gateup_proj(x), 2, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(nn.functional.silu(gate) * up)


class DecoderLayer(nn.Module):
    def __init__(self, config: DecoderConfig):
        super().__init__()
        self.input_norm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.attention = DecoderAttention(config)
        self.post_attention_norm = RMSNorm(
            config.hidden_size, config.rms_norm_eps)
        self.mlp = DecoderMLP(config)

    def forward(self, x, rope, attn_bias, cache=None):
        x = x + self.attention(self.input_norm(x), rope, attn_bias, cache)
        return x + self.mlp(self.post_attention_norm(x))


def _bias(valid: torch.Tensor) -> torch.Tensor:
    """0 where valid, -1e9 elsewhere (f32)."""
    return (~valid).float() * -1e9


def attention_bias(s: int, positions: torch.Tensor,
                   attention_mask: Optional[torch.Tensor],
                   kv_valid: Optional[torch.Tensor],
                   cache_len: Optional[int]) -> torch.Tensor:
    """The additive attention bias of a block of `s` tokens: causal (+
    padding) over the block itself without a cache (cache_len None); with
    one, the caller's `kv_valid` slots, else keys at positions <= each
    query's (+ an attention_mask of key validity)."""
    dev = positions.device
    if cache_len is None:
        # causal (+ padding) bias over the in-sequence keys
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))
        bias = _bias(causal[None, None])
    elif kv_valid is not None:
        # cache slots decoupled from token positions: the caller says which
        # slots each row (2-D) or each query token (3-D) sees; `positions`
        # stays the true token position (RoPE)
        if kv_valid.dim() == 3:
            return _bias(kv_valid[:, None, :, :])
        return _bias(kv_valid[:, None, None, :])
    else:
        # query at position p sees cache keys at positions <= p;
        # attention_mask is a (B, cache_len) key-validity mask
        key_pos = torch.arange(cache_len, device=dev)
        bias = _bias(
            key_pos[None, None, None, :] <= positions[:, None, :, None])
    if attention_mask is not None:
        bias = bias + _bias(attention_mask[:, None, None, :] > 0)
    return bias


class LlamaDecoder(nn.Module):
    """Returns logits (B, S, V) in f32; with `cache` (updated in place) it
    runs one incremental block and returns (logits, cache).

    `last_positions` (B,) keeps one position per row before the final
    norm and the lm_head, so logits are (B, 1, V): a prefill's callers
    read one row, and the full (B, S, V) block would be gigabytes at a
    128k vocabulary."""

    def __init__(self, config: DecoderConfig):
        super().__init__()
        c = self.config = config
        if c.quantized_weights:
            self.embed_tokens = QuantEmbed(c.vocab_size, c.hidden_size)
        else:
            self.embed_tokens = Embed(c.vocab_size, c.hidden_size)
        self.layers = nn.ModuleList(
            DecoderLayer(c) for _ in range(c.num_layers))
        self.final_norm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        if not c.tie_word_embeddings:
            self.lm_head = _dense(c, c.hidden_size, c.vocab_size, bits=8)

    def forward(
        self,
        input_ids: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        cache: Optional[Dict] = None,
        cache_pos=None,
        kv_valid: Optional[torch.Tensor] = None,
        return_hidden: bool = False,
        last_positions: Optional[torch.Tensor] = None,
    ):
        c = self.config
        b, s = input_ids.shape
        dev = input_ids.device
        if positions is None:
            positions = torch.arange(s, device=dev)[None, :].expand(b, s)
        x = self.embed_tokens(input_ids).to(c.compute_dtype)
        bias = attention_bias(
            s, positions, attention_mask, kv_valid,
            None if cache is None else cache["k"][0].shape[1])

        quant_kv = cache is not None and "k_scale" in cache
        rope = _rope_tables(positions, c.hidden_size // c.num_heads,
                            c.rope_theta)
        for i, layer in enumerate(self.layers):
            layer_cache = None
            if cache is not None:
                layer_cache = (
                    cache["k"][i],
                    cache["v"][i],
                    cache_pos,
                    cache["k_scale"][i] if quant_kv else None,
                    cache["v_scale"][i] if quant_kv else None,
                )
            x = layer(x, rope, bias, layer_cache)
        if last_positions is not None:
            x = x[torch.arange(b, device=dev), last_positions][:, None, :]
        x = self.final_norm(x)
        if return_hidden:
            return (x, cache) if cache is not None else x
        if c.tie_word_embeddings:
            logits = self.embed_tokens.attend(x)
        else:
            logits = self.lm_head(x).float()
        return (logits, cache) if cache is not None else logits


# ---------------------------------------------------------------------------
# Parameter trees (nested dicts of tensors, the JAX package's layout).
# ---------------------------------------------------------------------------


def _cat_columns(dense_leaves) -> Dict:
    """Concatenate Dense leaves ({kernel}, or quantized {values, scale})
    along the output dim N."""
    return {key: torch.cat([as_tensor(d[key]) for d in dense_leaves], dim=1)
            for key in dense_leaves[0]}


def fuse_params(params: Mapping) -> Dict:
    """An unfused tree (q/k/v + gate/up) -> the fused-serving layout.
    Concatenation along the OUTPUT dim is exact: each output column keeps
    its own reduction, and a quantized column its own scale (int8 or packed
    int4 alike: a packed byte holds two rows of ONE column)."""
    out: Dict[str, Any] = {}
    for name, sub in params.items():
        if not name.startswith("layer_"):
            out[name] = sub
            continue
        att, mlp = sub["attention"], sub["mlp"]
        out[name] = dict(sub)
        out[name]["attention"] = {
            "qkv_proj": _cat_columns(
                [att[p] for p in ("q_proj", "k_proj", "v_proj")]),
            "o_proj": att["o_proj"],
        }
        out[name]["mlp"] = {
            "gateup_proj": _cat_columns([mlp["gate_proj"], mlp["up_proj"]]),
            "down_proj": mlp["down_proj"],
        }
    return out


def _is_quant_pair(d) -> bool:
    return (isinstance(d, Mapping) and set(d) == {"values", "scale"}
            and not as_tensor(d["values"]).is_floating_point())


def cast_params(params: Mapping, dtype) -> Dict:
    """Cast floating-point leaves to `dtype`. Quantized {values, scale}
    pairs pass through untouched: their scale must stay f32."""

    def walk(d):
        if isinstance(d, Mapping):
            if _is_quant_pair(d):
                return dict(d)
            return {name: walk(sub) for name, sub in d.items()}
        d = as_tensor(d)
        return d.to(dtype) if d.is_floating_point() else d

    return walk(params)


def quantize_decoder_params(params: Mapping, bits: int = 8) -> Dict:
    """A served tree -> the quantized layout: every Dense {kernel} becomes
    {values int8, scale f32 (1, N)} (bits=4: the layer projections pack
    int4 pairs into (K/2, N) values; an untied lm_head stays int8) and the
    embedding {embedding} a per-row-quantized int8 table {values (V, H),
    scale (V, 1)}. Apply AFTER cast_params (scales are derived in f32 and
    stay f32)."""
    if bits not in (4, 8):
        raise ValueError(f"quantized weights are int8 or int4, not {bits}")

    def walk(d):
        out = {}
        for name, sub in d.items():
            if isinstance(sub, Mapping):
                keys = set(sub)
                if keys == {"kernel"}:
                    kernel = as_tensor(sub["kernel"])
                    if bits == 4 and name != "lm_head":
                        values, scale = quant_matmul.quantize_weight_int4(
                            kernel)
                    else:
                        values, scale = quant_matmul.quantize_weight(
                            kernel, axis=0)
                    out[name] = {"values": values, "scale": scale}
                elif keys == {"embedding"}:
                    values, scale = quant_matmul.quantize_weight(
                        as_tensor(sub["embedding"]), axis=1)
                    out[name] = {"values": values, "scale": scale}
                else:
                    out[name] = walk(sub)
            else:
                out[name] = sub
        return out

    return walk(params)


def _param_tree(c: DecoderConfig, dense, embed, norm, head=None) -> Dict:
    """The unfused parameter tree of `c`, leaves made by dense(k_in,
    n_out), embed(), norm() and, for an untied lm_head, head(k_in, n_out)
    (default: dense), in the order the JAX package builds it."""
    h = c.hidden_size
    head_dim = h // c.num_heads
    params: Dict[str, Any] = {"embed_tokens": embed(), "final_norm": norm()}
    for i in range(c.num_layers):
        params[f"layer_{i}"] = {
            "attention": {
                "q_proj": dense(h, c.num_heads * head_dim),
                "k_proj": dense(h, c.num_kv_heads * head_dim),
                "v_proj": dense(h, c.num_kv_heads * head_dim),
                "o_proj": dense(c.num_heads * head_dim, h),
            },
            "mlp": {
                "gate_proj": dense(h, c.intermediate_size),
                "up_proj": dense(h, c.intermediate_size),
                "down_proj": dense(c.intermediate_size, h),
            },
            "input_norm": norm(),
            "post_attention_norm": norm(),
        }
    if not c.tie_word_embeddings:
        params["lm_head"] = (head or dense)(h, c.vocab_size)
    return params


def random_quantized_params(
    config: DecoderConfig, seed: int = 0, bits: Optional[int] = None,
    device=None,
) -> Dict:
    """Random int8 / int4 tree built DIRECTLY on the device, for model
    sizes whose float tree should never exist. Values are uniform random
    bytes in [-127, 127]; scales are per-output-channel constants chosen so
    that dequantized weights have lecun-normal magnitude (std
    1/sqrt(fan_in)), which keeps the forward sane through all layers. With
    bits=4 each layer projection is (K/2, N) packed bytes, whose two
    nibbles decode to [-8, 7] (std ~4.6); the embedding and an untied
    lm_head stay int8."""
    bits = config.quantized_bits if bits is None else bits
    if bits not in (4, 8):
        raise ValueError(f"quantized weights are int8 or int4, not {bits}")
    dev = resolve_device(device)
    c, h = config, config.hidden_size
    gen = torch.Generator(device=dev).manual_seed(seed)

    def quantized(shape, fan_in, scale_shape, std=73.6):
        # uniform[-127, 127] int8 has std ~73.6
        return {
            "values": torch.randint(-127, 128, shape, dtype=torch.int8,
                                    device=dev, generator=gen),
            "scale": torch.full(scale_shape, 1.0 / (std * np.sqrt(fan_in)),
                                dtype=torch.float32, device=dev),
        }

    def int8_dense(k_in, n_out):
        return quantized((k_in, n_out), k_in, (1, n_out))

    def int4_dense(k_in, n_out):
        return quantized((k_in // 2, n_out), k_in, (1, n_out), std=4.6)

    return _param_tree(
        c,
        dense=int4_dense if bits == 4 else int8_dense,
        embed=lambda: quantized((c.vocab_size, h), h, (c.vocab_size, 1)),
        norm=lambda: {"scale": torch.ones((h,), dtype=c.compute_dtype,
                                          device=dev)},
        head=int8_dense,
    )


def random_params(config: DecoderConfig, seed: int = 0, device=None) -> Dict:
    """A random FLOAT (f32, unfused) tree: Dense kernels and the embedding
    normal with std 1/sqrt(fan_in), norm scales one."""
    dev = resolve_device(device)
    c, h = config, config.hidden_size
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, fan_in):
        return torch.randn(shape, device=dev, generator=gen) / math.sqrt(fan_in)

    return _param_tree(
        c,
        dense=lambda k_in, n_out: {"kernel": normal((k_in, n_out), k_in)},
        embed=lambda: {"embedding": normal((c.vocab_size, h), h)},
        norm=lambda: {"scale": torch.ones((h,), device=dev)},
    )


def init_cache(
    config: DecoderConfig, batch: int, max_len: int, device=None
) -> Dict[str, List[torch.Tensor]]:
    dev = resolve_device(device)
    head_dim = config.hidden_size // config.num_heads
    shape = (batch, max_len, config.num_kv_heads, head_dim)
    quant = config.kv_cache_dtype == "int8"
    kv_dtype = torch.int8 if quant else config.compute_dtype
    out = {
        name: [torch.zeros(shape, dtype=kv_dtype, device=dev)
               for _ in range(config.num_layers)]
        for name in ("k", "v")
    }
    if quant:
        for name in ("k_scale", "v_scale"):
            out[name] = [
                torch.zeros(shape[:3], dtype=torch.float32, device=dev)
                for _ in range(config.num_layers)
            ]
    return out


# ---------------------------------------------------------------------------
# HF checkpoint import (LlamaForCausalLM naming).
# ---------------------------------------------------------------------------


def params_from_llama(sd: Mapping[str, Any], config: DecoderConfig) -> Dict:
    def _t(x):
        if isinstance(x, torch.Tensor):
            return x.detach()
        return torch.as_tensor(np.asarray(x))

    def dense(prefix):
        return {"kernel": _t(sd[prefix + ".weight"]).T}

    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    params: Dict[str, Any] = {
        "embed_tokens": {"embedding": _t(sd[f"{prefix}embed_tokens.weight"])},
        "final_norm": {"scale": _t(sd[f"{prefix}norm.weight"])},
    }
    for i in range(config.num_layers):
        p = f"{prefix}layers.{i}"
        params[f"layer_{i}"] = {
            "input_norm": {"scale": _t(sd[f"{p}.input_layernorm.weight"])},
            "post_attention_norm": {
                "scale": _t(sd[f"{p}.post_attention_layernorm.weight"])
            },
            "attention": {
                name: dense(f"{p}.self_attn.{name}")
                for name in ("q_proj", "k_proj", "v_proj", "o_proj")
            },
            "mlp": {
                name: dense(f"{p}.mlp.{name}")
                for name in ("gate_proj", "up_proj", "down_proj")
            },
        }
    if not config.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = dense("lm_head")
    return params
