"""Tensor parallelism for the Llama decoder.

The counterpart of ``persian_rag_tpu.parallel.tp_decoder``: Megatron
column / row splits over one mesh axis (kernels are (in, out)),

  q / k / v projections : split the output dim (column parallel: heads)
  attention o_proj      : split the input dim  (row parallel)
  mlp gate / up         : split the output dim (column parallel)
  mlp down_proj         : split the input dim  (row parallel)
  embed_tokens          : split on the vocabulary (a lookup sums each
                          shard's rows in range; the tied lm_head
                          concatenates the (B, V/n) logit shards)
  lm_head (untied)      : split the output (vocabulary) dim
  RMSNorm scales        : replicated

Quantized trees split the same way: a per-output-channel scale follows a
column split and stays whole with a row split. A row split of an int4
projection is unpacked, cut and packed again per shard: its (K/2, N)
bytes hold row i and row i + K/2 together (``quantize_weight_int4``), so
the packed rows of a K-slice are not a slice of the packed rows.

`TPLlamaDecoder` runs the forward the JAX package leaves to GSPMD: the
residual stream and the norms stay on the axis's first device; each shard
computes its heads' attention (with a KV cache of its own kv heads) and
its slice of the MLP on its device, and the row-parallel outputs come back
as f32 partials, summed in shard order and cast once, as the single
device casts its one f32 product. The attention block splits only on
whole (query, kv) head groups and otherwise stays whole on the first
device (where the JAX package reshards a mid-head split); the MLP, the
embedding and the lm_head split where the axis divides their widths.
Fused projections are not served on a mesh, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional

import torch
from torch import nn

from persian_rag_tpu_torch.core.mesh import Mesh
from persian_rag_tpu_torch.models.decoder import (
    DecoderAttention,
    DecoderConfig,
    DecoderMLP,
    Dense,
    QuantDense,
    RMSNorm,
    _rope_tables,
    attention_bias,
    init_cache,
)
from persian_rag_tpu_torch.ops import quant_matmul
from persian_rag_tpu_torch.parallel.tp import place_params

_COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
                    "lm_head")
_ROW_PARALLEL = ("o_proj", "down_proj")
_ATTENTION = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def _spec_for(path, leaf_name: str) -> Optional[int]:
    parent = path[-1] if path else ""
    if parent in _COLUMN_PARALLEL and leaf_name in ("kernel", "values",
                                                    "scale"):
        return 1
    if parent in _ROW_PARALLEL and leaf_name in ("kernel", "values"):
        return 0
    if parent == "embed_tokens" and leaf_name in ("embedding", "values",
                                                  "scale"):
        return 0
    return None


def split_int4_rows(packed: torch.Tensor, n: int) -> List[torch.Tensor]:
    """Row-split packed int4 bytes (K/2, N) into n packed (K/(2n), N)
    shards of the unpacked (K, N) matrix's K-slices."""
    lo, hi = quant_matmul.unpack_int4(packed)
    q = torch.cat([lo, hi])  # (K, N) nibble values
    out = []
    for part in torch.chunk(q, n):
        half = part.shape[0] // 2
        low, high = part[:half] & 0xF, part[half:] & 0xF
        out.append((low | (high << 4)).to(torch.uint8).view(torch.int8))
    return out


def split_plan(config: DecoderConfig, n: int) -> Dict[str, bool]:
    """Which blocks an n-way axis splits: the attention block when n
    divides the kv heads (whole (query, kv) head groups), the MLP when it
    divides the intermediate width, embed_tokens / lm_head when it
    divides the vocabulary. An int4 row-parallel shard needs an even
    height, else its block stays whole."""
    head_dim = config.hidden_size // config.num_heads
    int4 = config.quantized_weights and config.quantized_bits == 4
    return {
        "attention": config.num_kv_heads % n == 0 and not (
            int4 and (config.num_heads // n * head_dim) % 2),
        "mlp": config.intermediate_size % n == 0 and not (
            int4 and (config.intermediate_size // n) % 2),
        "vocab": config.vocab_size % n == 0,
    }


def shard_decoder_params_tp(
    params: Mapping, mesh: Mesh, config: DecoderConfig, axis: str = "corpus"
) -> Dict:
    """The decoder params tree with each leaf a per-device list along
    `axis`: split per the module docstring where `split_plan` splits its
    block, else a copy per device; int4 row-parallel leaves split through
    `split_int4_rows`."""
    plan = split_plan(config, mesh.shape[axis])
    int4 = config.quantized_weights and config.quantized_bits == 4

    def spec(path, leaf_name):
        parent = path[-1] if path else ""
        if parent in _ATTENTION and not plan["attention"]:
            return None
        if parent in _MLP and not plan["mlp"]:
            return None
        if parent in ("embed_tokens", "lm_head") and not plan["vocab"]:
            return None
        return _spec_for(path, leaf_name)

    def split(path, t, n):
        if int4 and path[-2] in _ROW_PARALLEL and path[-1] == "values":
            return split_int4_rows(t, n)
        return None

    return place_params(params, mesh, axis, spec, split)


class _RowPartial(nn.Module):
    """A row-parallel shard's product as an f32 partial (the caller sums
    the partials and casts once)."""

    def __init__(self, dense: nn.Module):
        super().__init__()
        self.dense = dense

    def forward(self, x):
        d = self.dense
        if isinstance(d, QuantDense):
            matmul = (quant_matmul.w4a16_matmul if d.bits == 4
                      else quant_matmul.w8a16_matmul)
            return matmul(x, d.values, d.scale)
        return x.float() @ d.kernel.float()


def _dense(leaf: Mapping, bits: int) -> nn.Module:
    """A Dense / QuantDense module holding one shard's tensors as they
    are."""
    if "kernel" in leaf:
        k = leaf["kernel"]
        with torch.device("meta"):
            m = Dense(k.shape[0], k.shape[1])
        m.kernel = nn.Parameter(k, requires_grad=False)
        return m
    values = leaf["values"]
    with torch.device("meta"):
        m = QuantDense(values.shape[0] * (2 if bits == 4 else 1),
                       values.shape[1], bits)
    m.values, m.scale = values, leaf["scale"]
    return m


def _module(cls, config, **children) -> nn.Module:
    """An attention or MLP block of a shard: `cls`'s forward over the given
    sublayers and a config of the shard's widths."""
    m = cls.__new__(cls)
    nn.Module.__init__(m)
    m.config = config
    for name, child in children.items():
        setattr(m, name, child)
    return m


class _Part(nn.Module):
    """One shard of a block: its device and its module."""

    def __init__(self, device: torch.device, module: nn.Module):
        super().__init__()
        self.device = device
        self.block = module


class TPLlamaDecoder(nn.Module):
    """`LlamaDecoder` over a tensor-parallel split of a parameter tree
    (float, int8 or int4; unfused). The same call signature and results;
    the cache is `new_cache`'s ({"parts": one `init_cache` per attention
    shard}). `params` may live anywhere: each shard is copied to its
    device."""

    def __init__(self, config: DecoderConfig, params: Mapping, mesh: Mesh,
                 axis: str = "corpus"):
        super().__init__()
        if config.fused_projections:
            raise ValueError("a tensor-parallel decoder serves unfused "
                             "projections (no fused projections on a mesh)")
        c = self.config = config
        self.devices = mesh.axis_devices(axis)
        self.device = self.devices[0]
        tree = shard_decoder_params_tp(params, mesh, config, axis)
        bits = c.quantized_bits if c.quantized_weights else 8
        head_dim = c.hidden_size // c.num_heads
        plan = split_plan(c, len(self.devices))
        n_attn = len(self.devices) if plan["attention"] else 1
        n_mlp = len(self.devices) if plan["mlp"] else 1
        n_vocab = len(self.devices) if plan["vocab"] else 1
        # a shard's attention widths (hidden_size: its q width, which
        # init_cache reads as heads x head_dim)
        self.attn_config = dataclasses.replace(
            c, num_heads=c.num_heads // n_attn,
            num_kv_heads=c.num_kv_heads // n_attn,
            hidden_size=head_dim * (c.num_heads // n_attn))
        mlp_config = dataclasses.replace(
            c, intermediate_size=c.intermediate_size // n_mlp)
        self.head_dim = head_dim

        def norm(leaf):
            with torch.device("meta"):
                m = RMSNorm(c.hidden_size, c.rms_norm_eps)
            m.scale = nn.Parameter(leaf["scale"][0], requires_grad=False)
            return m

        self.input_norms = nn.ModuleList()
        self.post_norms = nn.ModuleList()
        self.attn = nn.ModuleList()
        self.mlp = nn.ModuleList()
        for i in range(c.num_layers):
            layer = tree[f"layer_{i}"]
            self.input_norms.append(norm(layer["input_norm"]))
            self.post_norms.append(norm(layer["post_attention_norm"]))
            att, mlp = layer["attention"], layer["mlp"]
            parts = nn.ModuleList()
            for p in range(n_attn):
                block = _module(
                    DecoderAttention, self.attn_config,
                    q_proj=_dense(_at(att["q_proj"], p), bits),
                    k_proj=_dense(_at(att["k_proj"], p), bits),
                    v_proj=_dense(_at(att["v_proj"], p), bits),
                    o_proj=_RowPartial(_dense(_at(att["o_proj"], p), bits)))
                block.head_dim = head_dim
                parts.append(_Part(self.devices[p], block))
            self.attn.append(parts)
            parts = nn.ModuleList()
            for p in range(n_mlp):
                parts.append(_Part(self.devices[p], _module(
                    DecoderMLP, mlp_config,
                    gate_proj=_dense(_at(mlp["gate_proj"], p), bits),
                    up_proj=_dense(_at(mlp["up_proj"], p), bits),
                    down_proj=_RowPartial(
                        _dense(_at(mlp["down_proj"], p), bits)))))
            self.mlp.append(parts)
        self.final_norm = norm(tree["final_norm"])
        self.embed = [(self.devices[p], _at(tree["embed_tokens"], p))
                      for p in range(n_vocab)]
        self.vocab_shard = c.vocab_size // n_vocab
        self.lm_head = None
        if not c.tie_word_embeddings:
            self.lm_head = nn.ModuleList(
                _Part(self.devices[p], _dense(_at(tree["lm_head"], p), 8))
                for p in range(n_vocab))

    # -- cache ------------------------------------------------------------------

    def new_cache(self, batch: int, max_len: int) -> Dict:
        """A KV cache per attention shard, each of its own kv heads, on the
        shard's device."""
        return {"parts": [init_cache(self.attn_config, batch, max_len,
                                     part.device)
                          for part in self.attn[0]]}

    # -- forward ----------------------------------------------------------------

    def _embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """The vocab-split lookup: each shard gathers the ids in its range
        (others read zero rows), and the shards sum, exactly."""
        out = None
        for p, (dev, leaf) in enumerate(self.embed):
            local = ids.to(dev) - p * self.vocab_shard
            inside = (local >= 0) & (local < self.vocab_shard)
            local = local.clamp(0, self.vocab_shard - 1)
            if "values" in leaf:
                rows = leaf["values"][local].float() * leaf["scale"][local]
            else:
                rows = leaf["embedding"][local]
            rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
            rows = rows.to(self.device)
            out = rows if out is None else out + rows
        return out

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits, the vocabulary shards concatenated in order."""
        parts = []
        if self.lm_head is None:
            for dev, leaf in self.embed:
                xd = x.to(dev)
                if "values" in leaf:
                    y = quant_matmul.w8a16_matmul_nt(xd, leaf["values"],
                                                     leaf["scale"])
                else:
                    y = xd.float() @ leaf["embedding"].float().T
                parts.append(y.to(self.device))
        else:
            for part in self.lm_head:
                parts.append(part.block(x.to(part.device)).float().to(
                    self.device))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)

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
        input_ids = input_ids.to(self.device)
        b, s = input_ids.shape
        dev = self.device
        if positions is None:
            positions = torch.arange(s, device=dev)[None, :].expand(b, s)
        positions = positions.to(dev)
        if attention_mask is not None:
            attention_mask = attention_mask.to(dev)
        if kv_valid is not None:
            kv_valid = kv_valid.to(dev)
        x = self._embed_tokens(input_ids).to(c.compute_dtype)
        caches = None if cache is None else cache["parts"]
        bias = attention_bias(
            s, positions, attention_mask, kv_valid,
            None if cache is None else caches[0]["k"][0].shape[1])
        rope = _rope_tables(positions, self.head_dim, c.rope_theta)
        on = {}  # per-device copies of the tensors every shard reads

        def at(device, key, t):
            if (device, key) not in on:
                on[device, key] = (None if t is None else
                                   t.to(device) if isinstance(t, torch.Tensor)
                                   else t)
            return on[device, key]

        for i in range(c.num_layers):
            h = self.input_norms[i](x)
            total = None
            for p, part in enumerate(self.attn[i]):
                d = part.device
                layer_cache = None
                if caches is not None:
                    cp = caches[p]
                    quant = "k_scale" in cp
                    layer_cache = (
                        cp["k"][i], cp["v"][i], at(d, "pos", cache_pos),
                        cp["k_scale"][i] if quant else None,
                        cp["v_scale"][i] if quant else None)
                rope_d = (at(d, "cos", rope[0]), at(d, "sin", rope[1]))
                y = part.block(h.to(d), rope_d, at(d, "bias", bias),
                               layer_cache).to(dev)
                total = y if total is None else total + y
            x = x + total.to(x.dtype)
            h = self.post_norms[i](x)
            total = None
            for part in self.mlp[i]:
                y = part.block(h.to(part.device)).to(dev)
                total = y if total is None else total + y
            x = x + total.to(x.dtype)
        if last_positions is not None:
            x = x[torch.arange(b, device=dev),
                  last_positions.to(dev)][:, None, :]
        x = self.final_norm(x)
        if return_hidden:
            return (x, cache) if cache is not None else x
        logits = self._logits(x)
        return (logits, cache) if cache is not None else logits


def _at(leaf: Mapping, p: int) -> Dict:
    """Shard p of every tensor of a sublayer."""
    return {k: v[p] for k, v in leaf.items()}
