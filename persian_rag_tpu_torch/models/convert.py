"""Flax parameter trees <-> torch state dicts.

The Flax modules of ``persian_rag_tpu.models`` and the torch modules of
this package share their names (``models/encoder.py``), so conversion is
a renaming plus one transpose:

* ``Dense.kernel`` (in, out)  -> ``Linear.weight`` (out, in)
* ``Embed.embedding``         -> ``Embedding.weight``
* ``LayerNorm.scale``         -> ``LayerNorm.weight``
* ``layer_{i}``               -> ``layers.{i}``

Inputs are nested dicts of numpy arrays (``jax.device_get`` of a Flax
``params`` tree gives one), so this module needs no JAX. `params_to_flax`
goes the other way, for the fine-tuned model files both packages read.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^layer_(\d+)$")
_LAYERS = re.compile(r"(^|\.)layers\.(\d+)")


def as_tensor(leaf) -> torch.Tensor:
    """A tree leaf as a tensor; a numpy leaf is copied (the state dict
    owns writable memory; arrays out of another framework may be
    read-only)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.tensor(np.ascontiguousarray(leaf))


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """{dotted path: leaf}, with ``layer_{i}`` renamed ``layers.{i}``."""
    out: Dict[str, object] = {}
    for key, value in tree.items():
        m = _LAYER.match(key)
        name = f"layers.{m.group(1)}" if m else key
        path = f"{prefix}.{name}" if prefix else name
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


def _to_torch(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    state: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        module, leaf = path.rsplit(".", 1)
        value = np.asarray(value, np.float32)
        if leaf == "kernel":
            value = value.T
        elif leaf not in ("embedding", "scale", "bias"):
            raise KeyError(f"unexpected Flax parameter {path}")
        name = "bias" if leaf == "bias" else "weight"
        # torch.tensor copies: the state dict owns writable memory
        state[f"{module}.{name}"] = torch.tensor(np.ascontiguousarray(value))
    return state


def encoder_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for `TransformerEncoder` from a Flax TransformerEncoder
    ``params`` tree."""
    return _to_torch(_flatten(params))


def head_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for `PoolingHead` from a Flax PoolingHead ``params``
    tree (empty without a projection)."""
    return _to_torch(_flatten(params))


def params_to_flax(module: torch.nn.Module) -> Dict[str, object]:
    """The Flax ``params`` tree of an encoder or pooling-head module:
    ``Linear`` -> ``{kernel (transposed), bias}``, ``Embedding`` ->
    ``{embedding}``, ``LayerNorm`` -> ``{scale, bias}``, ``layers.{i}``
    -> ``layer_{i}``. Leaves are the module's detached tensors (a kernel a
    transposed view). The keys come in the module's registration order,
    which is the order the Flax modules create their parameters in, so a
    file written from this tree has the JAX package's layout. A module
    without parameters gives ``{}``, as a Flax head without a projection
    does."""
    tree: Dict[str, object] = {}
    for name, sub in module.named_modules():
        if isinstance(sub, torch.nn.Linear):
            leaves = {"kernel": sub.weight.detach().T}
            if sub.bias is not None:
                leaves["bias"] = sub.bias.detach()
        elif isinstance(sub, torch.nn.Embedding):
            leaves = {"embedding": sub.weight.detach()}
        elif isinstance(sub, torch.nn.LayerNorm):
            leaves = {"scale": sub.weight.detach(), "bias": sub.bias.detach()}
        elif next(sub.parameters(recurse=False), None) is not None:
            raise TypeError(f"no Flax layout for {type(sub).__name__} {name}")
        else:
            continue
        keys = _LAYERS.sub(r"\1layer_\2", name).split(".")
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaves
    return tree


def decoder_params_from_flax(params: Mapping, config=None) -> Dict[str, torch.Tensor]:
    """State dict for `LlamaDecoder` from a decoder parameter tree in the
    JAX package's layout: nested dicts whose leaves are numpy arrays or
    tensors, float (``kernel`` (in, out), ``embedding``, ``scale``), fused
    (``qkv_proj`` / ``gateup_proj``) or quantized (``values`` int8 +
    ``scale`` f32; int4 layer projections keep their packed (K/2, N) int8
    ``values``). The decoder's modules keep those names and layouts, so
    this only renames ``layer_{i}`` to ``layers.{i}`` and makes tensors
    (dtypes kept; a tensor leaf stays on its device). With `config`, the
    tree's layout is held to it (fused, quantized, int4 or int8, tied)."""
    state = {path: as_tensor(leaf) for path, leaf in _flatten(params).items()}
    if config is not None:
        quantized = "embed_tokens.values" in state
        fused = "layers.0.attention.qkv_proj." + (
            "values" if quantized else "kernel") in state
        tied = not any(k.startswith("lm_head.") for k in state)
        # packed int4 projections hold K/2 rows of the hidden width
        values = state.get("layers.0.attention." + (
            "qkv_proj" if fused else "q_proj") + ".values")
        bits = 4 if values is not None and (
            2 * values.shape[0] == config.hidden_size) else 8
        layout = (quantized, fused, tied, bits if quantized else None)
        want = (config.quantized_weights, config.fused_projections,
                config.tie_word_embeddings,
                config.quantized_bits if config.quantized_weights else None)
        if layout != want:
            raise ValueError(
                f"parameter tree is quantized={quantized}, fused={fused}, "
                f"tied={tied}, bits={layout[3]}; the config says "
                f"{', '.join(map(str, want))}")
    return state
