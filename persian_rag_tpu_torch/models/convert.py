"""Flax parameter trees -> torch state dicts.

The Flax modules of ``persian_rag_tpu.models`` and the torch modules of
this package share their names (``models/encoder.py``), so conversion is
a renaming plus one transpose:

* ``Dense.kernel`` (in, out)  -> ``Linear.weight`` (out, in)
* ``Embed.embedding``         -> ``Embedding.weight``
* ``LayerNorm.scale``         -> ``LayerNorm.weight``
* ``layer_{i}``               -> ``layers.{i}``

Inputs are nested dicts of numpy arrays (``jax.device_get`` of a Flax
``params`` tree gives one), so this module needs no JAX.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^layer_(\d+)$")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        m = _LAYER.match(key)
        name = f"layers.{m.group(1)}" if m else key
        path = f"{prefix}.{name}" if prefix else name
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
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
