"""Tensor parallelism for the sentence encoders.

The counterpart of ``persian_rag_tpu.parallel.tp``: Megatron column / row
splits over one mesh axis,

  query / key / value kernels : split the output dim (column parallel)
  attention output kernel     : split the input dim  (row parallel)
  intermediate kernel         : split the output dim (column parallel)
  ffn_output kernel           : split the input dim  (row parallel)
  matching biases             : split with a column split; a row-split
                                layer's bias is added after the sum
  embeddings, layer norms     : replicated

A dimension the axis does not divide stays replicated (`place_params`).
The JAX package places the leaves and lets XLA insert the all-reduces;
here `TensorParallelEncoder` runs the forward itself: each device computes
its heads' attention and its slice of the FFN, and the row-parallel
partial outputs are copied to the axis's first device and summed there in
shard order. The attention block splits on whole heads only (a head
count the axis does not divide replicates it, where GSPMD would reshard a
mid-head split), and the FFN splits with the intermediate width; the
values are the same. Nothing in the package serves through it: as in the
JAX package, only tests call it.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from persian_rag_tpu_torch.core.mesh import Mesh
from persian_rag_tpu_torch.models.convert import (
    as_tensor,
    encoder_params_from_flax,
)
from persian_rag_tpu_torch.models.encoder import TransformerEncoder, _act

_COLUMN_PARALLEL = ("query", "key", "value", "intermediate")
_ROW_PARALLEL = ("output", "ffn_output")
_ATTENTION = ("query", "key", "value", "output")


def _spec_for(path: Tuple[str, ...], leaf_name: str) -> Optional[int]:
    """The dimension a leaf splits on, or None (replicated)."""
    parent = path[-1] if path else ""
    if parent in _COLUMN_PARALLEL:
        return {"kernel": 1, "bias": 0}.get(leaf_name)
    if parent in _ROW_PARALLEL and leaf_name == "kernel":
        return 0
    return None


def place_params(params: Mapping, mesh: Mesh, axis: str,
                 spec_fn: Callable, split_fn: Optional[Callable] = None
                 ) -> Dict[str, Any]:
    """Walk a params tree (the JAX package's layout) and turn each leaf
    into a list with one tensor per device along `axis`: its shards along
    the dimension ``spec_fn(path, leaf_name)`` picks, or a copy for each
    device where it picks None or the axis does not divide that
    dimension. ``split_fn(path, leaf, n)``, when given, splits a leaf
    itself (or returns None to use the plain split)."""
    devices = mesh.axis_devices(axis)
    n = len(devices)

    def place(path: Tuple[str, ...], leaf):
        t = as_tensor(leaf)
        dim = spec_fn(path[:-1], path[-1])
        parts = None
        if dim is not None and t.shape[dim] % n == 0:
            parts = split_fn(path, t, n) if split_fn else None
            if parts is None:
                # a column shard is a strided view: the kernels read
                # contiguous rows
                parts = [p.contiguous() for p in torch.chunk(t, n, dim)]
        if parts is None:
            parts = [t] * n
        return [p.to(d) for p, d in zip(parts, devices)]

    def walk(node, path=()):
        if isinstance(node, Mapping):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return place(path, node)

    return walk(params)


def shard_params_tensor_parallel(
    params: Mapping, mesh: Mesh, axis: str = "corpus", config=None
) -> Dict[str, Any]:
    """The encoder params tree with each leaf a per-device list, split by
    the Megatron rules over `axis` (dimensions the axis does not divide
    stay replicated). With the encoder's `config`, the attention block
    splits only on whole heads, and the FFN only where the axis divides
    its width, so that every leaf of a block is split alike."""
    n = mesh.shape[axis]
    spec = _spec_for
    if config is not None:
        heads_ok = config.num_heads % n == 0
        ffn_ok = config.intermediate_size % n == 0

        def spec(path, leaf_name):
            parent = path[-1] if path else ""
            if parent in _ATTENTION and not heads_ok:
                return None
            if parent in ("intermediate", "ffn_output") and not ffn_ok:
                return None
            return _spec_for(path, leaf_name)

    return place_params(params, mesh, axis, spec)


def _split(part_list: List[torch.Tensor], full_dim: int, dim: int) -> bool:
    return part_list[0].shape[dim] != full_dim


class TensorParallelEncoder:
    """A `TransformerEncoder` forward over a tensor-parallel params tree:
    (B, S) ids and mask -> (B, S, H) hidden states on the axis's first
    device. `params` is the encoder's tree in the JAX layout
    (``models.convert.params_to_flax``)."""

    def __init__(self, config, params: Mapping, mesh: Mesh,
                 axis: str = "corpus"):
        self.config = config
        self.devices = mesh.axis_devices(axis)
        self.device = self.devices[0]
        self.tp = shard_params_tensor_parallel(params, mesh, axis, config)
        # embeddings and layer norms (replicated) run on the first device
        with torch.device("meta"):
            base = TransformerEncoder(config)
        state = {k: v.to(self.device)
                 for k, v in encoder_params_from_flax(params).items()
                 if ".attention." not in k and ".intermediate." not in k
                 and ".ffn_output." not in k}
        base.load_state_dict(state, strict=False, assign=True)
        self.base = base.eval()

    def _count(self, split: bool) -> int:
        """Shards of a block: every device when split, else the first."""
        return len(self.devices) if split else 1

    def _attention(self, layer: Mapping, x, bias):
        c = self.config
        att = layer["attention"]
        head_dim = c.hidden_size // c.num_heads
        b, s, _ = x.shape
        total = None
        for p in range(self._count(
                _split(att["query"]["kernel"], c.hidden_size, 1))):
            dev = self.devices[p]
            xd = x.to(dev, non_blocking=True)

            def proj(name):
                y = xd @ att[name]["kernel"][p] + att[name]["bias"][p]
                return y.reshape(b, s, -1, head_dim)

            q, k, v = proj("query"), proj("key"), proj("value")
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(
                head_dim)
            probs = torch.softmax(scores + bias.to(dev), dim=-1)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, -1)
            part = (ctx @ att["output"]["kernel"][p]).to(
                self.device, non_blocking=True)
            total = part if total is None else total + part
        # the row-parallel bias, added once after the sum
        return total + att["output"]["bias"][0]

    def _ffn(self, layer: Mapping, x):
        c = self.config
        inter, out = layer["intermediate"], layer["ffn_output"]
        total = None
        for p in range(self._count(
                _split(inter["kernel"], c.intermediate_size, 1))):
            xd = x.to(self.devices[p], non_blocking=True)
            h = _act(c.hidden_act, xd @ inter["kernel"][p] + inter["bias"][p])
            part = (h @ out["kernel"][p]).to(self.device, non_blocking=True)
            total = part if total is None else total + part
        return total + out["bias"][0]

    @torch.no_grad()
    def __call__(self, input_ids, attention_mask=None) -> torch.Tensor:
        ids = torch.as_tensor(input_ids, dtype=torch.long).to(self.device)
        mask = (torch.ones_like(ids) if attention_mask is None else
                torch.as_tensor(attention_mask, dtype=torch.long).to(
                    self.device))
        x = self.base.embeddings(ids)
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(
            torch.float32)
        for i, module in enumerate(self.base.layers):
            layer = self.tp[f"layer_{i}"]
            x = module.attention_norm(x + self._attention(layer, x, bias))
            x = module.output_norm(x + self._ffn(layer, x))
        return x
