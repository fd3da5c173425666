"""LoRA fine-tuning of the decoder (SFT, train-on-responses-only).

The counterpart of ``persian_rag_tpu.train.lora`` (the reference notebook's
unsloth LoRA r=32 / alpha=32 on all seven projections of Llama-3.2-1B):

* LoRA is parameter surgery, not module surgery: trainable (A, B) pairs
  live in a tree of their own beside the frozen parameter tree (the JAX
  package's layout, ``models/decoder.py``); `merge_lora` gives the
  effective tree, kernel + (alpha / r) * A @ B, and the decoder runs on
  it through ``torch.func.functional_call``. Only the LoRA tensors take
  gradients;
* the SFT loss is next-token cross-entropy over the response positions
  (labels of -100 are ignored);
* AdamW at a constant rate (3e-4, no weight decay), as ``optax.adamw``.

Hazard, merge-then-forward: the JAX trainer merges each target kernel and
runs the decoder on the merged tree; the factored x @ W + s * (x @ A) @ B
rounds differently, so the port merges too (a merged copy of the seven
projections of every layer lives during a step: ~3.9 GB f32 at
Llama-3.2-1B, plus its gradient).

Chosen divergences: `LoraTrainer` raises ValueError on a fused or
quantized tree, where the JAX trainer quietly puts LoRA on the 2 of 7
projections a fused tree still names (``o_proj``, ``down_proj``), or on
none of a quantized tree's; `merged_params` returns tensors on the
trainer's device (the JAX trainer copies numpy arrays to the host).

Data parallelism: with a `mesh` (``core.mesh``) a step splits its batch
over the mesh's data axis, as the JAX trainer's jit does. Each shard runs
its forward and backward on its device against its own copy of the frozen
tree and of the LoRA tensors; its loss is its response tokens' NLL sum
over the WHOLE batch's count, so the gradients, summed on the first
device in shard order, are the full-batch mean's. One AdamW step runs
there.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from persian_rag_tpu_torch.core.device import resolve_device
from persian_rag_tpu_torch.core.mesh import DATA_AXIS, check_mesh
from persian_rag_tpu_torch.gen.generator import ByteTokenizer, _tree_to
from persian_rag_tpu_torch.models.convert import (
    as_tensor,
    decoder_params_from_flax,
)
from persian_rag_tpu_torch.models.decoder import DecoderConfig, LlamaDecoder
from persian_rag_tpu_torch.ops.flat_topk import full_f32

TARGET_MODULES = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)


def init_lora(
    params: Mapping,
    rank: int = 32,
    targets: Sequence[str] = TARGET_MODULES,
    seed: int = 0,
) -> Dict:
    """The LoRA tree mirroring every targeted ``kernel``: ``a`` (in, r)
    normal / sqrt(in), ``b`` (r, out) zeros, f32, on the kernel's device.

    Hazard, the draws: they come from ``np.random.default_rng(seed)`` in
    the tree's own order, as the JAX package draws them; Flax trees keep
    insertion order (``layer_0, layer_1, ..., layer_10``), so the walk
    never sorts, or the ``a`` matrices would differ from JAX's."""
    rng = np.random.default_rng(seed)
    lora: Dict[str, Any] = {}

    def visit(node, out):
        for name, child in node.items():
            if name in targets and "kernel" in child:
                kernel = as_tensor(child["kernel"])
                fan_in, fan_out = kernel.shape
                a = (rng.standard_normal((fan_in, rank))
                     / np.sqrt(fan_in)).astype(np.float32)
                out[name] = {
                    "a": torch.from_numpy(a).to(kernel.device),
                    "b": torch.zeros((rank, fan_out), dtype=torch.float32,
                                     device=kernel.device),
                }
            elif isinstance(child, Mapping):
                sub: Dict[str, Any] = {}
                visit(child, sub)
                if sub:
                    out[name] = sub

    visit(params, lora)
    return lora


def merge_lora(params: Mapping, lora: Mapping, alpha: float = 32.0,
               rank: int = 32) -> Dict:
    """Effective params: kernel + (alpha / rank) * A @ B on every LoRA
    target; every other leaf is the base tree's own tensor."""
    scale = alpha / rank

    def visit(p_node, l_node):
        out = {}
        for name, child in p_node.items():
            if name in l_node and "a" in l_node[name]:
                delta = l_node[name]["a"] @ l_node[name]["b"] * scale
                out[name] = {"kernel": as_tensor(child["kernel"]) + delta}
            elif isinstance(child, Mapping) and name in l_node:
                out[name] = visit(child, l_node[name])
            else:
                out[name] = child
        return out

    return visit(params, lora)


# ---------------------------------------------------------------------------
# SFT data prep (chat format, responses-only labels).
# ---------------------------------------------------------------------------

PROMPT_TEMPLATE = "سوال: {question}\nپاسخ: "


def build_sft_example(
    question: str,
    answer: str,
    tokenizer,
    max_len: int = 256,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (input_ids, labels); labels are -100 on prompt positions."""
    prompt_ids = tokenizer.encode(PROMPT_TEMPLATE.format(question=question))
    answer_ids = tokenizer.encode(answer, add_bos=False) + [tokenizer.eos_id]
    ids = (prompt_ids + answer_ids)[:max_len]
    labels = ([-100] * len(prompt_ids) + answer_ids)[:max_len]
    return np.asarray(ids, np.int32), np.asarray(labels, np.int32)


def pad_batch(
    examples: Sequence[Tuple[np.ndarray, np.ndarray]], pad_id: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    max_len = max(len(ids) for ids, _ in examples)
    batch = len(examples)
    ids = np.full((batch, max_len), pad_id, np.int32)
    labels = np.full((batch, max_len), -100, np.int32)
    mask = np.zeros((batch, max_len), np.int32)
    for i, (e_ids, e_labels) in enumerate(examples):
        ids[i, : len(e_ids)] = e_ids
        labels[i, : len(e_labels)] = e_labels
        mask[i, : len(e_ids)] = 1
    return ids, labels, mask


def _leaves(tree: Mapping) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for child in tree.values():
        out.extend(_leaves(child) if isinstance(child, Mapping) else [child])
    return out


def _like(tree: Mapping, leaves) -> Dict:
    """The tree `tree` with its leaves replaced, in order, by `leaves`."""
    it = iter(leaves)

    def walk(node):
        return {k: walk(v) if isinstance(v, Mapping) else next(it)
                for k, v in node.items()}

    return walk(tree)


def _names(tree: Mapping) -> set:
    out = set()
    for name, child in tree.items():
        out.add(name)
        if isinstance(child, Mapping):
            out |= _names(child)
    return out


class LoraTrainer:
    def __init__(
        self,
        config: DecoderConfig,
        params: Mapping,
        rank: int = 32,
        alpha: float = 32.0,
        tokenizer=None,
        mesh=None,
        seed: int = 0,
        device=None,
    ):
        """params: a float, unfused parameter tree in the JAX layout
        (numpy arrays or tensors), moved to `device` (None: the card), or
        to the first device of `mesh` (data-parallel steps)."""
        self.mesh = check_mesh(mesh)
        if mesh is not None:
            device = mesh.device
        names = _names(params)
        if config.fused_projections or names & {"qkv_proj", "gateup_proj"}:
            raise ValueError(
                "LoRA trains the seven unfused projections: a fused tree "
                "(qkv_proj / gateup_proj) would put LoRA on o_proj and "
                "down_proj alone; pass the unfused tree")
        if config.quantized_weights or "values" in names:
            raise ValueError(
                "LoRA trains float kernels: a quantized tree (values / "
                "scale) has none to train; pass the float tree")
        self.device = resolve_device(device)
        self.config = config
        self.base_params = _tree_to(params, self.device)
        self.rank = rank
        self.alpha = alpha
        self.tokenizer = tokenizer or ByteTokenizer()
        with torch.device("meta"):
            self.model = LlamaDecoder(config)
        self.lora = init_lora(self.base_params, rank=rank, seed=seed)
        for leaf in _leaves(self.lora):
            leaf.requires_grad_(True)
        # the frozen tree on each data shard's device (one per device)
        self._base_on = {self.device: self.base_params}

    def logits(self, lora: Mapping, ids: torch.Tensor,
               mask: torch.Tensor, base: Mapping = None) -> torch.Tensor:
        """(B, S, V) f32 logits of the decoder on the merged tree."""
        base = self.base_params if base is None else base
        merged = merge_lora(base, lora, self.alpha, self.rank)
        state = decoder_params_from_flax(merged)
        return torch.func.functional_call(
            self.model, state, (ids,), {"attention_mask": mask})

    def _nll_sum(self, lora, ids, labels, mask, base=None) -> torch.Tensor:
        """Summed next-token NLL over the response positions."""
        logits = self.logits(lora, ids, mask, base)
        # next-token prediction: logits[t] predicts labels[t+1]
        logits = logits[:, :-1]
        targets = labels[:, 1:]
        valid = targets != -100
        safe_targets = torch.where(valid, targets, 0)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, safe_targets[..., None])[..., 0]
        return torch.sum(nll * valid)

    def loss(self, ids: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
        count = torch.clamp(torch.sum(labels[:, 1:] != -100), min=1)
        return self._nll_sum(self.lora, ids, labels, mask) / count

    def _base(self, device: torch.device) -> Mapping:
        if device not in self._base_on:
            self._base_on[device] = _tree_to(self.base_params, device)
        return self._base_on[device]

    def _backward(self, ids: np.ndarray, labels: np.ndarray,
                  mask: np.ndarray) -> torch.Tensor:
        """The batch's loss, with the LoRA gradients left in .grad: one
        backward on one device, or the data shards' (module docstring)."""
        def tensor(a, dev):
            return torch.as_tensor(a, dtype=torch.long).to(dev)

        dp = 1 if self.mesh is None else self.mesh.shape[DATA_AXIS]
        if dp == 1:
            dev = self.device
            loss = self.loss(tensor(ids, dev), tensor(labels, dev),
                             tensor(mask, dev))
            loss.backward()
            return loss
        leaves = _leaves(self.lora)
        count = max(int((labels[:, 1:] != -100).sum()), 1)
        total, grads = None, None
        for dev, rows in zip(self.mesh.axis_devices(DATA_AXIS),
                             np.array_split(np.arange(ids.shape[0]), dp)):
            if not len(rows):
                continue
            local = [t.detach().to(dev).requires_grad_() for t in leaves]
            loss = self._nll_sum(
                _like(self.lora, local), tensor(ids[rows], dev),
                tensor(labels[rows], dev), tensor(mask[rows], dev),
                self._base(dev)) / count
            g = [gi.to(self.device)
                 for gi in torch.autograd.grad(loss, local)]
            loss = loss.detach().to(self.device)
            total = loss if total is None else total + loss
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        for leaf, g in zip(leaves, grads):
            leaf.grad = g
        return total

    def fit(
        self,
        qa_data: List[Dict],
        epochs: int = 1,
        batch_size: int = 4,
        learning_rate: float = 3e-4,
        max_len: int = 128,
        log_every: int = 4,
    ) -> Dict:
        examples = [
            build_sft_example(
                item["question"], item["answer"], self.tokenizer, max_len
            )
            for item in qa_data
            if item.get("question") and item.get("answer")
        ]
        optimizer = torch.optim.AdamW(
            _leaves(self.lora), lr=learning_rate, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=0.0)

        losses: List[float] = []
        step_count = 0
        for _ in range(epochs):
            for start in range(0, len(examples) - batch_size + 1, batch_size):
                batch = examples[start : start + batch_size]
                # one padded length, as the JAX trainer's recompile bound
                ids, labels, mask = pad_batch(batch)
                pad_to = max_len
                ids = np.pad(ids, ((0, 0), (0, pad_to - ids.shape[1])))
                labels = np.pad(
                    labels,
                    ((0, 0), (0, pad_to - labels.shape[1])),
                    constant_values=-100,
                )
                mask = np.pad(mask, ((0, 0), (0, pad_to - mask.shape[1])))
                # hazard, TF32: the JAX trainer's step is f32 throughout
                with full_f32():
                    optimizer.zero_grad(set_to_none=True)
                    loss = self._backward(ids, labels, mask)
                    optimizer.step()
                if step_count % log_every == 0:
                    losses.append(loss.item())
                step_count += 1
        return {"losses": losses, "steps": step_count}

    def merged_params(self) -> Dict:
        """The effective tree (detached tensors on the trainer's device)."""
        with torch.no_grad(), full_f32():
            return merge_lora(self.base_params, self.lora, self.alpha,
                              self.rank)
