"""Sentence-embedding fine-tuning (torch.optim AdamW on the card).

The counterpart of ``persian_rag_tpu.train.trainer``:

* the example policy is the JAX package's, element for element, from the
  same ``random.Random`` streams: (question, answer) pairs at label 1.0,
  (question, context) at 0.8, sampled negatives at 0.0 capped at
  min(n/2, 1000) with collision re-draw, and the 100-positive /
  50-negative eval set;
* the loss is sentence-transformers' CosineSimilarityLoss — the mean of
  (cos(u, v) - label)^2, the norm product clamped at 1e-9;
* the optimizer is AdamW (weight decay 0.01) under the optax
  warmup-then-linear-decay schedule, stepped as optax steps it;
* ``save_model`` / ``load_model`` write and read the JAX package's files
  (``params.msgpack`` in flax's msgpack format, ``config.json``), so a
  model fine-tuned by either package serves from the other.

Chosen divergences: a mid-training checkpoint is ``train_state.pt``
(torch's optimizer state; optax's state tree has no torch counterpart)
beside the same ``train_state.json``; ``save_model`` also writes the
``tokenizer.json`` of an `HFTokenizer` and ``load_model`` reads it back,
where the JAX package loses the tokenizer on reload.

Data parallelism: with an encoder on a mesh (``SentenceEncoder(mesh=)``,
``load_model(mesh=)``) a step splits its batch over the mesh's data axis,
as the JAX trainer's jit with a data-sharded batch does. Each shard runs
its forward and backward on a replica on its device (the first device's
weights, ``torch.func.functional_call``); its loss is weighted by its
share of the batch, so the gradients, summed on the first device in shard
order, are those of the full-batch mean. One AdamW step runs there, and
the replicas copy its weights before their next use.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import shutil
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from persian_rag_tpu_torch.models import flax_msgpack
from persian_rag_tpu_torch.models.convert import (
    encoder_params_from_flax,
    head_params_from_flax,
    params_to_flax,
)
from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
from persian_rag_tpu_torch.ops.flat_topk import full_f32

@dataclasses.dataclass
class InputExample:
    """(texts=[a, b], label) — mirrors sentence_transformers.InputExample."""

    texts: List[str]
    label: float


def warmup_linear(learning_rate: float, warmup_steps: int,
                  total_steps: int) -> Callable[[int], float]:
    """The JAX trainer's rate at update `count` (0-based):
    ``optax.join_schedules([linear(0 -> lr, w), linear(lr -> 0, T - w)],
    [w])`` with w = max(warmup_steps, 1), in optax's float32 arithmetic.

    Hazard, the schedule's step 0: optax scales update c by schedule(c),
    and schedule(0) is 0.0, so the first update moves nothing (Adam's
    moments still take the gradient). At the boundary the second piece
    starts at its own count 0. ``max(warmup, 1)`` and ``max(T - warmup,
    1)`` are the JAX trainer's, as they are."""
    w = max(warmup_steps, 1)
    pieces = ((0.0, learning_rate, w),
              (learning_rate, 0.0, max(total_steps - warmup_steps, 1)))

    def linear(init: float, end: float, steps: int, count: int) -> float:
        count = min(max(count, 0), steps)
        frac = np.float32(1) - np.float32(count) / np.float32(steps)
        return float(np.float32(init - end) * frac + np.float32(end))

    def rate(count: int) -> float:
        if count < w:
            return linear(*pieces[0], count)
        return linear(*pieces[1], count - w)

    return rate


class EmbeddingTrainer:
    def __init__(self, encoder: SentenceEncoder, seed: int = 0):
        self.encoder = encoder
        self.seed = seed

    # -- example construction ---------------------------------------------------

    def prepare_training_data(self, qa_data: List[Dict]) -> List[InputExample]:
        examples: List[InputExample] = []
        for item in qa_data:
            question = item.get("question")
            answer = item.get("answer")
            context = item.get("context", "")
            if not question or not answer:
                continue
            examples.append(InputExample([question, answer], 1.0))
            if context and len(str(context).strip()) > 10:
                examples.append(InputExample([question, str(context)], 0.8))
        examples.extend(self._create_negative_examples(qa_data))
        random.Random(self.seed).shuffle(examples)
        return examples

    def _create_negative_examples(
        self, qa_data: List[Dict], num_negatives: Optional[int] = None
    ) -> List[InputExample]:
        if num_negatives is None:
            num_negatives = min(len(qa_data) // 2, 1000)
        rng = random.Random(self.seed + 1)
        questions = [i["question"] for i in qa_data if i.get("question")]
        answers = [i["answer"] for i in qa_data if i.get("answer")]
        if not questions or not answers:
            return []
        answers_by_question: Dict[str, set] = {}
        for item in qa_data:
            answers_by_question.setdefault(item["question"], set()).add(
                item["answer"]
            )
        negatives = []
        for _ in range(num_negatives):
            question = rng.choice(questions)
            wrong = rng.choice(answers)
            attempts = 0
            while wrong in answers_by_question.get(question, ()) and attempts < 10:
                wrong = rng.choice(answers)
                attempts += 1
            negatives.append(InputExample([question, wrong], 0.0))
        return negatives

    def prepare_evaluation_data(self, test_data: List[Dict]) -> List[InputExample]:
        examples = []
        for item in test_data[:100]:
            if item.get("question") and item.get("answer"):
                examples.append(
                    InputExample([item["question"], item["answer"]], 1.0)
                )
        questions = [i["question"] for i in test_data[:50] if i.get("question")]
        answers = [i["answer"] for i in test_data[:50] if i.get("answer")]
        for i in range(min(50, len(questions))):
            wrong = answers[(i + len(answers) // 2) % len(answers)]
            examples.append(InputExample([questions[i], wrong], 0.0))
        return examples

    # -- training loop ----------------------------------------------------------

    def parameters(self) -> List[torch.nn.Parameter]:
        """Every trained tensor: the encoder's, then the head's."""
        return (list(self.encoder.encoder.parameters())
                + list(self.encoder.head.parameters()))

    def embed(self, input_ids: np.ndarray,
              attention_mask: np.ndarray) -> torch.Tensor:
        """(B, dim) embeddings WITH autograd (`SentenceEncoder.
        forward_tokens` runs under inference mode, whose tensors must never
        reach autograd)."""
        enc = self.encoder
        ids = torch.as_tensor(input_ids, dtype=torch.long).to(enc.device)
        mask = torch.as_tensor(attention_mask, dtype=torch.long).to(enc.device)
        return enc.head(enc.encoder(ids, mask), mask)

    def loss(self, batch: Sequence[InputExample], embed=None) -> torch.Tensor:
        """CosineSimilarityLoss of one batch, as the JAX trainer's loss_fn
        tokenizes and computes it. embed: the (ids, mask) -> embeddings
        function (default `self.embed`)."""
        embed = embed or self.embed
        tok, max_len = self.encoder.tokenizer, self.encoder.max_seq_len
        emb_a = embed(*tok.encode_batch([b.texts[0] for b in batch], max_len))
        emb_b = embed(*tok.encode_batch([b.texts[1] for b in batch], max_len))
        labels = torch.tensor([b.label for b in batch], dtype=torch.float32,
                              device=emb_a.device)
        na = torch.linalg.norm(emb_a, dim=1)
        nb = torch.linalg.norm(emb_b, dim=1)
        cos = torch.sum(emb_a * emb_b, dim=1) / torch.clamp(na * nb, min=1e-9)
        return torch.mean((cos - labels) ** 2)

    def _backward(self, batch: Sequence[InputExample]) -> torch.Tensor:
        """The batch's loss, with its gradients left in the parameters'
        .grad: one backward on one device, or the data-parallel shards'
        weighted gradients summed in shard order (module docstring)."""
        enc = self.encoder
        if enc.data_parallel == 1:
            loss = self.loss(batch)
            loss.backward()
            return loss
        e_names = [n for n, _ in enc.encoder.named_parameters()]
        h_names = [n for n, _ in enc.head.named_parameters()]
        params = self.parameters()  # the encoder's, then the head's
        total, grads = None, None
        for dev, idx in zip(enc.data_devices(), np.array_split(
                np.arange(len(batch)), enc.data_parallel)):
            if not len(idx):
                continue
            encoder, head = enc.replica(dev)
            local = [p.detach().to(dev).requires_grad_() for p in params]
            e_state = dict(zip(e_names, local[:len(e_names)]))
            h_state = dict(zip(h_names, local[len(e_names):]))

            def embed(ids, mask, dev=dev, encoder=encoder, head=head,
                      e_state=e_state, h_state=h_state):
                ids = torch.as_tensor(ids, dtype=torch.long).to(dev)
                mask = torch.as_tensor(mask, dtype=torch.long).to(dev)
                hidden = torch.func.functional_call(encoder, e_state,
                                                    (ids, mask))
                return torch.func.functional_call(head, h_state,
                                                  (hidden, mask))

            loss = self.loss([batch[i] for i in idx], embed) * (
                len(idx) / len(batch))
            g = torch.autograd.grad(loss, local, allow_unused=True)
            g = [torch.zeros_like(t) if gi is None else gi
                 for gi, t in zip(g, local)]
            loss = loss.detach().to(enc.device)
            g = [gi.to(enc.device) for gi in g]
            total = loss if total is None else total + loss
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        for p, g in zip(params, grads):
            p.grad = g
        return total

    def make_optimizer(self, learning_rate: float, warmup_steps: int,
                       total_steps: int):
        """(AdamW, LambdaLR) equal to ``optax.adamw(schedule,
        weight_decay=0.01)``.

        Hazard, AdamW's decay: optax scales the decay by the scheduled
        rate and applies it to every leaf — biases, LayerNorm scales and
        the whole embedding table — and so does torch's AdamW over every
        parameter with a gradient (`train_step` gives each one). Both take
        m_hat / (sqrt(v_hat) + 1e-8) with betas (0.9, 0.999) and bias
        correction from their own step count; amsgrad stays off.

        Hazard, the embedding's gradient: JAX's is dense (a scatter-add into
        zeros), and so is nn.Embedding's without padding_idx and without
        sparse=True (the encoder sets neither): the pad row and every row
        no batch holds take a zero gradient, so their moments and decay
        follow JAX's."""
        optimizer = torch.optim.AdamW(
            self.parameters(), lr=learning_rate, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=0.01, amsgrad=False)
        rate = warmup_linear(learning_rate, warmup_steps, total_steps)
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            optimizer,
            lambda count: rate(count) / learning_rate if learning_rate else 0.0)
        return optimizer, scheduler

    def train_step(self, optimizer, scheduler,
                   batch: Sequence[InputExample]) -> torch.Tensor:
        """One update: loss, gradients, AdamW at this step's rate, then the
        scheduler (optimizer.step() before scheduler.step(), so update c
        takes rate(c)). The loss stays on the device.

        Hazard, TF32: the JAX trainer runs in f32, so the step runs under
        `full_f32` and the card's step can be held to the CPU's."""
        with full_f32():
            optimizer.zero_grad(set_to_none=False)
            loss = self._backward(batch)
            for p in self.parameters():
                # a parameter outside the graph still decays, as every
                # optax leaf does
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            optimizer.step()
        scheduler.step()
        self.encoder.mark_replicas_stale()
        return loss.detach()

    def save_checkpoint(self, directory: str, optimizer, scheduler,
                        step: int) -> None:
        """Mid-training checkpoint: parameters, optimizer and schedule
        state (``train_state.pt``) and the step (``train_state.json``)."""
        os.makedirs(directory, exist_ok=True)
        torch.save({
            "encoder": self.encoder.encoder.state_dict(),
            "head": self.encoder.head.state_dict(),
            "optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict(),
        }, os.path.join(directory, "train_state.pt"))
        with open(os.path.join(directory, "train_state.json"), "w") as f:
            json.dump({"step": step}, f)

    def _load_checkpoint(self, directory: str, optimizer, scheduler) -> int:
        path = os.path.join(directory, "train_state.pt")
        if not os.path.exists(path):
            return 0
        state = torch.load(path, map_location=self.encoder.device,
                           weights_only=True)
        self.encoder.encoder.load_state_dict(state["encoder"])
        self.encoder.head.load_state_dict(state["head"])
        optimizer.load_state_dict(state["optimizer"])
        scheduler.load_state_dict(state["scheduler"])
        with open(os.path.join(directory, "train_state.json")) as f:
            return json.load(f)["step"]

    def fine_tune(
        self,
        train_examples: Sequence[InputExample],
        eval_examples: Optional[Sequence[InputExample]] = None,
        epochs: int = 1,
        batch_size: int = 16,
        warmup_steps: int = 50,
        learning_rate: float = 2e-5,
        output_path: Optional[str] = None,
        log_every: int = 100,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        resume: bool = False,
    ) -> Dict:
        """Returns a summary dict (losses, throughput, save path)."""
        n = len(train_examples)
        steps_per_epoch = max(1, n // batch_size)
        total_steps = steps_per_epoch * epochs
        optimizer, scheduler = self.make_optimizer(
            learning_rate, warmup_steps, total_steps)
        start_step = 0
        if resume and checkpoint_dir:
            start_step = self._load_checkpoint(
                checkpoint_dir, optimizer, scheduler)

        rng = random.Random(self.seed + 2)
        order = list(range(n))
        losses: List[float] = []
        t_start = time.time()
        samples_seen = 0
        global_step = 0
        for epoch in range(epochs):
            rng.shuffle(order)
            for step in range(steps_per_epoch):
                global_step += 1
                if global_step <= start_step:
                    continue  # fast-forward to the resume point
                idx = order[step * batch_size : (step + 1) * batch_size]
                if len(idx) < batch_size:  # the JAX trainer's static shapes
                    idx = idx + order[: batch_size - len(idx)]
                batch = [train_examples[i] for i in idx]
                loss = self.train_step(optimizer, scheduler, batch)
                samples_seen += batch_size
                if step % log_every == 0:
                    losses.append(float(loss))
                if (
                    checkpoint_dir
                    and checkpoint_every
                    and global_step % checkpoint_every == 0
                ):
                    self.save_checkpoint(
                        checkpoint_dir, optimizer, scheduler, global_step
                    )
        if self.encoder.device.type == "cuda":
            torch.cuda.synchronize(self.encoder.device)
        elapsed = time.time() - t_start

        summary = {
            "losses": losses,
            "final_loss": losses[-1] if losses else None,
            "train_samples": n,
            "epochs": epochs,
            "batch_size": batch_size,
            "training_time_s": elapsed,
            "samples_per_second": samples_seen / max(elapsed, 1e-9),
        }
        if eval_examples:
            summary["eval_spearman_proxy"] = self.evaluate(eval_examples)
        if output_path:
            self.save_model(output_path)
            summary["model_path"] = output_path
        return summary

    def evaluate(self, eval_examples: Sequence[InputExample]) -> float:
        """Mean |cos - label| agreement proxy on the eval pairs."""
        a = self.encoder.encode([e.texts[0] for e in eval_examples])
        b = self.encoder.encode([e.texts[1] for e in eval_examples])
        labels = np.array([e.label for e in eval_examples])
        denom = np.maximum(
            np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-9
        )
        cos = (a * b).sum(1) / denom
        return float(1.0 - np.mean(np.abs(cos - labels)))

    # -- persistence --------------------------------------------------------------

    def save_model(self, path: str) -> None:
        """``params.msgpack`` (the tree {"encoder", "head"} in flax's
        format and key order) and ``config.json`` as the JAX package
        writes them, and the tokenizer.json of an HFTokenizer."""
        enc = self.encoder
        os.makedirs(path, exist_ok=True)
        flax_msgpack.save(os.path.join(path, "params.msgpack"), {
            "encoder": params_to_flax(enc.encoder),
            "head": params_to_flax(enc.head),
        })
        projection = enc.head.projection
        meta = {
            "encoder_config": dataclasses.asdict(enc.config),
            "pooling": enc.head.pooling,
            "projection_dim": projection.out_features if projection else None,
            "normalize": enc.head.normalize,
            "max_seq_len": enc.max_seq_len,
        }
        with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
            json.dump(meta, f, indent=2)
        # the JAX package writes no tokenizer, so a model fine-tuned from a
        # sentence-transformers directory reloads with the hash tokenizer's
        # ids; the port keeps the model's tokenizer.json beside it
        source = getattr(enc.tokenizer, "path", None)
        target = os.path.join(path, "tokenizer.json")
        if source and not (os.path.exists(target)
                           and os.path.samefile(source, target)):
            shutil.copyfile(source, target)

    @staticmethod
    def load_model(path: str, tokenizer=None, mesh=None,
                   device=None) -> SentenceEncoder:
        """A directory written by `save_model` of either package, on
        `device` (None: the card), or on `mesh` (data-parallel, its first
        device). Without `tokenizer`, a tokenizer.json in the directory
        becomes an HFTokenizer, else the hash tokenizer."""
        from persian_rag_tpu_torch.models.encoder import EncoderConfig
        from persian_rag_tpu_torch.models.tokenizer import HFTokenizer

        with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
            meta = json.load(f)
        config = EncoderConfig(**meta["encoder_config"])
        if tokenizer is None and os.path.exists(
                os.path.join(path, "tokenizer.json")):
            tokenizer = HFTokenizer(path)
        tree = flax_msgpack.load(os.path.join(path, "params.msgpack"))
        return SentenceEncoder(
            config,
            state_dict=encoder_params_from_flax(tree["encoder"]),
            pooling=meta.get("pooling", "mean"),
            projection_dim=meta.get("projection_dim"),
            normalize=meta.get("normalize", False),
            head_state_dict=head_params_from_flax(tree["head"]),
            tokenizer=tokenizer,
            max_seq_len=meta.get("max_seq_len", 128),
            device=device,
            mesh=mesh,
        )

    # -- reference-compatible helpers ---------------------------------------------

    def encode_texts(self, texts: Sequence[str], batch_size: int = 32) -> np.ndarray:
        return self.encoder.encode(texts, batch_size=batch_size)

    def get_similarity(self, text1: str, text2: str) -> float:
        return self.encoder.similarity(text1, text2)
