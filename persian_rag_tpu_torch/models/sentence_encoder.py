"""High-level sentence encoder: tokenize -> forward -> pooled vectors.

The counterpart of ``persian_rag_tpu.models.sentence_encoder``. `encode`
keeps the JAX package's batching: fixed-size batches, the last one padded
with empty strings, the result returned as a host (N, dim) float32 array.
`encode_device` returns the embeddings of one batch as a tensor on the
encoder's device, so that a search can consume them with no host round
trip — the port's counterpart of the JAX package's fused encode+search
step. `encode_robust` keeps the JAX package's failure chain (full batch,
then item by item on the same device, then zero vectors, counted).

With a `mesh` (``core.mesh``) encoding is data-parallel over the mesh's
data axis, as the JAX package's jit with a data-sharded batch is: a batch
is rounded to a multiple of the axis (padded with empty strings), shard j
runs on a replica of the model on the axis's j-th device, and the shards
are concatenated in order on the mesh's first device, the encoder's.
Replicas copy the first device's weights, again after a training step
has changed them (`mark_replicas_stale`).
"""
from __future__ import annotations

import copy
import logging
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from persian_rag_tpu_torch.core.device import resolve_device
from persian_rag_tpu_torch.core.mesh import DATA_AXIS, check_mesh
from persian_rag_tpu_torch.models.encoder import (
    EncoderConfig,
    TransformerEncoder,
    init_encoder_,
)
from persian_rag_tpu_torch.models.pooling import PoolingHead
from persian_rag_tpu_torch.models.tokenizer import (
    HashTokenizer,
    HFTokenizer,
    TokenizerBase,
)

log = logging.getLogger(__name__)


class SentenceEncoder:
    def __init__(
        self,
        config: EncoderConfig,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        pooling: str = "mean",
        projection_dim: Optional[int] = None,
        normalize: bool = False,
        head_state_dict: Optional[Dict[str, torch.Tensor]] = None,
        tokenizer: Optional[TokenizerBase] = None,
        max_seq_len: int = 128,
        device: Union[str, torch.device, None] = None,
        seed: int = 0,
        mesh=None,
    ):
        """state_dict / head_state_dict: converted weights
        (`models/convert.py`); None draws seeded random weights from a
        CPU `torch.Generator` (seed for the encoder, seed+1 for the
        head), so a seed gives the same model on every device. device:
        None is the card (raises without CUDA); "cpu" asks for the CPU.
        mesh: encode data-parallel over the mesh's data axis (its first
        device is then the encoder's)."""
        self.config = config
        self.max_seq_len = max_seq_len
        self.mesh = check_mesh(mesh)
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        # data-parallel replicas on the mesh's other devices
        self._replicas: Dict[torch.device, Tuple] = {}
        self.tokenizer = tokenizer or HashTokenizer(config.vocab_size)
        self.dim = projection_dim or config.hidden_size

        self.encoder = TransformerEncoder(config)
        if state_dict is None:
            init_encoder_(self.encoder, torch.Generator().manual_seed(seed))
        else:
            self.encoder.load_state_dict(state_dict)
        self.head = PoolingHead(
            config.hidden_size,
            pooling=pooling,
            projection_dim=projection_dim,
            normalize=normalize,
        )
        if head_state_dict is None:
            init_encoder_(self.head, torch.Generator().manual_seed(seed + 1))
        else:
            self.head.load_state_dict(head_state_dict)
        self.encoder.to(self.device).eval()
        self.head.to(self.device).eval()

    # -- loading ------------------------------------------------------------

    @classmethod
    def from_pretrained(
        cls,
        model_dir: str,
        tokenizer: Optional[TokenizerBase] = None,
        **kwargs,
    ) -> "SentenceEncoder":
        """Load a local sentence-transformers model directory
        (`models/hf_loader.py`). Its ``tokenizer.json`` becomes an
        `HFTokenizer`; a file that does not parse raises. A directory with
        none keeps the HashTokenizer, with a warning."""
        from persian_rag_tpu_torch.models.convert import (
            encoder_params_from_flax,
            head_params_from_flax,
        )
        from persian_rag_tpu_torch.models.hf_loader import (
            load_sentence_transformer,
        )

        config, params, pooling = load_sentence_transformer(model_dir)
        if tokenizer is None:
            if os.path.exists(os.path.join(model_dir, "tokenizer.json")):
                tokenizer = HFTokenizer(model_dir)
            else:
                log.warning("%s has no tokenizer.json: encoding with the "
                            "HashTokenizer, whose ids are not the model's",
                            model_dir)
                tokenizer = HashTokenizer(config.vocab_size)
        head = pooling.get("projection_params")
        return cls(
            config,
            state_dict=encoder_params_from_flax(params),
            pooling=pooling["pooling"],
            projection_dim=pooling.get("projection_dim"),
            normalize=pooling.get("normalize", False),
            head_state_dict=head_params_from_flax(head) if head else {},
            tokenizer=tokenizer,
            **kwargs,
        )

    # -- data-parallel replicas ----------------------------------------------

    @property
    def data_parallel(self) -> int:
        """The data axis of the mesh (1 without one)."""
        return 1 if self.mesh is None else self.mesh.shape[DATA_AXIS]

    def data_devices(self):
        """The device of each data shard (the encoder's alone without a
        mesh)."""
        if self.mesh is None:
            return [self.device]
        return self.mesh.axis_devices(DATA_AXIS)

    def mark_replicas_stale(self) -> None:
        """The first device's weights changed: replicas copy them again
        before their next use."""
        self._replicas.clear()

    def replica(self, device: torch.device) -> Tuple:
        """(encoder, head) modules on `device`: the encoder's own on its
        device, else a copy of its current weights."""
        if device == self.device:
            return self.encoder, self.head
        if device not in self._replicas:
            # built outside inference mode: a training step reuses them
            with torch.inference_mode(False), torch.no_grad():
                self._replicas[device] = (
                    copy.deepcopy(self.encoder).to(device).eval(),
                    copy.deepcopy(self.head).to(device).eval())
        return self._replicas[device]

    # -- forward ------------------------------------------------------------

    @torch.inference_mode()
    def forward_tokens(
        self, input_ids: np.ndarray, attention_mask: np.ndarray
    ) -> torch.Tensor:
        """(B, L) host token ids and mask -> (B, dim) float32 embeddings
        on the encoder's device. On a mesh, B must be a multiple of the
        data axis: shard j runs on the axis's j-th device."""
        ids = torch.as_tensor(input_ids, dtype=torch.long)
        mask = torch.as_tensor(attention_mask, dtype=torch.long)
        dp = self.data_parallel
        if ids.shape[0] % dp:
            raise ValueError(f"a batch of {ids.shape[0]} does not split over "
                             f"a data axis of {dp}")
        out = []
        for dev, ids_j, mask_j in zip(self.data_devices(),
                                      torch.chunk(ids, dp),
                                      torch.chunk(mask, dp)):
            encoder, head = self.replica(dev)
            ids_j = ids_j.to(dev, non_blocking=True)
            mask_j = mask_j.to(dev, non_blocking=True)
            out.append(head(encoder(ids_j, mask_j), mask_j).to(
                self.device, non_blocking=True))
        return out[0] if dp == 1 else torch.cat(out)

    def encode_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Embeddings of `texts` as ONE batch, left on the device (on a
        mesh the batch is padded with empty strings to a multiple of the
        data axis, and the pad rows are cut off again)."""
        texts = list(texts)
        real = len(texts)
        texts += [""] * (-real % self.data_parallel)
        ids, mask = self.tokenizer.encode_batch(texts, self.max_seq_len)
        return self.forward_tokens(ids, mask)[:real]

    def encode(
        self, texts: Sequence[str], batch_size: int = 32
    ) -> np.ndarray:
        """Encode a list of texts to an (N, dim) float32 host matrix."""
        if isinstance(texts, str):
            texts = [texts]
        n = len(texts)
        if n == 0:
            return np.zeros((0, self.dim), np.float32)
        dp = self.data_parallel
        batch_size = max(batch_size, dp)
        batch_size -= batch_size % dp  # the JAX package's rounding
        out = np.zeros((n, self.dim), np.float32)
        for start in range(0, n, batch_size):
            chunk = list(texts[start : start + batch_size])
            real = len(chunk)
            if real < batch_size:
                chunk = chunk + [""] * (batch_size - real)  # fixed batch shape
            emb = self.encode_device(chunk)
            out[start : start + real] = emb[:real].cpu().numpy()
        return out

    def encode_robust(
        self, texts: Sequence[str], batch_size: int = 32
    ) -> Tuple[np.ndarray, Dict[str, int]]:
        """Encode with a failure-fallback chain: the full batch, then one
        item at a time on the same device, then a zero vector for an item
        that still fails. It never moves to the CPU. Returns (embeddings,
        {"failed": items left zero, "fallback_items": items encoded one at
        a time})."""
        stats = {"failed": 0, "fallback_items": 0}
        try:
            return self.encode(texts, batch_size=batch_size), stats
        except Exception:
            log.warning("batch encode failed; encoding %d items one at a "
                        "time", len(texts), exc_info=True)
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, text in enumerate(texts):
            try:
                out[i] = self.encode([text])[0]
                stats["fallback_items"] += 1
            except Exception:
                stats["failed"] += 1  # leave the zero vector
        return out, stats

    def similarity(self, text1: str, text2: str) -> float:
        """Cosine similarity between two texts."""
        emb = self.encode([text1, text2])
        a, b = emb[0], emb[1]
        denom = max(float(np.linalg.norm(a) * np.linalg.norm(b)), 1e-12)
        return float(a @ b / denom)
