"""Shared pipeline plumbing: encoder construction and artifact paths.

The counterpart of ``persian_rag_tpu.pipelines.common``. A fine-tuned
directory (``<models_dir>/<name>_finetuned/params.msgpack``, written by
either package's `EmbeddingTrainer.save_model`) loads through
`EmbeddingTrainer.load_model`, as in the JAX package. Two chosen
divergences in `build_encoder`:

* a candidate directory (the name itself, or ``<models_dir>/<name>``)
  that holds ``params.msgpack`` loads as a fine-tuned model too, where the
  JAX package tries it as a sentence-transformers directory;
* a local sentence-transformers directory that fails to load raises,
  where the JAX package swallows the failure and serves a random preset.
"""
from __future__ import annotations

import os
from typing import Optional

from persian_rag_tpu_torch.core.config import Config
from persian_rag_tpu_torch.models.encoder import EncoderConfig
from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
from persian_rag_tpu_torch.train.trainer import EmbeddingTrainer

# Architecture presets for the three reference models (config.yaml:2-5),
# used when no local checkpoint exists: the encoder has the exact
# architecture and pooling head, randomly initialized, with the hashing
# tokenizer.
PRESETS = {
    "sentence-transformers/paraphrase-multilingual-MiniLM-L12-v2": dict(
        config=EncoderConfig.minilm_l12, pooling="mean",
        projection_dim=None, normalize=False,
    ),
    "sentence-transformers/distiluse-base-multilingual-cased-v2": dict(
        config=EncoderConfig.distilbert_base, pooling="mean",
        projection_dim=512, normalize=False,
    ),
    "intfloat/multilingual-e5-base": dict(
        config=EncoderConfig.xlmr_base, pooling="mean",
        projection_dim=None, normalize=True,
        query_prefix="query: ", passage_prefix="passage: ",
    ),
}


def prefixes_for(model_name: str) -> dict:
    """e5-style instruction prefixes for models that need them."""
    preset = PRESETS.get(model_name, {})
    return {
        "query_prefix": preset.get("query_prefix", ""),
        "passage_prefix": preset.get("passage_prefix", ""),
    }


# A small architecture for smoke runs (the full presets are 100M+ params).
TINY_PRESET = EncoderConfig(
    vocab_size=4096, hidden_size=64, num_layers=2, num_heads=4,
    intermediate_size=128, max_position_embeddings=128,
)


def short_name(model_name: str) -> str:
    return model_name.split("/")[-1]


def build_encoder(
    model_name: str,
    config: Optional[Config] = None,
    mesh=None,
    tiny: bool = False,
    seed: int = 0,
    device=None,
) -> SentenceEncoder:
    """Resolve a model name to a SentenceEncoder on `device` (None: the
    card), or data-parallel over `mesh` (its first device).

    Priority: a fine-tuned directory (``params.msgpack``) -> a local
    sentence-transformers directory (raises if it fails to load) -> the
    tiny smoke config (`tiny`, or a name with no preset) -> the
    architecture preset (random weights from `seed`).
    """
    where = dict(device=device, mesh=mesh)
    models_dir = (config or Config()).paths.models_dir
    native_dir = os.path.join(models_dir, short_name(model_name) + "_finetuned")
    candidates = (model_name, os.path.join(models_dir, short_name(model_name)))
    for directory in (native_dir,) + candidates:
        if os.path.exists(os.path.join(directory, "params.msgpack")):
            return EmbeddingTrainer.load_model(directory, **where)
    for candidate in candidates:
        if os.path.isdir(candidate) and os.path.exists(
            os.path.join(candidate, "config.json")
        ):
            return SentenceEncoder.from_pretrained(candidate, **where)
    preset = PRESETS.get(model_name)
    if tiny or preset is None:
        return SentenceEncoder(TINY_PRESET, seed=seed, max_seq_len=64,
                               **where)
    return SentenceEncoder(
        preset["config"](),
        pooling=preset["pooling"],
        projection_dim=preset["projection_dim"],
        normalize=preset["normalize"],
        seed=seed,
        **where,
    )
