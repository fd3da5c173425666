"""The parallel layer: corpus-sharded search, tensor parallelism."""
from persian_rag_tpu_torch.parallel.sharded_search import (
    shard_corpus,
    sharded_flat_topk,
)

__all__ = ["shard_corpus", "sharded_flat_topk"]
