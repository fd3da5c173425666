from persian_rag_tpu_torch.gen.client import LlamaClient

__all__ = ["LlamaClient"]
