from persian_rag_tpu_torch.text.persian import PersianTextProcessor
from persian_rag_tpu_torch.text.chunking import TextChunker

__all__ = ["PersianTextProcessor", "TextChunker"]
