from persian_rag_tpu_torch.data.loader import DataLoader

__all__ = ["DataLoader"]
