from persian_rag_tpu_torch.train.trainer import EmbeddingTrainer, InputExample

__all__ = ["EmbeddingTrainer", "InputExample"]
