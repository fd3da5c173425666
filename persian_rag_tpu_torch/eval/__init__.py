from persian_rag_tpu_torch.eval.metrics import TextMetrics
from persian_rag_tpu_torch.eval.evaluator import RAGEvaluator

__all__ = ["TextMetrics", "RAGEvaluator"]
