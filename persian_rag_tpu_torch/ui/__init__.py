from persian_rag_tpu_torch.ui.app import DrugRAGSystem, launch

__all__ = ["DrugRAGSystem", "launch"]
