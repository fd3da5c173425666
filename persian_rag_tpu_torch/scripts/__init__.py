"""Measurement entry points of the port, run as ``python -m
persian_rag_tpu_torch.scripts.<name>``."""
