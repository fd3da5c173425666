from persian_rag_tpu_torch.utils.timing import Timer, timed, trace

__all__ = ["Timer", "timed", "trace"]
