"""Logging setup.

The counterpart of ``persian_rag_tpu.utils.logging``: one call configures a
namespaced logger writing to the console and to ``logs/<name>.log``, and
quiets noisy third-party loggers (``torch`` where the JAX package quiets
``jax``).
"""
from __future__ import annotations

import logging
import os
from typing import Optional

_NOISY = ("torch", "transformers", "urllib3", "filelock", "fsspec")


def setup_logging(
    name: str = "persian_rag_tpu_torch",
    log_dir: Optional[str] = "logs",
    level: int = logging.INFO,
    quiet_third_party: bool = True,
) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:  # idempotent
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S"
    )
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    logger.addHandler(console)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        file_handler = logging.FileHandler(
            os.path.join(log_dir, f"{name.split('.')[-1]}.log"),
            encoding="utf-8",
        )
        file_handler.setFormatter(fmt)
        logger.addHandler(file_handler)
    if quiet_third_party:
        for noisy in _NOISY:
            logging.getLogger(noisy).setLevel(logging.ERROR)
    return logger


def get_logger(name: str = "persian_rag_tpu_torch") -> logging.Logger:
    return logging.getLogger(name)
