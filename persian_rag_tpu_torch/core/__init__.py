"""Configuration, device discovery and the device mesh of the port."""
from persian_rag_tpu_torch.core.config import Config, load_config
from persian_rag_tpu_torch.core.mesh import (
    MeshSpec,
    build_mesh,
    corpus_sharding,
    replicated_sharding,
)

__all__ = [
    "Config",
    "load_config",
    "MeshSpec",
    "build_mesh",
    "corpus_sharding",
    "replicated_sharding",
]
