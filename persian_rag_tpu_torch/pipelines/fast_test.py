"""The system status of ``persian_rag_tpu.pipelines.fast_test``.

`show_system_status` reports which processed artifacts exist and what the
generation server at ``generation.server_url`` answers. The interactive
menu and the smoke checks of the JAX module are not ported yet (ROADMAP
queue 1 item 6).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from persian_rag_tpu_torch.core.config import Config
from persian_rag_tpu_torch.gen.client import LlamaClient


def show_system_status(config: Optional[Config] = None) -> Dict:
    config = config or Config()
    processed = config.paths.processed_dir
    artifacts = {
        name: os.path.exists(os.path.join(processed, name))
        for name in (
            "train_data.csv",
            "test_data.csv",
            "drugs_word_chunks.csv",
            "drugs_sentence_chunks.csv",
        )
    }
    client = LlamaClient(config.generation.server_url)
    return {
        "artifacts": artifacts,
        "server": client.get_server_info(),
    }
