"""Run phases 1-4 in sequence.

The counterpart of ``persian_rag_tpu.pipelines.run_all`` (the reference's
scripts/run_all.py imports a nonexistent evaluator; this one chains the
four phases), on `device` (None: the card).
"""
from __future__ import annotations

from typing import Dict, Optional

from persian_rag_tpu_torch.core.config import Config
from persian_rag_tpu_torch.pipelines import phase1, phase2, phase3, phase4


def main(
    config: Optional[Config] = None,
    mesh=None,
    tiny: bool = False,
    device=None,
    **phase4_kwargs,
) -> Dict:
    config = config or Config()
    kw = dict(mesh=mesh, tiny=tiny, device=device)
    results: Dict = {}
    results["phase1"] = phase1.main(config, **kw)
    results["phase2"] = phase2.main(config, **kw)
    results["phase3"] = phase3.main(config, **kw)
    results["phase4"] = phase4.main(config, **kw, **phase4_kwargs)
    return results
