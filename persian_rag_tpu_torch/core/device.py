"""CUDA device discovery.

The port runs its hot path on one NVIDIA GPU. A measurement or a serving
entry point that needs the card calls `require_cuda()`, which raises when
there is none: nothing here falls back to the CPU.
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Dict, List, Union

import numpy as np
import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises RuntimeError when CUDA is unavailable."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point needs an NVIDIA GPU "
            f"(torch {torch.__version__}, built for CUDA {torch.version.cuda})"
        )
    return torch.device("cuda", 0)


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """Where an entry point keeps its tensors: the card unless the caller
    names a device. `None` needs CUDA and raises without it; a caller who
    wants the CPU says `device="cpu"`."""
    if device is None:
        return require_cuda()
    return torch.device(device)


def nvidia_smi_name_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, as the
    tool prints it (a card may run below its maximum power limit, so every
    time kept should stand beside this line)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found on PATH")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def card_info() -> Dict[str, object]:
    """Name, compute capability and the nvidia-smi name/power-limit line."""
    dev = require_cuda()
    major, minor = torch.cuda.get_device_capability(dev)
    return {
        "name": torch.cuda.get_device_name(dev),
        "capability": f"{major}.{minor}",
        "count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi_name_power(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Copy device tensors to the host behind ONE synchronisation."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.cpu().numpy() for t in tensors]
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]
