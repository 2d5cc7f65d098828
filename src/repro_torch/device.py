"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"`` and raise when no CUDA device
exists; the CPU is used only when a caller asks for it explicitly (the
tests do).  Nothing here falls back silently.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is missing.
    Cached: the kernels' wrappers call it on every launch."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether ``a`` and ``b`` name one device: a CUDA device without an
    index is the current one, and the CPU is one device."""
    def key(d):
        if d.type != "cuda":
            return d.type, None
        return d.type, torch.cuda.current_device() if d.index is None \
            else d.index
    return key(a) == key(b)


def check_on(dev: torch.device, **tensors) -> None:
    """Raise unless every named tensor lies on ``dev`` (type and index)."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device.type != dev.type or (
                dev.index is not None and t.device.index != dev.index):
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
