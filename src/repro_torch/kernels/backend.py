"""KernelBackend and device resolution of the port.

A backend names which implementation of the compute hot-spots runs:

``"reference"``   plain PyTorch paths (the numerical oracle)
``"cuda"``        the hand-written Hopper kernels (``kernels/csrc``)
``"auto"``        resolve from the device the tensors live on: ``"cuda"``
                  on a CUDA device, ``"reference"`` on the CPU

Entry points take an explicit ``device`` that defaults to ``"cuda"``;
asking for a CUDA device where there is none raises (:func:`resolve_device`)
instead of continuing on the CPU.
"""
from __future__ import annotations

import torch

BACKENDS = ("reference", "cuda", "auto")


def normalize_backend(backend) -> str:
    """Validate and canonicalize a backend name (``None`` -> ``"auto"``)."""
    if backend is None:
        return "auto"
    b = str(backend).lower()
    if b not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {backend!r}; expected one of {BACKENDS}")
    return b


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def resolve_backend(backend="auto", device="cuda") -> str:
    """Resolve to a concrete backend (``"reference"`` or ``"cuda"``) for
    tensors on ``device``."""
    b = normalize_backend(backend)
    if b == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "reference"
    return b
