"""PyTorch/CUDA port of the IOLM-DB reproduction (see ROADMAP.md).

Mirrors the reference package's subpackages; imports ``torch`` and
nothing of the JAX package."""
