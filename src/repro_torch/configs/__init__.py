"""Model configurations of the port (``ModelConfig`` + ported archs)."""
from repro_torch.configs.base import ModelConfig, from_reference

__all__ = ["ModelConfig", "from_reference"]
