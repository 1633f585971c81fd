"""Architecture registry of the port: only the architectures ported so far."""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs import (arctic_480b, gemma2_2b, gemma3_1b, granite_20b,
                                 mistral_nemo_12b, paligemma_3b, qwen2_moe_a2_7b, rwkv6_3b,
                                 whisper_base, zamba2_7b)
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "mistral-nemo-12b": mistral_nemo_12b,
    "granite-20b": granite_20b,
    "gemma2-2b": gemma2_2b,
    "gemma3-1b": gemma3_1b,
    "arctic-480b": arctic_480b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "zamba2-7b": zamba2_7b,
    "rwkv6-3b": rwkv6_3b,
    "paligemma-3b": paligemma_3b,
    "whisper-base": whisper_base,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_MODULES)}")
    return _MODULES[arch].CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _MODULES[arch].reduced()


def all_configs() -> Dict[str, ModelConfig]:
    return {k: m.CONFIG for k, m in _MODULES.items()}


def all_cells() -> List[Tuple[str, str, bool, str]]:
    """Every (arch, shape) cell of the dry run's shapes with its
    supported/skip status: (arch, shape, ok, reason)."""
    from repro_torch.launch.dryrun import SHAPES, shape_supported
    out = []
    for arch, mod in _MODULES.items():
        for shape in SHAPES:
            ok, reason = shape_supported(mod.CONFIG, shape)
            out.append((arch, shape, ok, reason))
    return out


__all__ = ["ARCH_IDS", "get_config", "get_reduced", "all_configs", "all_cells"]
