"""Architecture registry of the port.

Lists only the archs the port can serve; the reference registry
(``repro.configs.registry``) lists every fleet arch.  Later slices add
entries as their mixers and FFNs land.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# arch id -> module name
ARCHS = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "glm4-9b": "glm4_9b",
    "qwen3-1.7b": "qwen3_1_7b",
    "smollm-360m": "smollm_360m",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port serves: "
                       f"{sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def list_archs():
    return list(ARCHS)
