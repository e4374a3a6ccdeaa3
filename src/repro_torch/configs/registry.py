"""Architecture registry of the port: ``--arch <id>`` resolution for every
launcher.

Lists every arch of the reference registry (``repro.configs.registry``),
in its order: the eight fleet archs and the two training configs
(``llama3.2-1b``, ``qwen3-moe-235b-a22b``).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# arch id -> module name
ARCHS = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "qwen3-1.7b": "qwen3_1_7b",
    "llama3.2-1b": "llama3_2_1b",
    "smollm-360m": "smollm_360m",
    "glm4-9b": "glm4_9b",
    "whisper-tiny": "whisper_tiny",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "xlstm-350m": "xlstm_350m",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def list_archs():
    return list(ARCHS)
