"""Config registry of the port: ``get_config("--arch id")``.

Counterpart of ``repro/configs/__init__.py``: the paper's four CIFAR CNN
sizes (``cifar_cnn.CONFIGS``) and the ten model-zoo architectures, one
small data module each; the dry runs' input shapes (``INPUT_SHAPES``)
and their stand-ins (``input_specs``, ``shapes_for_arch``).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    AudioStubConfig,
    CNNConfig,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    RunConfig,
    SSMConfig,
    VisionStubConfig,
    reduced_for_smoke,
)

_ARCH_MODULES = {
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "whisper-medium": "whisper_medium",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "hymba-1.5b": "hymba_1_5b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "minicpm-2b": "minicpm_2b",
    "mamba2-370m": "mamba2_370m",
    "yi-6b": "yi_6b",
    "nemotron-4-340b": "nemotron_4_340b",
    "mixtral-8x22b": "mixtral_8x22b",
}

ARCH_IDS = list(_ARCH_MODULES)


def get_config(arch_id: str):
    if arch_id.startswith("cifar_cnn"):
        from repro_torch.configs.cifar_cnn import CONFIGS

        return CONFIGS[arch_id]
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


from repro_torch.configs.input_specs import input_specs, shapes_for_arch  # noqa: E402,F401
