"""Architecture registry of the port: ``get_config(arch)`` plus shape
specs (counterpart of ``repro/configs/__init__.py``).

Ten architectures, each a module with its published ``CONFIG``, a
reduced ``SMOKE`` config and the four input shapes (train_4k /
prefill_32k / decode_32k / long_500k), with the reference's skip reason
where a shape does not apply to the family.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.lm import LMConfig
from .common import ShapeSpec, SkipSpec, input_specs  # noqa: F401

ARCH_MODULES: Dict[str, str] = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "arctic-480b": "arctic_480b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "gemma-2b": "gemma_2b",
    "gemma3-1b": "gemma3_1b",
    "yi-34b": "yi_34b",
    "minicpm3-4b": "minicpm3_4b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "hubert-xlarge": "hubert_xlarge",
}

ARCHS: List[str] = list(ARCH_MODULES)


def _module(arch: str):
    if arch not in ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {', '.join(ARCHS)}")
    return importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[arch]}")


def get_config(arch: str) -> LMConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> LMConfig:
    return _module(arch).SMOKE


def get_shapes(arch: str) -> Dict[str, object]:
    return _module(arch).SHAPES


def iter_cells():
    """Yield every (arch, shape_name, ShapeSpec | SkipSpec): 40 cells."""
    for arch in ARCHS:
        for shape_name, spec in get_shapes(arch).items():
            yield arch, shape_name, spec
