"""Assigned-architecture registry: ``get_config(arch)`` / ``get_smoke(arch)``.

Each ``<id>.py`` holds the exact published configuration (sources in the
module docstrings) plus a ``smoke()`` reduction of the same family used by
the CPU tests.
"""

from __future__ import annotations

import importlib

from .base import ModelConfig, ShapeConfig, SHAPES  # noqa: F401

ARCHS = [
    "mixtral_8x7b",
    "grok_1_314b",
    "h2o_danube_1_8b",
    "nemotron_4_340b",
    "gemma2_2b",
    "gemma3_1b",
    "chameleon_34b",
    "hymba_1_5b",
    "whisper_small",
    "xlstm_350m",
]

def _canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    arch = _canon(arch)
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return importlib.import_module(f"{__name__}.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke()
