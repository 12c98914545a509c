"""Model configurations for the port's kernels (no JAX).

Holds the fields of ``repro.configs.base.ModelConfig`` that the real-mode
path needs to size its kernel launches, the ``qwen2.5-14b`` entry, and
``reduced()`` for the CPU tests, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def reduced(self) -> "ModelConfig":
        """The reference's reduced config for CPU smoke tests (dense)."""
        return replace(self, num_layers=2, d_model=64, num_heads=4,
                       num_kv_heads=min(self.num_kv_heads, 2), d_ff=128,
                       head_dim=16, vocab_size=256)


def _qwen25_14b() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=13824,
        vocab_size=152064,
        source="hf:Qwen/Qwen2.5-0.5B (family card)",
    )


REGISTRY: Dict[str, Callable[[], ModelConfig]] = {"qwen2.5-14b": _qwen25_14b}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]()
