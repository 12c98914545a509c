"""Config system: model architecture configs (the port's copy of
``repro.configs.base``, with torch dtypes).

Every architecture is a ``ModelConfig`` produced by one module in this
package and registered in ``REGISTRY``. ``kv_cache_specs`` gives the
serving cache as ``(shape, dtype)`` pairs; ``input_specs`` gives a step's
inputs as meta tensors, the port's stand-in for ``jax.ShapeDtypeStruct``
(a shape and a dtype, no storage).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config."""

    num_experts: int
    experts_per_token: int
    d_ff: int                      # per-expert hidden width
    dense_residual_d_ff: int = 0   # arctic-style parallel dense FFN (0 = none)
    every: int = 1                 # MoE every `every` layers (others dense)
    aux_loss_weight: float = 0.01
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block config."""

    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_kernel: int = 4
    chunk_size: int = 256

    def num_heads(self, d_model: int) -> int:
        return (self.expand * d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """Jamba-style attention/Mamba interleave."""

    attn_every: int = 8            # 1 attention layer per `attn_every` layers
    attn_offset: int = 4           # which slot in the period is attention


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 131_072
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # --- audio (whisper): encoder layers + precomputed frame embeddings ----
    encoder_layers: int = 0
    num_audio_frames: int = 1500
    # --- vlm (qwen2-vl): M-RoPE sections over (t, h, w) --------------------
    mrope_sections: Optional[Tuple[int, int, int]] = None
    # --- numerics -----------------------------------------------------------
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # --- kernel routing: torch ops -> the hand-written kernels --------------
    use_pallas: bool = False
    remat: bool = True
    optimizer: str = "adamw"       # adamw | adafactor
    # --- cost-probe flags (dry-run accounting in the reference) ------------
    unroll_stack: bool = False
    exact_costs: bool = False
    source: str = ""               # provenance note

    # -- derived ------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def is_attention_layer(self, layer_idx: int) -> bool:
        if self.family in ("ssm",):
            return False
        if self.family == "hybrid":
            assert self.hybrid is not None
            return layer_idx % self.hybrid.attn_every == self.hybrid.attn_offset
        return True

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return (layer_idx % self.moe.every) == (self.moe.every - 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Archs eligible for the long_500k shape (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    # -- parameter count -----------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, h = self.d_model, self.head_dim_
        n_q, n_kv = self.num_heads, self.num_kv_heads
        total = 0
        emb = self.vocab_size * d
        total += emb                      # input embedding
        if not self.tie_embeddings:
            total += emb                  # lm head
        for i in range(self.num_layers):
            if self.is_attention_layer(i):
                qkv = d * (n_q * h) + 2 * d * (n_kv * h) + (n_q * h) * d
                if self.qkv_bias:
                    qkv += (n_q + 2 * n_kv) * h
                total += qkv + 2 * d      # attn + 2 rmsnorm scales
                if self.encoder_layers:   # decoder cross-attention + its norm
                    total += qkv + d
            elif self.family in ("ssm", "hybrid"):
                assert self.ssm is not None
                d_in = self.ssm.expand * d
                nh = self.ssm.num_heads(d)
                # in_proj (z,x,B,C,dt) + conv + out_proj (mamba2 layout)
                total += d * (2 * d_in + 2 * self.ssm.d_state + nh)
                total += self.ssm.conv_kernel * (d_in + 2 * self.ssm.d_state)
                total += d_in * d + 2 * nh + d  # out_proj + A,D + norm
            if self.family == "ssm":
                # mamba block includes its own mixer only (no separate FFN)
                continue
            if self.is_moe_layer(i):
                assert self.moe is not None
                e = self.moe
                total += d * e.num_experts                      # router
                total += e.num_experts * 3 * d * e.d_ff          # experts
                if e.dense_residual_d_ff:
                    total += 3 * d * e.dense_residual_d_ff       # arctic dense
                total += d
            else:
                total += 3 * d * self.d_ff + d                   # swiglu mlp
        if self.encoder_layers:
            per = 4 * d * d + 3 * d * self.d_ff + 2 * d
            total += self.encoder_layers * per + d   # + encoder final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        total = self.param_count()
        n_moe_layers = sum(self.is_moe_layer(i) for i in range(self.num_layers))
        inactive = (e.num_experts - e.experts_per_token)
        total -= n_moe_layers * inactive * 3 * self.d_model * e.d_ff
        return total

    # -- reduced config for CPU smoke tests ----------------------------------
    def reduced(self) -> "ModelConfig":
        changes: Dict[str, Any] = dict(
            num_layers=max(2, (self.hybrid.attn_every if self.hybrid else 2)),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            d_ff=128,
            head_dim=16,
            vocab_size=256,
            max_seq_len=512,
            num_audio_frames=16,
            remat=False,
        )
        if self.moe is not None:
            changes["moe"] = replace(
                self.moe,
                num_experts=4,
                experts_per_token=min(self.moe.experts_per_token, 2),
                d_ff=32,
                dense_residual_d_ff=32 if self.moe.dense_residual_d_ff else 0,
            )
        if self.ssm is not None:
            changes["ssm"] = replace(self.ssm, d_state=16, head_dim=16,
                                     chunk_size=32)
        if self.hybrid is not None:
            changes["num_layers"] = self.hybrid.attn_every
        if self.encoder_layers:
            changes["encoder_layers"] = 2
        if self.mrope_sections is not None:
            changes["mrope_sections"] = (4, 2, 2)
        return replace(self, **changes)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode | long_decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "long_decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; else reason for the skip."""
    if shape.kind == "long_decode" and not cfg.sub_quadratic:
        return False, "skip(full-attn): long_500k needs sub-quadratic attention"
    return True, ""


# ---------------------------------------------------------------------------
# Serving cache
# ---------------------------------------------------------------------------

Spec = Tuple[Tuple[int, ...], torch.dtype]


def kv_cache_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Spec]:
    """``(shape, dtype)`` of each serving-cache entry (KV and/or SSM)."""
    h = cfg.head_dim_
    specs: Dict[str, Spec] = {}
    n_attn = sum(cfg.is_attention_layer(i) for i in range(cfg.num_layers))
    if n_attn:
        specs["k"] = ((n_attn, batch, seq, cfg.num_kv_heads, h), cfg.dtype)
        specs["v"] = ((n_attn, batch, seq, cfg.num_kv_heads, h), cfg.dtype)
    if cfg.family in ("ssm", "hybrid"):
        assert cfg.ssm is not None
        n_ssm = cfg.num_layers - n_attn
        nh = cfg.ssm.num_heads(cfg.d_model)
        d_in = cfg.ssm.expand * cfg.d_model
        specs["ssm_state"] = (
            (n_ssm, batch, nh, cfg.ssm.head_dim, cfg.ssm.d_state),
            torch.float32)
        specs["conv_state"] = (
            (n_ssm, batch, cfg.ssm.conv_kernel - 1,
             d_in + 2 * cfg.ssm.d_state), cfg.dtype)
    if cfg.encoder_layers:
        specs["cross_k"] = (
            (cfg.num_layers, batch, cfg.num_audio_frames, cfg.num_kv_heads, h),
            cfg.dtype)
        specs["cross_v"] = (
            (cfg.num_layers, batch, cfg.num_audio_frames, cfg.num_kv_heads, h),
            cfg.dtype)
    return specs


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Model inputs for one (arch, shape) cell as meta tensors.

    train/prefill: full-sequence token batch. decode/long_decode: one new
    token per sequence + the populated cache.
    """
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = _meta((b, s), torch.int32)
        if shape.kind == "train":
            specs["targets"] = _meta((b, s), torch.int32)
        if cfg.encoder_layers:
            # stub modality frontend: precomputed frame embeddings
            specs["encoder_embeds"] = _meta(
                (b, cfg.num_audio_frames, cfg.d_model), cfg.dtype)
        if cfg.mrope_sections is not None:
            specs["positions"] = _meta((3, b, s), torch.int32)
    else:  # decode | long_decode: one token against a cache of length s
        specs["tokens"] = _meta((b, 1), torch.int32)
        specs["cache"] = {k: _meta(*v)
                          for k, v in kv_cache_specs(cfg, b, s).items()}
        specs["cache_index"] = _meta((), torch.int32)
        if cfg.mrope_sections is not None:
            specs["positions"] = _meta((3, b, 1), torch.int32)
    return specs


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populate registry)
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]()


def all_arch_names() -> List[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(REGISTRY)
