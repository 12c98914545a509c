"""Decoder model (the port of ``repro.models.transformer``).

One implementation parameterized by ``ModelConfig``:
  dense                  : homogeneous attention + SwiGLU stack
  vlm (qwen2-vl)         : the dense stack with M-RoPE positions threaded
                           through attention
  ssm (mamba2)           : mixer-only blocks

The reference runs the layer stack as one ``lax.scan`` over periods of
stacked parameters; the port runs it as a Python loop over the same stacked
parameters, in the reference's layout (``layers/p{p}/attn/wq`` keeps its
leading layer axis), so that a JAX parameter tree carried across through
numpy runs unchanged. The moe, hybrid and audio families need the MoE block
and the encoder, which the port does not have yet; building one raises.

Training (``forward_train``, ``loss_fn``) differentiates through torch ops
with autograd; with ``cfg.remat`` each period of the stack is recomputed in
the backward pass (``torch.utils.checkpoint``), as the reference wraps its
period step in ``jax.checkpoint``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import mamba2 as m2
from repro_torch.models.common import P, init_from_specs, stacked
from repro_torch.models.layers import attention_block, rms_norm, swiglu_mlp

FAMILIES = ("dense", "vlm", "ssm")
# what each family the port cannot build yet is waiting for
MISSING = {"moe": "the MoE block (models/moe.py)",
           "hybrid": "the MoE block (models/moe.py)",
           "audio": "the encoder stack and cross-attention in the stack"}


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def layer_period(cfg: ModelConfig) -> int:
    p = 1
    if cfg.hybrid is not None:
        p = _lcm(p, cfg.hybrid.attn_every)
    if cfg.moe is not None:
        p = _lcm(p, cfg.moe.every)
    return p


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter subtree (views, no copies)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _layer(v, i) for k, v in tree.items()}


def _layers(tree, n: int):
    """The ``n`` layers of a stacked parameter subtree, each a tree of views
    (one ``unbind`` a leaf: its backward stacks the layers' gradients once,
    where indexing each layer would add a full-size gradient per layer)."""
    if isinstance(tree, torch.Tensor):
        return tree.unbind(0)
    subs = {k: _layers(v, n) for k, v in tree.items()}
    return [{k: v[i] for k, v in subs.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def _attn_specs(cfg: ModelConfig) -> Dict[str, P]:
    E, H, D, KVH = cfg.d_model, cfg.num_heads, cfg.head_dim_, cfg.num_kv_heads
    s = {
        "wq": P((E, H, D), ("embed", "heads", None)),
        "wk": P((E, KVH, D), ("embed", "kv_heads", None)),
        "wv": P((E, KVH, D), ("embed", "kv_heads", None)),
        "wo": P((H, D, E), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = P((H, D), ("heads", None), init="zeros")
        s["bk"] = P((KVH, D), ("kv_heads", None), init="zeros")
        s["bv"] = P((KVH, D), ("kv_heads", None), init="zeros")
    return s


def _mlp_specs(cfg: ModelConfig) -> Dict[str, P]:
    E, F = cfg.d_model, cfg.d_ff
    return {
        "wi": P((E, F), ("embed", "mlp")),
        "wg": P((E, F), ("embed", "mlp")),
        "wo": P((F, E), ("mlp", "embed")),
    }


class TransformerLM:
    """Model object: specs + forward functions (train / prefill / decode)."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the port runs the {', '.join(FAMILIES)} "
                f"families; the {cfg.family} family needs "
                f"{MISSING[cfg.family]} (ROADMAP Queue 1 item 4)")
        self.cfg = cfg
        self.period = layer_period(cfg)
        assert cfg.num_layers % self.period == 0, (
            f"{cfg.name}: num_layers={cfg.num_layers} not divisible by "
            f"period={self.period}")
        self.n_periods = cfg.num_layers // self.period
        # static per-position structure
        self.mixer_kind = [
            "attn" if cfg.is_attention_layer(p) else "ssm"
            for p in range(self.period)]
        self.ffn_kind = [None if cfg.family == "ssm" else "dense"
                         for _ in range(self.period)]

    # -- specs ---------------------------------------------------------------

    def _sublayer_specs(self, p: int) -> Dict[str, Any]:
        cfg = self.cfg
        d: Dict[str, Any] = {"ln1": P((cfg.d_model,), (None,), init="ones")}
        if self.mixer_kind[p] == "attn":
            d["attn"] = _attn_specs(cfg)
        else:
            d["ssm"] = m2.mamba2_specs(cfg)
        if self.ffn_kind[p] is not None:
            d["ln2"] = P((cfg.d_model,), (None,), init="ones")
            d["ffn"] = _mlp_specs(cfg)
        return d

    def specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        E, V = cfg.d_model, cfg.vocab_size
        s: Dict[str, Any] = {
            "embed": P((V, E), ("vocab", "embed"), init="fan_last"),
            "final_norm": P((E,), (None,), init="ones"),
            "layers": {
                f"p{p}": stacked(self.n_periods, self._sublayer_specs(p))
                for p in range(self.period)},
        }
        if not cfg.tie_embeddings:
            s["lm_head"] = P((E, V), ("embed", "vocab"))
        return s

    def init(self, seed: int = 0,
             device: Union[str, torch.device, None] = None
             ) -> Dict[str, Any]:
        """Parameters drawn from a ``torch.Generator`` seeded with ``seed``,
        on the card unless ``device`` says otherwise."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return init_from_specs(self.specs(), gen, self.cfg.param_dtype)

    # -- decoder stack ---------------------------------------------------------

    def _sublayer(self, p: int, lp, x, *, positions=None, cache=None,
                  cache_index=None, collect_cache=False):
        """The layer at period position ``p`` on its parameters ``lp``;
        ``cache`` is its own entry in decode, (k, v) or (conv_state,
        ssm_state). Returns (output, mixer output, MLP output or None, the
        layer's new cache entries or None)."""
        cfg = self.cfg
        decode = cache is not None
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        new = None
        if self.mixer_kind[p] == "attn":
            h, ex = attention_block(lp["attn"], h, cfg, positions=positions,
                                    cache=cache, cache_index=cache_index)
            if decode or collect_cache:
                new = dict(zip(("k", "v"), ex["cache"] if decode
                               else ex["kv"]))
        else:  # ssm mixer
            h, st = m2.mamba2_block(lp["ssm"], h, cfg, state=cache,
                                    want_state=collect_cache)
            if st is not None and (decode or collect_cache):
                new = dict(zip(("conv_state", "ssm_state"), st))
        x = x + h
        m = None
        if self.ffn_kind[p] is not None:
            m = swiglu_mlp(lp["ffn"], rms_norm(x, lp["ln2"], cfg.rms_eps),
                           cfg)
            x = x + m
        return x, h, m, new

    def _stack(self, params, x, *, positions=None, cache=None,
               cache_index=None, collect_cache=False, remat=False):
        """Run the layer stack. Returns (x, aux_loss, new_cache | None);
        with ``cache`` (the tree of ``kv_cache_specs``, leading dim n_attn /
        n_ssm) it runs decode (S == 1). With ``remat`` each period is
        recomputed in the backward pass instead of keeping its
        activations."""
        decode = cache is not None
        ys: Dict[str, list] = {}
        n = {"attn": 0, "ssm": 0}      # attention / ssm layers so far
        keys = {"attn": ("k", "v"), "ssm": ("conv_state", "ssm_state")}
        layers = [_layers(params["layers"][f"p{p}"], self.n_periods)
                  for p in range(self.period)]

        def period_step(x, i):
            for p in range(self.period):
                x = self._sublayer(p, layers[p][i], x,
                                   positions=positions)[0]
            return x

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if not (decode or collect_cache):
            for i in range(self.n_periods):
                x = (checkpoint(period_step, x, i, use_reentrant=False)
                     if remat else period_step(x, i))
            return x, aux, None
        for i in range(self.n_periods):
            for p in range(self.period):
                kind = self.mixer_kind[p]
                entry = (tuple(cache[k][n[kind]] for k in keys[kind])
                         if decode else None)
                x, _, _, new = self._sublayer(
                    p, layers[p][i], x,
                    positions=positions, cache=entry,
                    cache_index=cache_index, collect_cache=collect_cache)
                for k, v in (new or {}).items():
                    ys.setdefault(k, []).append(v)
                n[kind] += 1
        new_cache = {k: torch.stack(v) for k, v in ys.items()}
        if decode:  # static entries pass through
            for k in cache:
                new_cache.setdefault(k, cache[k])
        return x, aux, new_cache

    # -- public entry points ---------------------------------------------------

    def embed_tokens(self, params, tokens):
        return params["embed"][tokens].to(self.cfg.dtype)

    def logits(self, params, x):
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.rms_eps)
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"])
        return x @ head.to(x.dtype)

    def forward_train(self, params, tokens, *, positions=None):
        """tokens (B, S) -> (logits (B,S,V), aux_loss)."""
        x = self.embed_tokens(params, tokens)
        x, aux, _ = self._stack(params, x, positions=positions,
                                remat=self.cfg.remat)
        return self.logits(params, x), aux

    @torch.no_grad()
    def prefill(self, params, tokens, *, positions=None):
        """Full-prompt forward; returns (last-token logits, populated cache)."""
        x = self.embed_tokens(params, tokens)
        x, _, cache = self._stack(params, x, positions=positions,
                                  collect_cache=True)
        return self.logits(params, x[:, -1:, :]), cache

    @torch.no_grad()
    def decode_step(self, params, tokens, cache, cache_index=None, *,
                    positions=None):
        """tokens (B, 1) + cache -> (logits (B,1,V), new cache).
        ``cache_index`` (a scalar or per-slot (B,) lengths) places the
        token in the k/v cache; the ssm cache needs none."""
        x = self.embed_tokens(params, tokens)
        x, _, new_cache = self._stack(params, x, positions=positions,
                                      cache=cache, cache_index=cache_index)
        return self.logits(params, x), new_cache


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean token CE, f32. logits (B,S,V), targets (B,S) integer."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def loss_fn(model: TransformerLM, params, batch: Dict[str, torch.Tensor]):
    logits, aux = model.forward_train(params, batch["tokens"],
                                      positions=batch.get("positions"))
    ce = cross_entropy(logits, batch["targets"])
    return ce + aux, {"ce": ce, "aux": aux}


def pad_cache(cache: Dict[str, torch.Tensor],
              capacity: int) -> Dict[str, torch.Tensor]:
    """Pad prefill-produced k/v (length S) to decode capacity T >= S."""
    out = dict(cache)
    for key in ("k", "v"):
        if key in out:
            n, b, s, kvh, d = out[key].shape
            if s < capacity:
                pad = out[key].new_zeros((n, b, capacity - s, kvh, d))
                out[key] = torch.cat([out[key], pad], dim=2)
    return out


def build_model(cfg: ModelConfig) -> TransformerLM:
    return TransformerLM(cfg)
