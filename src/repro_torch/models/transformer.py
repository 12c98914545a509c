"""Unified decoder(-encoder) model (the port of
``repro.models.transformer``).

One implementation parameterized by ``ModelConfig``:
  dense / moe            : homogeneous attention stack, SwiGLU or MoE FFN
  ssm (mamba2)           : mixer-only blocks
  hybrid (jamba)         : periods of ``attn_every`` layers, mamba2 and
                           attention mixers by position, each with an FFN
                           (MoE every ``moe.every`` layers)
  audio (whisper)        : encoder stack (non-causal) + decoder with
                           cross-attention to the encoder's output
  vlm (qwen2-vl)         : M-RoPE positions threaded through attention

The reference runs the layer stack as one ``lax.scan`` over periods of
stacked parameters; the port runs it as a Python loop over the same stacked
parameters, in the reference's layout (``layers/p{p}/attn/wq`` keeps its
leading layer axis), so that a JAX parameter tree carried across through
numpy runs unchanged.

Training (``forward_train``, ``loss_fn``) differentiates through torch ops
with autograd; with ``cfg.remat`` each period of the stack is recomputed in
the backward pass (``torch.utils.checkpoint``), as the reference wraps its
period step in ``jax.checkpoint``. The MoE auxiliary loss is summed over
the layers on every path, the checkpointed one included.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import LOCAL, model_axis
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (P, axes_from_specs, init_from_specs,
                                       shapes_from_specs, stacked,
                                       tree_map_specs)
from repro_torch.models.layers import (attention_block, column_product,
                                       rms_norm, swiglu_mlp)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


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
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
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
        self.ffn_kind = [
            None if cfg.family == "ssm"
            else ("moe" if cfg.is_moe_layer(p) else "dense")
            for p in range(self.period)]

    # -- specs ---------------------------------------------------------------

    def _sublayer_specs(self, p: int) -> Dict[str, Any]:
        cfg = self.cfg
        d: Dict[str, Any] = {"ln1": P((cfg.d_model,), (None,), init="ones")}
        if self.mixer_kind[p] == "attn":
            d["attn"] = _attn_specs(cfg)
            if cfg.encoder_layers:
                d["ln_x"] = P((cfg.d_model,), (None,), init="ones")
                d["xattn"] = _attn_specs(cfg)
        else:
            d["ssm"] = m2.mamba2_specs(cfg)
        if self.ffn_kind[p] is not None:
            d["ln2"] = P((cfg.d_model,), (None,), init="ones")
            d["ffn"] = (moe_lib.moe_specs(cfg) if self.ffn_kind[p] == "moe"
                        else _mlp_specs(cfg))
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
        if cfg.encoder_layers:
            enc_layer = {
                "ln1": P((E,), (None,), init="ones"),
                "attn": _attn_specs(cfg),
                "ln2": P((E,), (None,), init="ones"),
                "ffn": _mlp_specs(cfg),
            }
            s["encoder"] = {
                "layers": stacked(cfg.encoder_layers, enc_layer),
                "norm": P((E,), (None,), init="ones"),
            }
        return s

    def init(self, seed: int = 0,
             device: Union[str, torch.device, None] = None,
             dtype: Optional[torch.dtype] = None,
             parts=None) -> Dict[str, Any]:
        """Parameters drawn from a ``torch.Generator`` seeded with ``seed``,
        on the card unless ``device`` says otherwise; every leaf in
        ``dtype`` where given (the serving steps' model-dtype weights), else
        in ``cfg.param_dtype``. ``parts`` (a tree of slice tuples) keeps
        only those parts of the leaves (``init_from_specs``)."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        specs = self.specs()
        if dtype is not None:
            specs = tree_map_specs(
                lambda p: dataclasses.replace(p, dtype=dtype), specs)
        return init_from_specs(specs, gen, self.cfg.param_dtype, parts)

    def param_shapes(self):
        return shapes_from_specs(self.specs(), self.cfg.param_dtype)

    def param_axes(self):
        return axes_from_specs(self.specs())

    # -- encoder (audio) ------------------------------------------------------

    def encode(self, params, embeds: torch.Tensor) -> torch.Tensor:
        """embeds: (B, F, E) precomputed frame embeddings (stub frontend).
        Each encoder layer: non-causal self-attention, then the SwiGLU MLP,
        each behind its RMSNorm and residual; then the final norm."""
        cfg = self.cfg
        if embeds is None:
            raise ValueError(f"{cfg.name}: the {cfg.family} family needs "
                             "encoder_embeds (B, frames, d_model)")
        x = embeds.to(cfg.dtype)
        for lp in _layers(params["encoder"]["layers"], cfg.encoder_layers):
            x, _ = self._enc_attn(lp, x)
            x, _ = self._enc_mlp(lp, x)
        return rms_norm(x, params["encoder"]["norm"], cfg.rms_eps)

    def _enc_attn(self, lp, x):
        """The encoder layer's first half on its parameters ``lp``:
        RMSNorm, non-causal self-attention, residual. Returns (x, attention
        output)."""
        h, _ = attention_block(lp["attn"],
                               rms_norm(x, lp["ln1"], self.cfg.rms_eps),
                               self.cfg, causal=False)
        return x + h, h

    def _enc_mlp(self, lp, x):
        """The encoder layer's second half: RMSNorm, SwiGLU MLP, residual.
        Returns (x, MLP output)."""
        m = swiglu_mlp(lp["ffn"], rms_norm(x, lp["ln2"], self.cfg.rms_eps),
                       self.cfg)
        return x + m, m

    # -- decoder stack ---------------------------------------------------------

    def _mixer(self, p: int, lp, x, *, positions=None, cache=None,
               cache_index=None, collect_cache=False, enc_out=None,
               cross=None):
        """The mixer half of the layer at period position ``p``: RMSNorm,
        attention or mamba2, residual, and for the audio family the
        cross-attention to the encoder (its K/V projected from ``enc_out``,
        or ``cross`` = (cross_k, cross_v) from the cache in decode).
        ``cache`` is the layer's own entry in decode, (k, v) or
        (conv_state, ssm_state). Returns (x, mixer output, the layer's new
        cache entries or None)."""
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
            x = x + h
            if cfg.encoder_layers:
                hx = rms_norm(x, lp["ln_x"], cfg.rms_eps)
                if cross is None:
                    dt = x.dtype
                    cross = tuple(
                        torch.einsum("bfe,ehd->bfhd", enc_out,
                                     lp["xattn"][w].to(dt))
                        for w in ("wk", "wv"))
                    if collect_cache:
                        new.update(zip(("cross_k", "cross_v"), cross))
                hx, _ = attention_block(lp["xattn"], hx, cfg,
                                        encoder_kv=cross)
                x = x + hx
        else:  # ssm mixer
            h, st = m2.mamba2_block(lp["ssm"], h, cfg, state=cache,
                                    want_state=collect_cache)
            if st is not None and (decode or collect_cache):
                new = dict(zip(("conv_state", "ssm_state"), st))
            x = x + h
        return x, h, new

    def _ffn(self, p: int, lp, x):
        """The FFN half of the layer at period position ``p``: RMSNorm,
        SwiGLU MLP or MoE block, residual. Returns (x, FFN output or None,
        the MoE auxiliary loss or None)."""
        kind = self.ffn_kind[p]
        if kind is None:
            return x, None, None
        h = rms_norm(x, lp["ln2"], self.cfg.rms_eps)
        if kind == "moe":
            m, aux = moe_lib.moe_block(lp["ffn"], h, self.cfg)
        else:
            m, aux = swiglu_mlp(lp["ffn"], h, self.cfg), None
        return x + m, m, aux

    def _sublayer(self, p: int, lp, x, **kw):
        """The layer at period position ``p`` on its parameters ``lp``
        (``_mixer``'s keywords). Returns (output, mixer output, FFN output
        or None, the layer's new cache entries or None, the MoE auxiliary
        loss or None)."""
        x, h, new = self._mixer(p, lp, x, **kw)
        x, m, aux = self._ffn(p, lp, x)
        return x, h, m, new, aux

    def _stack(self, params, x, *, positions=None, cache=None,
               cache_index=None, enc_out=None, collect_cache=False,
               remat=False):
        """Run the layer stack. Returns (x, aux_loss, new_cache | None);
        with ``cache`` (the tree of ``kv_cache_specs``, leading dim n_attn /
        n_ssm) it runs decode (S == 1). With ``remat`` each period is
        recomputed in the backward pass instead of keeping its
        activations; it returns the period's auxiliary loss beside x, so
        that the loss is summed through the checkpoint too."""
        decode = cache is not None
        ys: Dict[str, list] = {}
        n = {"attn": 0, "ssm": 0}      # attention / ssm layers so far
        keys = {"attn": ("k", "v"), "ssm": ("conv_state", "ssm_state")}
        layers = [_layers(params["layers"][f"p{p}"], self.n_periods)
                  for p in range(self.period)]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def period_step(x, enc_out, i):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for p in range(self.period):
                x, _, _, _, al = self._sublayer(p, layers[p][i], x,
                                                positions=positions,
                                                enc_out=enc_out)
                if al is not None:
                    aux = aux + al
            return x, aux

        if not (decode or collect_cache):
            for i in range(self.n_periods):
                x, al = (checkpoint(period_step, x, enc_out, i,
                                    use_reentrant=False)
                         if remat else period_step(x, enc_out, i))
                aux = aux + al
            return x, aux, None
        for i in range(self.n_periods):
            for p in range(self.period):
                kind = self.mixer_kind[p]
                j = n[kind]
                entry = (tuple(cache[k][j] for k in keys[kind])
                         if decode else None)
                cross = ((cache["cross_k"][j], cache["cross_v"][j])
                         if decode and "cross_k" in cache
                         and kind == "attn" else None)
                x, _, _, new, al = self._sublayer(
                    p, layers[p][i], x,
                    positions=positions, cache=entry,
                    cache_index=cache_index, collect_cache=collect_cache,
                    enc_out=enc_out, cross=cross)
                if al is not None:
                    aux = aux + al
                for k, v in (new or {}).items():
                    ys.setdefault(k, []).append(v)
                n[kind] += 1
        new_cache = {k: torch.stack(v) for k, v in ys.items()}
        if decode:  # static entries (the cross-attention K/V) pass through
            for k in cache:
                new_cache.setdefault(k, cache[k])
        return x, aux, new_cache

    # -- public entry points ---------------------------------------------------

    def embed_tokens(self, params, tokens):
        """The tokens' rows of the embedding. Inside a sharded step, a
        table split over the vocab looks up the tokens of this rank's
        range (zeros for the rest), summed over the model axis; one split
        on its embed dim gathers the rank's columns."""
        emb, ax = params["embed"], model_axis()
        if ax is None or tuple(emb.shape) == (self.cfg.vocab_size,
                                              self.cfg.d_model):
            return emb[tokens].to(self.cfg.dtype)
        if emb.shape[0] == self.cfg.vocab_size:
            return ax.gather(emb[tokens], -1).to(self.cfg.dtype)
        n = emb.shape[0]
        ids = tokens - ax.index * n
        hit = (ids >= 0) & (ids < n)
        rows = torch.where(hit[..., None], emb[ids.clamp(0, n - 1)], 0)
        return ax.sum(rows).to(self.cfg.dtype)

    def logits(self, params, x):
        """The final norm on the whole ``x``, then the head's columns;
        inside a sharded step those of this rank's vocab range, unless
        the head is split on its embed dim (summed, every column)."""
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.rms_eps)
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"])
        return column_product(x, head, model_axis() or LOCAL)

    def forward_train(self, params, tokens, *, positions=None,
                      encoder_embeds=None):
        """tokens (B, S) -> (logits (B,S,V), aux_loss)."""
        x = self.embed_tokens(params, tokens)
        enc_out = (self.encode(params, encoder_embeds)
                   if self.cfg.encoder_layers else None)
        x, aux, _ = self._stack(params, x, positions=positions,
                                enc_out=enc_out, remat=self.cfg.remat)
        return self.logits(params, x), aux

    @torch.no_grad()
    def prefill(self, params, tokens, *, positions=None,
                encoder_embeds=None):
        """Full-prompt forward; returns (last-token logits, populated cache)."""
        x = self.embed_tokens(params, tokens)
        enc_out = (self.encode(params, encoder_embeds)
                   if self.cfg.encoder_layers else None)
        x, _, cache = self._stack(params, x, positions=positions,
                                  enc_out=enc_out, collect_cache=True)
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
    logits, aux = model.forward_train(
        params, batch["tokens"], positions=batch.get("positions"),
        encoder_embeds=batch.get("encoder_embeds"))
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
