"""Decoder model (the port of ``repro.models.transformer``).

The reference covers every architecture family with one ``lax.scan`` over
stacked layer parameters. The port runs the ``ssm`` family (mamba2:
mixer-only blocks) as a Python loop over the same stacked parameters, in
the reference's layout (``layers/p0/...`` with a leading layer axis), so
that a JAX parameter tree carried across through numpy runs unchanged.
The other families need mixers the port does not have yet; building one
raises.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import mamba2 as m2
from repro_torch.models.common import P, init_from_specs, stacked
from repro_torch.models.layers import rms_norm


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter subtree (views, no copies)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _layer(v, i) for k, v in tree.items()}


class TransformerLM:
    """Model object: specs + forward functions (train / prefill / decode)."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "ssm":
            raise NotImplementedError(
                f"{cfg.name}: the port runs the ssm family only; the "
                f"{cfg.family} family needs attention, SwiGLU/MoE or encoder "
                "layers (ROADMAP Queue 1 item 1, the dense family; item 4, "
                "the other configs)")
        self.cfg = cfg
        # the ssm family has one mixer kind and no FFN: a period of one
        # layer, so the stack holds num_layers periods
        self.n_periods = cfg.num_layers

    # -- specs ---------------------------------------------------------------

    def specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        E, V = cfg.d_model, cfg.vocab_size
        layer = {"ln1": P((E,), (None,), init="ones"),
                 "ssm": m2.mamba2_specs(cfg)}
        s: Dict[str, Any] = {
            "embed": P((V, E), ("vocab", "embed"), init="fan_last"),
            "final_norm": P((E,), (None,), init="ones"),
            "layers": {"p0": stacked(self.n_periods, layer)},
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

    def _stack(self, params, x, *, cache=None, collect_cache=False):
        """Run the layer stack. Returns (x, aux_loss, new_cache | None);
        with ``cache`` (the tree of ``kv_cache_specs``) it runs decode."""
        cfg = self.cfg
        decode = cache is not None
        stack = params["layers"]["p0"]
        conv, ssm = [], []
        for i in range(self.n_periods):
            lp = _layer(stack, i)
            h = rms_norm(x, lp["ln1"], cfg.rms_eps)
            st = ((cache["conv_state"][i], cache["ssm_state"][i])
                  if decode else None)
            h, new_st = m2.mamba2_block(lp["ssm"], h, cfg, state=st,
                                        want_state=collect_cache)
            if new_st is not None and (decode or collect_cache):
                conv.append(new_st[0])
                ssm.append(new_st[1])
            x = x + h
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_cache = None
        if decode or collect_cache:
            new_cache = {"ssm_state": torch.stack(ssm),
                         "conv_state": torch.stack(conv)}
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

    def forward_train(self, params, tokens):
        """tokens (B, S) -> (logits (B,S,V), aux_loss)."""
        x = self.embed_tokens(params, tokens)
        x, aux, _ = self._stack(params, x)
        return self.logits(params, x), aux

    @torch.no_grad()
    def prefill(self, params, tokens):
        """Full-prompt forward; returns (last-token logits, populated cache)."""
        x = self.embed_tokens(params, tokens)
        x, _, cache = self._stack(params, x, collect_cache=True)
        return self.logits(params, x[:, -1:, :]), cache

    @torch.no_grad()
    def decode_step(self, params, tokens, cache, cache_index=None):
        """tokens (B, 1) + cache -> (logits (B,1,V), new cache). The ssm
        cache needs no position (``cache_index`` is the attention cache's,
        kept for the reference's signature)."""
        x = self.embed_tokens(params, tokens)
        x, _, new_cache = self._stack(params, x, cache=cache)
        return self.logits(params, x), new_cache


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

