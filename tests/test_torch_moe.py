"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe.moe_block`` on reduced configs, f32, with the
router and expert weights carried across by ``params_from_jax`` and the
same numpy input:

  - the output and the auxiliary loss within 1e-5 (rtol and atol);
  - the dispatch tensor exactly, and the combine tensor's nonzero pattern
    exactly with its gate values within 1e-5. The reference's tensors are
    read from its einsums (a recording stand-in for the module's ``jnp``);
  - reduced qwen3-moe with the default capacity factor (choices dropped)
    and with 16 (none dropped), and reduced arctic (the dense residual,
    choices dropped);
  - every routing call of these comparisons clear of a near-tie
    (``tests/_torch_routing.py``), so that no comparison rests on the
    order of the router's sums;
  - ties: with zero router weights every probability is equal, and both
    packages pick experts 0..K-1 (``lax.top_k`` puts the lower index
    first; ``torch.topk`` would not).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.weights import params_from_jax
from tests._torch_routing import clear_routing

TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 48


class _Recorder:
    """``jnp`` with its einsum operands recorded by subscripts."""

    def __init__(self):
        self.seen = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        self.seen[spec] = ops
        return jnp.einsum(spec, *ops, **kw)


def _configs(arch, capacity_factor=None):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype=jnp.float32)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=torch.float32)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return jcfg, cfg


def _params(jcfg, seed=0, zero_router=False):
    """The reference's block parameters (its specs' shapes, its init's
    scale) drawn from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in jmoe.moe_specs(jcfg).items():
        fan_in = spec.shape[-2]
        out[name] = (rng.standard_normal(spec.shape, dtype=np.float32)
                     / np.float32(np.sqrt(fan_in)))
    if zero_router:
        out["router"] = np.zeros_like(out["router"])
    return out


def _run_reference(jcfg, params, x, monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(jmoe, "jnp", rec)
    out, aux = jmoe.moe_block(jax.tree.map(jnp.asarray, params),
                              jnp.asarray(x), jcfg)
    monkeypatch.undo()
    return (np.asarray(out), float(aux),
            np.asarray(rec.seen["gsec,gsd->gecd"][0]),
            np.asarray(rec.seen["gsec,gecd->gsd"][0]))


@pytest.mark.parametrize("arch,capacity_factor", [
    ("qwen3-moe-30b-a3b", None), ("qwen3-moe-30b-a3b", 16.0),
    ("arctic-480b", None)])
def test_moe_block_matches_reference(arch, capacity_factor, monkeypatch):
    jcfg, cfg = _configs(arch, capacity_factor)
    params = _params(jcfg)
    rng = np.random.default_rng(1)
    # a direction shared by every token skews the routing, as a real
    # batch's does, so that the default capacity drops choices
    x = (rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
         + rng.standard_normal(cfg.d_model, dtype=np.float32))
    want, waux, wdisp, wcomb = _run_reference(jcfg, params, x, monkeypatch)
    tp = params_from_jax(params, "cpu")
    with clear_routing():
        got, aux = moe.moe_block(tp, torch.from_numpy(x), cfg)
        r = moe.route(tp, torch.from_numpy(x), cfg)

    C = moe._capacity(S, cfg)
    assert C == jmoe._capacity(S, jcfg)
    assert r["dispatch"].shape == (B, S, cfg.moe.num_experts, C)
    kept = int(r["dispatch"].sum())
    if capacity_factor is None:
        assert kept < B * S * cfg.moe.experts_per_token   # tokens dropped
    else:
        assert kept == B * S * cfg.moe.experts_per_token
    np.testing.assert_array_equal(r["dispatch"].numpy(), wdisp)
    np.testing.assert_array_equal(r["combine"].numpy() != 0, wcomb != 0)
    np.testing.assert_allclose(r["combine"].numpy(), wcomb, **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), waux, **TOL)
    assert float(aux) > 0


def test_ties_pick_the_lowest_experts(monkeypatch):
    """Zero router weights: every probability is 1/E, and the first K
    experts are chosen, in order, by both packages (16 experts, top 4; a
    capacity factor of 16 keeps every choice)."""
    jcfg, cfg = _configs("qwen3-moe-30b-a3b", 16.0)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, num_experts=16, experts_per_token=4))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=16, experts_per_token=4))
    K = 4
    params = _params(jcfg, zero_router=True)
    x = np.random.default_rng(2).standard_normal((1, 3, cfg.d_model),
                                                 dtype=np.float32)
    _, _, wdisp, _ = _run_reference(jcfg, params, x, monkeypatch)
    r = moe.route(params_from_jax(params, "cpu"), torch.from_numpy(x), cfg)
    want = np.broadcast_to(np.arange(K), (1, 3, K))
    np.testing.assert_array_equal(r["expert_idx"].numpy(), want)
    # the reference's own choice, read from its dispatch tensor and from
    # lax.top_k on the same equal probabilities
    for s in range(3):
        assert np.flatnonzero(wdisp[0, s].sum(-1)).tolist() == list(range(K))
    _, jidx = jax.lax.top_k(jnp.full((1, 3, 16), 1 / 16, jnp.float32), K)
    np.testing.assert_array_equal(np.asarray(jidx), want)
    np.testing.assert_array_equal(r["dispatch"].numpy(), wdisp)


def test_top_k_matches_lax_top_k_on_bf16_ties():
    """bf16 probabilities, which tie often: the same indices as
    ``lax.top_k`` on every row."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((64, 128), dtype=np.float32)
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.bfloat16)
                                  .astype(jnp.float32), axis=-1))
    # round the probabilities to bf16 so that ties appear
    p = np.asarray(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32))
    assert all(len(np.unique(row)) < row.size for row in p)
    _, jidx = jax.lax.top_k(jnp.asarray(p), 8)
    _, idx = moe.top_k(torch.from_numpy(p.copy()), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_moe_specs_match_reference():
    for arch in ("qwen3-moe-30b-a3b", "arctic-480b",
                 "jamba-1.5-large-398b"):
        for reduce in (False, True):
            jcfg, cfg = jget_config(arch), get_config(arch)
            if reduce:
                jcfg, cfg = jcfg.reduced(), cfg.reduced()
            want = jmoe.moe_specs(jcfg)
            got = moe.moe_specs(cfg)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].shape == want[k].shape
                assert got[k].axes == want[k].axes
