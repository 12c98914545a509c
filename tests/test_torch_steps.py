"""The port's serving steps against the JAX package's, on a (1, 1) mesh.

The reference's ``make_prefill_step`` / ``make_decode_step`` bundles on its
host mesh (one CPU device) and the port's on ``make_host_mesh(device=
"cpu")``, fed the same numpy parameters cast to the model dtype (the
serving steps' weights, ``serving_param_shapes``), the same tokens: the
prefill's last-token logits and every cache leaf, then one decode step
from the prefill's cache padded to the decode capacity (logits and every
cache leaf). Relative L2 error of each:

  - reduced qwen2.5-14b in bf16 (weights and activations), on the
    torch-ops path and on use_pallas (the kernels' plain versions on the
    CPU): <= 2e-2, bf16 rounding in another order through two layers;
  - reduced qwen2-vl-7b (M-RoPE ``positions``), whisper-base
    (``encoder_embeds``, the cross K/V in the cache) and qwen3-moe-30b-a3b
    (its routing clear of near-ties, ``tests/_torch_routing.py``) in f32:
    <= 1e-4.

Also: the batch's real tensors match the bundles' ``abstract_inputs``
(meta tensors) in shape and dtype, and ``batch_axes`` / ``kv_cache_axes``
equal the reference's for all ten archs and the four ``SHAPES``.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models.transformer import build_model as jbuild_model
from repro.models.transformer import pad_cache as jpad_cache
from repro_torch.configs import SHAPES, ShapeConfig, all_arch_names, get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (batch_axes, kv_cache_axes,
                                      make_decode_step, make_prefill_step,
                                      serving_param_shapes)
from repro_torch.models.transformer import build_model, pad_cache
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_jax
from tests._torch_routing import clear_routing

B, S, CAP = 2, 11, 16
BF16_REL, F32_REL = 2e-2, 1e-4

CASES = [("qwen2.5-14b", "bf16", False), ("qwen2.5-14b", "bf16", True),
         ("qwen2-vl-7b", "f32", False), ("whisper-base", "f32", False),
         ("qwen3-moe-30b-a3b", "f32", False)]


def rel_l2(got: torch.Tensor, want) -> float:
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _inputs(cfg, kind):
    """The batch of a prefill (``kind`` "prefill") or of the decode step
    that follows it, numpy, as ``input_specs`` lays it out."""
    rng = np.random.default_rng(3 if kind == "prefill" else 4)
    n = S if kind == "prefill" else 1
    b = {"tokens": rng.integers(0, cfg.vocab_size,
                                size=(B, n)).astype(np.int32)}
    if cfg.encoder_layers and kind == "prefill":
        b["encoder_embeds"] = rng.standard_normal(
            (B, cfg.num_audio_frames, cfg.d_model), dtype=np.float32)
    if cfg.mrope_sections is not None:
        base = np.arange(n, dtype=np.int32) + (0 if kind == "prefill" else S)
        b["positions"] = np.stack([base, base // 2, base % 3])[:, None, :] \
            .repeat(B, axis=1).astype(np.int32)
    return b


def _same_layout(meta_tree, tree):
    """Each real leaf has its abstract input's shape and dtype."""
    metas, reals = tree_leaves(meta_tree), tree_leaves(tree)
    assert len(metas) == len(reals)
    for m, r in zip(metas, reals):
        assert m.device.type == "meta"
        assert (tuple(m.shape), m.dtype) == (tuple(r.shape), r.dtype)


@pytest.mark.parametrize("arch,dtype,use_pallas", CASES)
def test_serving_steps_match_reference(arch, dtype, use_pallas):
    jdt, tdt, tol = {"bf16": (jnp.bfloat16, torch.bfloat16, BF16_REL),
                     "f32": (jnp.float32, torch.float32, F32_REL)}[dtype]
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype=jdt)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=tdt,
                              use_pallas=use_pallas)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jax.tree.map(lambda a: a.astype(jdt),
                           jmodel.init(jax.random.PRNGKey(0)))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jmesh, mesh = jmake_host_mesh(), make_host_mesh(device="cpu")
    routing = clear_routing if cfg.moe else contextlib.nullcontext
    pre_shape = JShapeConfig("p", S, B, "prefill")
    dec_shape = JShapeConfig("d", CAP, B, "decode")

    jpre = jsteps.make_prefill_step(jmodel, jmesh, pre_shape)
    pre = make_prefill_step(model, mesh, ShapeConfig("p", S, B, "prefill"))
    _same_layout(pre.abstract_inputs[0], params)
    assert pre.donate_argnums == jpre.donate_argnums == ()
    nb = _inputs(cfg, "prefill")
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    _same_layout(pre.abstract_inputs[1], batch)
    jlog, jcache = jpre.fn(jparams, jax.tree.map(jnp.asarray, nb))
    with routing():
        log, cache = pre.fn(params, batch)
    assert log.dtype == tdt and tuple(log.shape) == jlog.shape
    assert rel_l2(log, jlog) <= tol, rel_l2(log, jlog)
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape, k
        assert rel_l2(cache[k], jcache[k]) <= tol, (k, rel_l2(
            cache[k], jcache[k]))

    jdec = jsteps.make_decode_step(jmodel, jmesh, dec_shape)
    dec = make_decode_step(model, mesh, ShapeConfig("d", CAP, B, "decode"))
    assert dec.donate_argnums == jdec.donate_argnums == (1,)
    nd = _inputs(cfg, "decode")
    jb = {**jax.tree.map(jnp.asarray, nd), "cache": jpad_cache(jcache, CAP),
          "cache_index": jnp.int32(S)}
    tb = {**{k: torch.from_numpy(v) for k, v in nd.items()},
          "cache": pad_cache(cache, CAP),
          "cache_index": torch.tensor(S, dtype=torch.int32)}
    _same_layout(dec.abstract_inputs[1], tb)
    jlog, jnew = jdec.fn(jparams, jb)
    with routing():
        log, new = dec.fn(params, tb)
    assert rel_l2(log, jlog) <= tol, rel_l2(log, jlog)
    assert sorted(new) == sorted(jnew)
    for k in new:
        assert tuple(new[k].shape) == jnew[k].shape, k
        assert rel_l2(new[k], jnew[k]) <= tol, (k, rel_l2(new[k], jnew[k]))


def test_serving_param_shapes_are_model_dtype():
    model = build_model(get_config("deepseek-coder-33b"))
    shapes = serving_param_shapes(model)
    masters = model.param_shapes()
    for s, m in zip(tree_leaves(shapes), tree_leaves(masters)):
        assert s.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert s.shape == m.shape and s.device.type == "meta"
    # 33.34 B parameters: 62.1 GiB in bf16, 124.2 GiB as f32 masters
    n = sum(s.numel() for s in tree_leaves(shapes))
    assert n == 33_342_991_360 and round(n * 2 / 2 ** 30, 1) == 62.1


@pytest.mark.parametrize("arch", all_arch_names())
def test_batch_and_cache_axes_match_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert kv_cache_axes(cfg) == jsteps.kv_cache_axes(jcfg)
    assert sorted(SHAPES) == sorted(JSHAPES)
    for name in SHAPES:
        assert batch_axes(cfg, SHAPES[name]) == jsteps.batch_axes(
            jcfg, JSHAPES[name]), name


def _redraw(model, seed, dtype, rows_of):
    """The init's draws replayed by hand: each leaf in sorted key order,
    ``rows_of(leaf)`` leading rows drawn in f32 at a time, scaled, cast."""
    from repro_torch.models.common import P
    gen = torch.Generator().manual_seed(seed)

    def walk(specs):
        if isinstance(specs, P):
            if specs.init in ("zeros", "ones"):
                return (torch.zeros if specs.init == "zeros" else torch.ones)(
                    specs.shape, dtype=dtype)
            fan = (specs.shape[-1] if specs.init == "fan_last"
                   else specs.shape[-2] if len(specs.shape) >= 2
                   else specs.shape[-1])
            n = rows_of(specs)
            parts = [torch.empty((min(n, specs.shape[0] - i),)
                                 + specs.shape[1:]).normal_(generator=gen)
                     .mul_(specs.scale / np.sqrt(fan)).to(dtype)
                     for i in range(0, specs.shape[0], n)]
            return torch.cat(parts)
        return {k: walk(specs[k]) for k in sorted(specs)}

    return walk(model.specs())


def test_init_draws_f32_whole_and_narrow_leaves_by_slices(monkeypatch):
    """f32 leaves are drawn whole, as before the serving steps came; a
    bf16 leaf is drawn DRAW_ELEMENTS at a time along its leading axis
    straight into the bf16 leaf (here 3000 elements: one layer of a
    stacked leaf at a time, the 256 x 64 embedding in 6 pieces)."""
    from repro_torch.models import common
    model = build_model(get_config("qwen2.5-14b").reduced())
    whole = _redraw(model, 5, torch.float32, lambda p: p.shape[0])
    for g, w in zip(tree_leaves(model.init(5, device="cpu")),
                    tree_leaves(whole)):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    monkeypatch.setattr(common, "DRAW_ELEMENTS", 3000)
    sliced = _redraw(model, 5, torch.bfloat16,
                     lambda p: max(1, 3000 // int(np.prod(p.shape[1:]))))
    got = model.init(5, device="cpu", dtype=torch.bfloat16)
    for g, w in zip(tree_leaves(got), tree_leaves(sliced)):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)
