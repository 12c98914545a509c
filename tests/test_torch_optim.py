"""The port's optimizers and schedules (``repro_torch.optim``) against the
JAX package's on the same numpy inputs: 10 steps of AdamW and Adafactor on
identical gradient sequences (a factored 2-D weight, a stacked 3-D weight,
1-D vectors with a full slot, a bf16 parameter with f32 moments), the
global-norm clip, and the schedules over steps 0..200. Tolerance: 1e-6
relative L2 per leaf (f32 arithmetic in the same order; only the library
kernels' last bits may differ); a bf16 parameter within one bf16 rounding
of the reference (an f32 value that lands within an ulp of a rounding
boundary may round the other way)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import adafactor as jadafactor
from repro.optim import schedule as jschedule
from repro_torch.optim import (AdafactorConfig, AdamWConfig, AfState,
                               OptState, adafactor_init, adafactor_update,
                               adamw_init, adamw_update, clip_by_global_norm,
                               constant, cosine_decay, global_norm,
                               linear_warmup_cosine)
from repro_torch.optim.adafactor import _Factored, _Full
from repro_torch.tree import tree_flatten, tree_leaves
from repro_torch.weights import opt_state_from_jax, params_from_jax

REL = 1e-6
STEPS = 10

# (shape, dtype) of each parameter: a factored 2-D weight, a stacked 3-D
# weight (slots vr (n, R), vc (n, C)), 1-D vectors (full slot) and a bf16
# weight with f32 moments
SHAPES = {"w": ((6, 5), np.float32), "stack": ((3, 4, 7), np.float32),
          "b": ((5,), np.float32), "ln": ((7,), np.float32),
          "h": ((4, 8), "bfloat16")}


def _params(seed=0):
    r = np.random.default_rng(seed)
    out = {}
    for k, (shape, dt) in SHAPES.items():
        a = r.normal(size=shape).astype(np.float32)
        out[k] = jnp.asarray(a, jnp.bfloat16 if dt == "bfloat16" else dt)
    return out


def _grads(step, scale):
    r = np.random.default_rng(100 + step)
    return {k: r.normal(size=shape).astype(np.float32) * scale
            for k, (shape, _) in SHAPES.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def rel_l2(got, want) -> float:
    g, w = _np(got), _np(want)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def assert_tree_close(got, want, rel=REL):
    g_leaves = tree_leaves(got)
    w_leaves = jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert tuple(g.shape) == tuple(np.shape(w))
        if str(np.asarray(w).dtype) == "bfloat16":
            # within one bf16 rounding of the reference, element by element
            wf = np.asarray(w, np.float32)
            ulp = np.spacing(np.abs(wf).astype(np.float32)) * 2.0 ** 16
            assert (np.abs(_np(g) - wf) <= ulp).all()
            continue
        assert rel_l2(g, w) <= rel, rel_l2(g, w)


def _to_torch(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_ten_steps_match_reference(grad_clip):
    jcfg = jadamw.AdamWConfig(lr=1e-2, grad_clip=grad_clip)
    cfg = AdamWConfig(lr=1e-2, grad_clip=grad_clip)
    jp = _params()
    js = jadamw.adamw_init(jp)
    p = _to_torch(jp)
    s = adamw_init(p)
    jsched = jschedule.linear_warmup_cosine(2, STEPS)
    sched = linear_warmup_cosine(2, STEPS)
    for i in range(STEPS):
        g = _grads(i, 0.5 + i)          # norms below and above the clip
        jg = {k: jnp.asarray(v, jp[k].dtype) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(p[k].dtype) for k, v in g.items()}
        jp, js, jn = jadamw.adamw_update(jcfg, jp, jg, js, jsched(js.step))
        p, s, n = adamw_update(cfg, p, tg, s, sched(s.step))
        assert rel_l2(n, jn) <= REL
    assert s.step.dtype == torch.int32 and int(s.step) == STEPS
    assert isinstance(s, OptState) and s._fields == js._fields
    assert all(m.dtype == torch.float32 for m in tree_leaves(s.mu))
    assert p["h"].dtype == torch.bfloat16
    assert_tree_close(p, jp)
    assert_tree_close((s.mu, s.nu), (js.mu, js.nu))


def test_adafactor_ten_steps_match_reference():
    jcfg = jadafactor.AdafactorConfig(lr=1e-2, weight_decay=0.01)
    cfg = AdafactorConfig(lr=1e-2, weight_decay=0.01)
    jp = _params(1)
    js = jadafactor.adafactor_init(jp)
    p = _to_torch(jp)
    s = adafactor_init(p)
    assert isinstance(s.slots["stack"], _Factored)
    assert isinstance(s.slots["b"], _Full)
    assert tuple(s.slots["stack"].vr.shape) == (3, 4)
    assert tuple(s.slots["stack"].vc.shape) == (3, 7)
    for i in range(STEPS):
        g = _grads(i, 1.0)
        jg = {k: jnp.asarray(v, jp[k].dtype) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(p[k].dtype) for k, v in g.items()}
        jp, js, jn = jadafactor.adafactor_update(jcfg, jp, jg, js, 0.5)
        p, s, n = adafactor_update(cfg, p, tg, s, 0.5)
        assert rel_l2(n, jn) <= REL
    assert isinstance(s, AfState) and int(s.step) == STEPS
    assert_tree_close(p, jp)
    assert_tree_close(s.slots, js.slots)


def test_opt_state_from_jax_continues_the_reference():
    """A JAX AdamW state carried across mid-run (int32 step, f32 moments)
    takes the port's next update to the reference's."""
    cfg, jcfg = AdamWConfig(), jadamw.AdamWConfig()
    jp = _params(2)
    js = jadamw.adamw_init(jp)
    for i in range(3):
        jg = jax.tree.map(jnp.asarray, _grads(i, 1.0))
        jg = {k: v.astype(jp[k].dtype) for k, v in jg.items()}
        jp, js, _ = jadamw.adamw_update(jcfg, jp, jg, js)
    s = opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    assert isinstance(s, OptState) and s.step.dtype == torch.int32
    p = _to_torch(jp)
    g = _grads(3, 1.0)
    jg = {k: jnp.asarray(v, jp[k].dtype) for k, v in g.items()}
    tg = {k: torch.from_numpy(v).to(p[k].dtype) for k, v in g.items()}
    jp, js, _ = jadamw.adamw_update(jcfg, jp, jg, js)
    p, s, _ = adamw_update(cfg, p, tg, s)
    assert_tree_close(p, jp)
    af = opt_state_from_jax(jax.tree.map(
        np.asarray, jadafactor.adafactor_init(jp)), "cpu")
    assert isinstance(af, AfState)
    assert isinstance(af.slots["w"], _Factored)
    assert isinstance(af.slots["b"], _Full)


@pytest.mark.parametrize("scale", [0.01, 0.3, 1.0, 7.0, 100.0])
def test_clip_by_global_norm_matches_reference(scale):
    g = {k: v * scale for k, v in _grads(0, 1.0).items()}
    jc, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tc, tn = clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    assert rel_l2(tn, jn) <= REL
    assert_tree_close(tc, jc)
    assert float(global_norm(tc)) <= 1.0 + 1e-4
    if float(tn) <= 1.0:      # small grads untouched
        for k in g:
            np.testing.assert_array_equal(tc[k].numpy(), g[k])


@pytest.mark.parametrize("name,args", [
    ("constant", (0.7,)), ("cosine_decay", (150,)),
    ("cosine_decay", (40, 0.0)), ("linear_warmup_cosine", (10, 100)),
    ("linear_warmup_cosine", (0, 60, 0.2))])
def test_schedules_match_reference_over_steps(name, args):
    jf = getattr(jschedule, name)(*args)
    tf = {"constant": constant, "cosine_decay": cosine_decay,
          "linear_warmup_cosine": linear_warmup_cosine}[name](*args)
    steps = np.arange(0, 201, dtype=np.int32)
    want = np.array([np.asarray(jf(jnp.asarray(s))) for s in steps])
    got = np.array([tf(torch.tensor(int(s), dtype=torch.int32)).item()
                    for s in steps])
    assert all(tf(int(s)).dtype == torch.float32 for s in steps[:3])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_adamw_converges_quadratic():
    """The port of tests/test_optim.py's convergence case."""
    params = {"w": torch.zeros(4, 4), "b": torch.zeros(4)}
    state = adamw_init(params)
    cfg = AdamWConfig(lr=0.3, weight_decay=0.0)
    for _ in range(200):
        grads = {k: 2.0 * (v - 3.0) for k, v in params.items()}
        params, state, _ = adamw_update(cfg, params, grads, state)
    assert sum(float(((v - 3.0) ** 2).sum()) for v in params.values()) < 1e-2


def test_state_trees_flatten_in_the_reference_order():
    """The port's OptState and AfState flatten to the reference's leaf
    order and shapes (what a checkpoint's leaf_{i} numbering relies on)."""
    jp = _params()
    p = _to_torch(jp)
    for jinit, init in ((jadamw.adamw_init, adamw_init),
                        (jadafactor.adafactor_init, adafactor_init)):
        want = [np.shape(x) for x in jax.tree.leaves((jp, jinit(jp)))]
        got = [tuple(x.shape) for x in tree_flatten((p, init(p)))[0]]
        assert got == want
