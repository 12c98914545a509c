"""The port's ServingEngine on reduced mamba2-130m and qwen2.5-14b (f32)
against the JAX package's: the same greedy tokens for the same prompts and
parameters (carried across through numpy), continuous batching equal to
sequential decoding, and the same EDF admission and deadline-shed
decisions on an injected clock."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.transformer import build_model as jbuild_model
from repro.serving import ServingConfig as JServingConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.models.transformer import build_model
from repro_torch.serving import ServingConfig, ServingEngine
from repro_torch.weights import params_from_jax


@pytest.fixture(scope="module", params=["mamba2-130m", "qwen2.5-14b"])
def setup(request):
    arch = request.param
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               dtype=jnp.float32)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    # the port on its kernel path (the plain versions on the CPU)
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              dtype=torch.float32, use_pallas=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 7, 6)]          # 4 requests > 3 slots
    return jmodel, jparams, build_model(cfg), params, prompts


def _serve(eng, prompts, n=5):
    reqs = [eng.submit(p, max_new_tokens=n) for p in prompts]
    eng.run_until_idle()
    assert all(r.done and not r.shed for r in reqs)
    return [r.tokens for r in reqs]


def test_greedy_tokens_match_reference_engine(setup):
    jmodel, jparams, model, params, prompts = setup
    want = _serve(JServingEngine(jmodel, jparams,
                                 JServingConfig(capacity=3, max_len=48)),
                  prompts)
    got = _serve(ServingEngine(model, params,
                               ServingConfig(capacity=3, max_len=48)),
                 prompts)
    assert got == want


def test_continuous_batching_matches_sequential(setup):
    _, _, model, params, prompts = setup
    got = _serve(ServingEngine(model, params,
                               ServingConfig(capacity=3, max_len=48)),
                 prompts)
    for toks, p in zip(got, prompts):
        seq = list(p)
        for _ in range(5):
            logits, _ = model.forward_train(params,
                                            torch.tensor([seq]).long())
            seq.append(int(torch.argmax(logits[0, -1])))
        assert toks == seq[len(p):]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _edf_scenario(make):
    """EDF admission past a lax request, then a queued request shed at its
    deadline while a long one holds the only slot. Returns the decisions
    after every step."""
    clk = _FakeClock()
    eng = make(clk)
    p = np.arange(4, dtype=np.int32)
    lax_r = eng.submit(p, max_new_tokens=2, timeout=100.0)
    tight = eng.submit(p, max_new_tokens=2, timeout=5.0)
    log = []

    def note():
        log.append((clk.t, [(r.rid, r.done, r.shed, len(r.tokens))
                            for r in reqs],
                    sorted(r.rid for r in eng.queue), eng.n_active))

    reqs = [lax_r, tight]
    eng.step()
    note()
    held = eng.submit(p, max_new_tokens=40)
    reqs.append(held)
    eng.step()
    eng.step()
    note()
    starved = eng.submit(p, max_new_tokens=2, timeout=5.0)
    reqs.append(starved)
    clk.t = 6.0
    eng.step()
    note()
    eng.run_until_idle()
    note()
    return log, [r.tokens for r in reqs]


def test_edf_and_deadline_decisions_match_reference(setup):
    jmodel, jparams, model, params, _ = setup
    want = _edf_scenario(lambda clk: JServingEngine(
        jmodel, jparams, JServingConfig(capacity=1, max_len=48), clock=clk))
    got = _edf_scenario(lambda clk: ServingEngine(
        model, params, ServingConfig(capacity=1, max_len=48), clock=clk))
    assert got == want
    log, _ = got
    # EDF: the tight request took the slot first and finished
    assert log[0][1][1] == (1, True, False, 2)
    # the starved request was shed at its deadline, without a prefill
    assert log[2][1][3][2] is True and log[2][1][3][3] == 0
