"""The port's ServingEngine on reduced qwen3-moe-30b-a3b (MoE every layer)
and jamba-1.5-large-398b (mamba2 and attention mixers, MoE every other
layer), f32, against the JAX package's engine: the same greedy tokens for
the same prompts and parameters (carried across through numpy), 4
requests over 3 slots, the port on its use_pallas path (the kernels'
plain versions on the CPU). Each slot decodes as its own MoE dispatch
group, as in the reference; every routing call is clear of a near-tie
(``tests/_torch_routing.py``). And the audio family, which neither engine
serves: whisper's engine refuses it in the port, as the reference's fails
in its encoder."""
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
from tests._torch_routing import clear_routing


def _serve(eng, prompts):
    reqs = [eng.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, (2, 4, 3, 3))]
    eng.run_until_idle()
    assert all(r.done and not r.shed for r in reqs)
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "jamba-1.5-large-398b"])
def test_greedy_tokens_match_reference_engine(arch):
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               dtype=jnp.float32)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              dtype=torch.float32, use_pallas=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    # one prompt length (the reference compiles a prefill for each); the
    # fourth request waits for a slot, so the slots' lengths differ
    prompts = [rng.integers(0, cfg.vocab_size, size=7).astype(np.int32)
               for _ in range(4)]
    want = _serve(JServingEngine(jmodel, jparams,
                                 JServingConfig(capacity=3, max_len=48)),
                  prompts)
    with clear_routing():
        got = _serve(ServingEngine(build_model(cfg), params,
                                   ServingConfig(capacity=3, max_len=48)),
                     prompts)
    assert got == want


def test_audio_engine_raises_in_both_packages():
    """The reference's engine prefills without frame embeddings and fails
    in the encoder; the port's says so when it is built."""
    jcfg = jget_config("whisper-base").reduced()
    jmodel = jbuild_model(jcfg)
    jeng = JServingEngine(jmodel, jmodel.init(jax.random.PRNGKey(0)),
                          JServingConfig(capacity=2, max_len=32))
    jeng.submit(np.arange(4, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(AttributeError):
        jeng.run_until_idle()
    model = build_model(get_config("whisper-base").reduced())
    with pytest.raises(NotImplementedError, match="frame embeddings"):
        ServingEngine(model, model.init(0, device="cpu"),
                      ServingConfig(capacity=2, max_len=32))
