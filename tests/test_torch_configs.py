"""The port's configs against ``repro.configs``: every field of every
arch, full and reduced, with JAX dtypes mapped to torch's, and the serving
cache's shapes and dtypes."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.configs import all_arch_names as jall_arch_names
from repro.configs import get_config as jget_config
from repro.configs import kv_cache_specs as jkv_cache_specs
from repro_torch.configs import (ModelConfig, all_arch_names, get_config,
                                 kv_cache_specs)

DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}
ARCHS = jall_arch_names()


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_field_matches_reference(arch, reduced):
    jc, tc = jget_config(arch), get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    assert names == [f.name for f in dataclasses.fields(jc)]
    for name in names:
        want, got = getattr(jc, name), getattr(tc, name)
        if name in ("dtype", "param_dtype"):
            want = DTYPES[jnp.dtype(want)]
        elif dataclasses.is_dataclass(want):
            want, got = dataclasses.asdict(want), dataclasses.asdict(got)
        assert got == want, name
    for prop in ("head_dim_", "q_per_kv", "attention_free", "sub_quadratic"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    for i in range(tc.num_layers):
        assert tc.is_attention_layer(i) == jc.is_attention_layer(i)
        assert tc.is_moe_layer(i) == jc.is_moe_layer(i)
    if tc.ssm is not None:
        assert tc.ssm.num_heads(tc.d_model) == jc.ssm.num_heads(jc.d_model)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_kv_cache_specs_match_reference(arch, reduced):
    jc, tc = jget_config(arch), get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    want = jkv_cache_specs(jc, 4, 1024)
    got = kv_cache_specs(tc, 4, 1024)
    assert sorted(got) == sorted(want)
    for k, (shape, dtype) in got.items():
        assert shape == want[k].shape, k
        assert dtype == DTYPES[jnp.dtype(want[k].dtype)], k


def test_registry_matches_reference():
    assert all_arch_names() == ARCHS
    assert len(ARCHS) == 10
    for arch in ARCHS:
        assert get_config(arch).source == jget_config(arch).source


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
