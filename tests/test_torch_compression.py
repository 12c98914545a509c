"""The port's gradient compression against the JAX package's.

The reference's four properties (tests/test_compression.py) on the port:
the per-block error bound, the payload cut, the error-feedback identity
and its unbiasedness over steps; and, on the same numpy inputs, ``q`` and
``scale`` equal to the reference's bit for bit (both round half to even),
the decompressed values and the new residuals too, at lengths that are and
are not a multiple of the block, with ties at exactly half a step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.distributed import compression as jc  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    Compressed, compress, decompress, decompress_tree, ef_compress_tree,
    init_residuals, payload_bytes, quantization_error)
from repro_torch.tree import tree_leaves  # noqa: E402


def _first(tree):
    return tree_leaves(tree, is_leaf=lambda t: isinstance(t, Compressed))[0]


@given(seed=st.integers(0, 100), scale=st.floats(1e-3, 1e3))
@settings(max_examples=25, deadline=None)
def test_quantization_error_bound(seed, scale):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(777,)) * scale).astype(np.float32))
    err = (x - decompress(compress(x))).abs().numpy()
    bound = x.abs().max().item() / 127.0
    assert err.max() <= bound + 1e-6


def test_payload_reduction():
    g = {"w": torch.ones(1024, 256)}
    c, _ = ef_compress_tree(g, init_residuals(g))
    raw = payload_bytes(g)
    assert raw == 1024 * 256 * 4
    assert payload_bytes(_first(c).q) < raw / 3.5          # ~4x smaller
    # the whole compressed tree: q and the f32 scales, not the shape
    assert payload_bytes(c) == 1024 * 256 + 1024 * 4


def test_payload_bytes_of_compressed_tree_fails_in_reference():
    """The reference's ``payload_bytes`` sums ``leaf.size`` over
    ``jax.tree.leaves``: a ``Compressed`` leaf's ``shape`` tuple yields plain
    ints, so it raises (ROADMAP Queue 3); the port counts q and the f32
    scales, not the shape."""
    x = np.random.default_rng(0).normal(size=(1024, 256)).astype(np.float32)
    with pytest.raises(AttributeError, match="'int' object has no "
                                             "attribute 'size'"):
        jc.payload_bytes(jc.compress(jnp.asarray(x)))
    assert payload_bytes(compress(torch.from_numpy(x))) \
        == 1024 * 256 + 1024 * 4


def test_error_feedback_accumulates_residual():
    """EF invariant: decompress(c) + new_residual == grads + old_residual."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(300,)).astype(np.float32))}
    r = init_residuals(g)
    c, r2 = ef_compress_tree(g, r)
    recon = decompress_tree(c)["w"]
    np.testing.assert_allclose((recon + r2["w"]).numpy(), g["w"].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_error_feedback_unbiased_over_steps():
    """Constant gradient: EF-compressed sum converges to the true sum."""
    g = {"w": torch.full((256,), 0.003)}
    r = init_residuals(g)
    total = torch.zeros(256)
    for _ in range(50):
        c, r = ef_compress_tree(g, r)
        total = total + decompress(_first(c))
    np.testing.assert_allclose(total.mean().item(), 50 * 0.003, rtol=0.02)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    ties = np.zeros(256, np.float32)
    ties[:4] = [127.0, 0.5, 1.5, -2.5]     # scale 1: q rounds half to even
    return {"a": (rng.normal(size=(3, 333)) * 1e-3).astype(np.float32),
            "b": {"c": rng.normal(size=(512,)).astype(np.float32),
                  "d": (rng.standard_cauchy(size=(7, 40))).astype(np.float32),
                  "ties": ties},
            "e": np.zeros((5,), np.float32)}


@pytest.mark.parametrize("block", [256, 64])
def test_matches_reference_bitwise(block):
    """q and scale equal the reference's exactly on the same numpy grads
    and residuals (3 x 333 and 7 x 40 are not block multiples; an all-zero
    leaf takes the 1e-12 scale floor), as do the decompressed values and
    the new residuals; two error-feedback steps, the second from the
    first's residuals."""
    grads, resid = _inputs(1), _inputs(2)
    jg = jax.tree.map(jnp.asarray, grads)
    jr = jax.tree.map(lambda a: jnp.asarray(a) * 1e-3, resid)
    tg = jax.tree.map(torch.from_numpy, grads)
    tr = jax.tree.map(lambda a: torch.from_numpy(a) * 1e-3, resid)
    for _ in range(2):
        jcomp, jr = jc.ef_compress_tree(jg, jr, block)
        tcomp, tr = ef_compress_tree(tg, tr, block)
        jleaves = jax.tree.leaves(jcomp, is_leaf=lambda t: isinstance(
            t, jc.Compressed))
        tleaves = tree_leaves(tcomp, is_leaf=lambda t: isinstance(
            t, Compressed))
        assert len(jleaves) == len(tleaves) == 5
        for j, t in zip(jleaves, tleaves):
            assert t.q.dtype == torch.int8 and t.scale.dtype == torch.float32
            assert t.shape == j.shape
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
            np.testing.assert_array_equal(t.scale.numpy(),
                                          np.asarray(j.scale))
            np.testing.assert_array_equal(decompress(t).numpy(),
                                          np.asarray(jc.decompress(j)))
        for j, t in zip(jax.tree.leaves(jr), tree_leaves(tr)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the ties alone (scale 1): half a step rounds to the even neighbour
    ties = grads["b"]["ties"]
    t, j = compress(torch.from_numpy(ties), block), jc.compress(
        jnp.asarray(ties), block)
    assert t.q[0, :4].tolist() == [127, 0, 2, -2]
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    x = torch.from_numpy(grads["b"]["d"])
    np.testing.assert_array_equal(
        quantization_error(x, block).numpy(),
        np.asarray(jc.quantization_error(jnp.asarray(grads["b"]["d"]),
                                         block)))
    assert payload_bytes(tg) == jc.payload_bytes(jg)
