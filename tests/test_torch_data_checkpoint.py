"""The port's data pipeline and checkpoints against the JAX package's:
``SyntheticLMDataset.batch_at`` bit-equal to the reference's over steps
and host splits, the prefetcher's resume, and checkpoints on the
reference's on-disk layout that cross between the packages in both
directions ((params, OptState) and (params, AfState) trees restore equal,
leaf for leaf), with the reference's cases of retention, uncommitted
steps, async save and shape mismatch. Equalities are exact."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.data import pipeline as jdata
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                    latest_step, restore, save)
from repro_torch.data import (DataConfig, SyntheticLMDataset, build_pipeline,
                              host_shard_slice)
from repro_torch.optim import adafactor_init, adamw_init
from repro_torch.tree import (flatten_up_to, tree_flatten, tree_leaves,
                              tree_map, tree_unflatten)
from repro_torch.weights import opt_state_from_jax, params_from_jax

# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hosts", [1, 2, 4])
@pytest.mark.parametrize("vocab,seq,seed", [(128, 16, 3), (50280, 33, 0)])
def test_batch_at_bit_equal_to_reference(hosts, vocab, seq, seed):
    for h in range(hosts):
        kw = dict(vocab_size=vocab, seq_len=seq, global_batch=4, seed=seed,
                  num_hosts=hosts, host_id=h)
        want = jdata.SyntheticLMDataset(jdata.DataConfig(**kw))
        got = SyntheticLMDataset(DataConfig(**kw))
        assert got.rows == want.rows
        for step in (0, 1, 7):
            w, g = want.batch_at(step), got.batch_at(step)
            assert sorted(g) == sorted(w) == ["targets", "tokens"]
            for k in w:
                assert g[k].dtype == w[k].dtype == np.int32
                np.testing.assert_array_equal(g[k], w[k])


def test_targets_are_shifted_tokens():
    b = SyntheticLMDataset(DataConfig(vocab_size=128, seq_len=16,
                                      global_batch=2)).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


@pytest.mark.parametrize("prefetch", [True, False])
def test_prefetcher_resumes_at_step(prefetch):
    cfg = DataConfig(vocab_size=64, seq_len=8, global_batch=2, seed=4)
    ds, it = build_pipeline(cfg, start_step=5, prefetch=prefetch)
    ref = jdata.SyntheticLMDataset(jdata.DataConfig(
        vocab_size=64, seq_len=8, global_batch=2, seed=4))
    try:
        for want_step in (5, 6, 7):
            step, batch = next(it)
            assert step == want_step
            np.testing.assert_array_equal(batch["tokens"],
                                          ref.batch_at(step)["tokens"])
    finally:
        if hasattr(it, "close"):
            it.close()


def test_host_shard_slice_rejects_uneven():
    assert host_shard_slice(12, 3, 1) == jdata.host_shard_slice(12, 3, 1)
    with pytest.raises(ValueError):
        host_shard_slice(10, 3, 0)


# ---------------------------------------------------------------------------
# Trees in jax.tree.flatten's order
# ---------------------------------------------------------------------------


def test_tree_flatten_matches_jax_order():
    tree = {"z": (1, [2, None, 3]), "a": {"y": 4, "b": 5},
            "m": jadamw.OptState(6, {"k": 7, "c": 8}, {"k": 9, "c": 10}),
            "n": None}
    leaves, td = tree_flatten(tree)
    assert leaves == jax.tree.leaves(tree)
    assert td.num_leaves == len(leaves)
    assert tree_unflatten(td, leaves) == tree
    assert tree_map(lambda x: x * 2, tree)["m"].mu == {"k": 14, "c": 16}
    assert flatten_up_to(tree_flatten({"a": 0, "b": 0})[1],
                         {"b": (1, 2), "a": [3]}) == [[3], (1, 2)]
    with pytest.raises(ValueError):
        tree_unflatten(td, leaves + [0])


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------


def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"w": torch.from_numpy(r.normal(size=(4, 3)).astype(np.float32)),
            "opt": {"mu": torch.from_numpy(
                r.normal(size=(4, 3)).astype(np.float32)),
                "step": torch.tensor(7, dtype=torch.int32)}}


def _assert_trees_equal(got, want):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_save_restore_roundtrip(tmp_path):
    cfg = CheckpointConfig(str(tmp_path))
    tree = _tree()
    path = save(cfg, 3, tree)
    assert path.name == "step_000000003"
    assert (tmp_path / "step_000000003.done").exists()
    assert sorted(p.name for p in path.iterdir()) == ["meta.json",
                                                      "shard_00000.npz"]
    meta = json.loads((path / "meta.json").read_text())
    assert meta["n_leaves"] == 3 and meta["step"] == 3
    step, got = restore(cfg, tree)
    assert step == 3
    _assert_trees_equal(got, tree)


def test_latest_step_ignores_uncommitted(tmp_path):
    cfg = CheckpointConfig(str(tmp_path))
    save(cfg, 1, _tree())
    (tmp_path / "step_000000009").mkdir()     # a crashed write: no .done
    assert latest_step(cfg) == 1
    assert latest_step(CheckpointConfig(str(tmp_path / "none"))) is None


def test_retention_keeps_newest_and_milestones(tmp_path):
    cfg = CheckpointConfig(str(tmp_path), keep=2, keep_every=10)
    for s in (5, 10, 15, 20, 25):
        save(cfg, s, _tree())
    steps = sorted(int(p.name[5:14]) for p in tmp_path.glob("step_*.done"))
    assert steps == [10, 20, 25]
    assert not (tmp_path / "step_000000005").exists()


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path)))
    tree = _tree(1)
    mgr.save_async(4, tree)
    tree["w"].zero_()           # the snapshot was taken before the write
    mgr.wait()
    step, got = mgr.restore(_tree(1))
    assert step == 4 and mgr.latest_step() == 4
    _assert_trees_equal(got, _tree(1))


def test_restore_shape_mismatch_raises(tmp_path):
    cfg = CheckpointConfig(str(tmp_path))
    save(cfg, 0, _tree())
    bad = _tree()
    bad["w"] = torch.zeros(5, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(cfg, bad)
    with pytest.raises(ValueError, match="leaves"):
        restore(cfg, {"w": torch.zeros(4, 3)})


def test_failure_recovery_reproduces_batches(tmp_path):
    cfg = DataConfig(vocab_size=64, seq_len=8, global_batch=2, seed=5)
    ds = SyntheticLMDataset(cfg)
    healthy = [ds.batch_at(s)["tokens"] for s in range(10)]
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path)))
    mgr.save(5, {"step": torch.tensor(5, dtype=torch.int32)})
    step, _ = mgr.restore({"step": torch.tensor(0, dtype=torch.int32)})
    resumed = [SyntheticLMDataset(cfg).batch_at(s)["tokens"]
               for s in range(step + 1, 10)]
    np.testing.assert_array_equal(np.stack(healthy[6:]), np.stack(resumed))


def _jax_state(kind, seed):
    """A reference (params, optimizer state) tree a few updates in, so the
    step and slots are not zeros."""
    r = np.random.default_rng(seed)
    params = {"embed": jnp.asarray(r.normal(size=(16, 4)), jnp.float32),
              "layers": {"p0": {"w": jnp.asarray(r.normal(size=(2, 4, 3)),
                                                 jnp.float32),
                                "ln": jnp.asarray(r.normal(size=(2, 4)),
                                                  jnp.float32)}}}
    if kind == "adamw":
        init = jadamw.adamw_init
        update = lambda p, g, s: jadamw.adamw_update(  # noqa: E731
            jadamw.AdamWConfig(), p, g, s)
    else:
        init = jadafactor.adafactor_init
        update = lambda p, g, s: jadafactor.adafactor_update(  # noqa: E731
            jadafactor.AdafactorConfig(), p, g, s)
    state = init(params)
    for i in range(2):
        g = jax.tree.map(lambda x: jnp.asarray(
            r.normal(size=x.shape), jnp.float32), params)
        params, state, _ = update(params, g, state)
    return params, state


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_checkpoint_written_by_jax_restores_in_port(tmp_path, kind):
    jparams, jstate = _jax_state(kind, 0)
    jckpt.save(jckpt.CheckpointConfig(str(tmp_path)), 2, (jparams, jstate))
    params = params_from_jax(jax.tree.map(np.zeros_like, jparams), "cpu")
    init = adamw_init if kind == "adamw" else adafactor_init
    step, (p, s) = restore(CheckpointConfig(str(tmp_path)),
                           (params, init(params)))
    assert step == 2 and int(s.step) == 2 and s.step.dtype == torch.int32
    assert type(s) is type(init(params))
    _assert_trees_equal((p, s), (
        params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
        opt_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_checkpoint_written_by_port_restores_in_jax(tmp_path, kind):
    jparams, jstate = _jax_state(kind, 1)
    tree = (params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
            opt_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu"))
    save(CheckpointConfig(str(tmp_path)), 6, tree)
    like = jax.tree.map(jnp.zeros_like, (jparams, jstate))
    step, got = jckpt.restore(jckpt.CheckpointConfig(str(tmp_path)), like)
    assert step == 6
    want = jax.tree.leaves((jparams, jstate))
    assert jax.tree.structure(got) == jax.tree.structure(like)
    for g, w in zip(jax.tree.leaves(got), want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))


def test_bf16_leaf_written_by_jax_restores_in_port(tmp_path):
    """np.savez stores the reference's bf16 leaf as 2-byte void (|V2); the
    reference's own restore cannot cast that back (ROADMAP Queue 3), the
    port reads it as bf16 bits. The port writes bf16 the same way."""
    r = np.random.default_rng(3)
    w = jnp.asarray(r.normal(size=(5, 4)), jnp.bfloat16)
    jcfg = jckpt.CheckpointConfig(str(tmp_path / "jax"))
    jckpt.save(jcfg, 0, {"w": w})
    with np.load(tmp_path / "jax" / "step_000000000" / "shard_00000.npz") \
            as z:
        assert z["leaf_0"].dtype == np.dtype("V2")
    with pytest.raises(ValueError, match="No cast function"):
        jckpt.restore(jcfg, {"w": w})
    want = params_from_jax({"w": np.asarray(w)}, "cpu")
    _, got = restore(CheckpointConfig(str(tmp_path / "jax")),
                     {"w": torch.zeros(5, 4, dtype=torch.bfloat16)})
    _assert_trees_equal(got, want)
    cfg = CheckpointConfig(str(tmp_path / "port"))
    save(cfg, 0, want)
    with np.load(tmp_path / "port" / "step_000000000" / "shard_00000.npz") \
            as z:
        assert z["leaf_0"].dtype == np.dtype("V2")
    _, back = restore(cfg, {"w": torch.zeros(5, 4, dtype=torch.bfloat16)})
    _assert_trees_equal(back, want)
