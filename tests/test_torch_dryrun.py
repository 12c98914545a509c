"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

Every (arch x shape x production mesh) cell gets the status that the
reference's ``shape_applicable`` gives it, ``ok`` or ``skip``, never
``error`` (the decode cells too: a meta ``cache_index`` has no value); the
``model`` block is the reference's formula; the depth probe equals a
full-depth count exactly on reduced configs of three periods (dense,
hybrid, audio; train, prefill and decode); each modeled collective term
matches bytes worked out by hand on a small mesh; the reference's
``benchmarks/roofline.table`` reads the port's cells; the CLI writes one
JSON per cell and never imports JAX; an elastic re-mesh feeds a priced
cell. Behind ``-m slow``: the cells of jamba-1.5-large-398b's train_4k
and prefill_32k (about 20 s each: the SSD chunk loop on meta tensors) and
of mamba2-130m's (3-6 s each), jamba's train step in the probe test and
the whole CLI sweep. The comparison with the reference's compiled cells
is ``test_torch_dryrun_reference.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import shape_applicable as ref_shape_applicable
from repro_torch.configs import SHAPES, ShapeConfig, all_arch_names, get_config
from repro_torch.distributed.fault_tolerance import plan_elastic_remesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import layers

ROOT = Path(__file__).resolve().parents[1]
HEAVY = {("jamba-1.5-large-398b", "train_4k"),
         ("jamba-1.5-large-398b", "prefill_32k"),
         ("mamba2-130m", "train_4k"), ("mamba2-130m", "prefill_32k")}
MESH24 = Mesh(("data", "model"), (2, 4))
CELLS = [(a, s, multi) for a in all_arch_names() for s in SHAPES
         for multi in (False, True)]


def _check_status(arch, shape_name, multi):
    cell = dryrun.run_cell(arch, shape_name, multi)
    ok, reason = ref_shape_applicable(ref_get_config(arch),
                                      SHAPES[shape_name])
    assert cell["status"] == ("ok" if ok else "skip"), cell.get("error")
    if not ok:
        assert cell["reason"] == reason
        return cell
    mesh = make_production_mesh(multi_pod=multi)
    assert cell["mesh_shape"] == list(mesh.shape)
    assert cell["n_devices"] == mesh.size
    assert cell["flops_per_device"] > 0 and cell["bytes_per_device"] > 0
    r = cell["roofline"]
    assert r["dominant"] == max(("compute", "memory", "collective"),
                                key=lambda k: r[f"{k}_s"])
    assert cell["fits_hbm"] == (cell["per_device_hbm_bytes"]
                                <= dryrun.HBM_BYTES)
    return cell


@pytest.mark.parametrize("arch,shape_name,multi",
                         [c for c in CELLS if c[:2] not in HEAVY])
def test_cell_status_is_shape_applicable(arch, shape_name, multi):
    _check_status(arch, shape_name, multi)


@pytest.mark.slow
@pytest.mark.parametrize("arch,shape_name,multi",
                         [c for c in CELLS if c[:2] in HEAVY])
def test_heavy_cell_status_is_shape_applicable(arch, shape_name, multi):
    _check_status(arch, shape_name, multi)


@pytest.mark.parametrize("arch", all_arch_names())
def test_model_block_is_the_reference_formula(arch):
    """params, active params, tokens and model FLOPs per device, from the
    reference's config and its formula (dryrun.py:215-222)."""
    ref = ref_get_config(arch)
    for shape in SHAPES.values():
        for n_dev in (256, 512):
            got = dryrun.model_block(get_config(arch), shape, n_dev, 1e12)
            tokens = shape.global_batch * (
                shape.seq_len if shape.kind in ("train", "prefill") else 1)
            mult = 6.0 if shape.kind == "train" else 2.0
            want = mult * ref.active_param_count() * tokens / n_dev
            assert got == {"params": ref.param_count(),
                           "active_params": ref.active_param_count(),
                           "tokens": tokens,
                           "model_flops_per_device": want,
                           "useful_flop_ratio": want / 1e12}


def _three_periods(arch):
    cfg = get_config(arch).reduced()
    period = dryrun.layer_period(cfg)
    return dataclasses.replace(cfg, num_layers=3 * period,
                               encoder_layers=3 if cfg.encoder_layers else 0)


@pytest.mark.parametrize("arch,kind", [
    (arch, kind) if (arch, kind) != ("jamba-1.5-large-398b", "train")
    else pytest.param(arch, kind, marks=pytest.mark.slow)
    for arch in ("qwen2.5-14b", "jamba-1.5-large-398b", "whisper-base")
    for kind in ("train", "prefill", "decode")])
def test_probe_equals_full_depth_count(arch, kind):
    """The probe at one and two periods, extrapolated to three, against the
    step counted at three periods: FLOPs, bytes, outputs, aliases and every
    collective term exactly."""
    cfg = _three_periods(arch)
    shape = ShapeConfig("t", 32, 2, kind)
    mesh = MESH24
    probe = dryrun._probe(cfg, shape, mesh)
    full = dryrun._count(dataclasses.replace(cfg, exact_costs=True,
                                             unroll_stack=True), shape, mesh)
    for key in ("flops", "bytes", "output", "alias", "used", "terms"):
        assert probe[key] == full[key], key
    assert full["flops"] > 0 and full["bytes"] > 0


def test_probe_costs_is_cell_costs_at_full_depth():
    cfg = _three_periods("qwen2.5-14b")
    shape = ShapeConfig("t", 32, 2, "train")
    assert dryrun.probe_costs(cfg, shape, MESH24) == dryrun.cell_costs(
        dataclasses.replace(cfg, exact_costs=True), shape, MESH24)


def test_serving_temporaries_on_the_kernels_path():
    """A serving step's temporaries are counted on the kernels' path at full
    depth: a launch on meta tensors runs the kernel's ``check``, counts
    nothing and hands back its outputs' shapes, so a 32k prefill holds no
    (S, T) scores, where the ``exact_costs`` path that prices its FLOPs
    materializes them."""
    from repro_torch import kernels
    from repro_torch.kernels import ops
    q = torch.empty(2, 96, 4, 64, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(2, 96, 2, 64, dtype=torch.bfloat16, device="meta")
    before = {k: v for f in kernels.FAMILIES for k, v in f.launches.items()}
    out = ops.flash_attention(q, kv, kv)
    y = ops.matmul(q.reshape(768, 64),
                   torch.empty(64, 48, device="meta", dtype=torch.bfloat16))
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert y.is_meta and y.shape == (768, 48) and y.dtype == torch.bfloat16
    assert before == {k: v for f in kernels.FAMILIES
                      for k, v in f.launches.items()}
    cfg, mesh = get_config("qwen2.5-14b"), make_production_mesh()
    shape = SHAPES["prefill_32k"]
    probe = dryrun._probe(cfg, shape, mesh)
    card = dryrun.temporaries(cfg, shape, mesh, probe)
    assert card == dryrun._count(dataclasses.replace(
        cfg, use_pallas=True), shape, mesh, flops=False)["temp"]
    # one layer's f32 scores, (32, 8, 5, 32768, 32768) over 256 devices,
    # against the whole step's temporaries on the kernels' path
    scores = 32 * 40 * 32768 * 32768 * 4
    assert probe["temp"] > scores > 10 * card
    train = SHAPES["train_4k"]
    tprobe = dryrun._probe(cfg, train, mesh)
    assert dryrun.temporaries(cfg, train, mesh, tprobe) == tprobe["temp"]
    # reduced qwen2.5-14b: bf16 with a head dim of 16, which the flash
    # kernel refuses, so the serving step's are the probe's too
    small, t = get_config("qwen2.5-14b").reduced(), ShapeConfig("t", 64, 8,
                                                                 "prefill")
    sprobe = dryrun._probe(small, t, MESH24)
    assert dryrun.temporaries(small, t, MESH24, sprobe) == sprobe["temp"]


def test_meta_launch_checks_its_shapes():
    """On meta tensors a plain launch is the kernel's ``check`` and no more:
    what the card would refuse, the dry run refuses too."""
    from repro_torch.kernels import ops
    a = torch.empty(64, 20, dtype=torch.bfloat16, device="meta")
    b = torch.empty(20, 48, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no matmul route"):
        ops.matmul(a, b)        # K = 20: no tensor-core route
    q = torch.empty(1, 8, 2, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no flash route"):
        ops.flash_attention(q, q, q)      # bf16 takes D = 64 or 128
    with pytest.raises(RuntimeError, match="meta"):
        ops.matmul(a[:, :16], torch.empty(16, 48, dtype=torch.bfloat16))


def test_bytes_mode_by_hand():
    """The dispatch mode's count on a small function: each op that moves
    data reads its operands and writes its result once (a view moves
    nothing); the peak is the storages made under it alive at once, and
    the inputs read are recorded by their flat index."""
    x = torch.empty(8, 16, device="meta")                  # 512 B
    w = torch.empty(16, 32, dtype=torch.bfloat16, device="meta")   # 1 KiB
    unused = torch.empty(4, device="meta")

    def f(x, w, unused):
        y = x.to(torch.bfloat16) @ w          # convert 512 + 256; mm 256 +
        z = y.view(8, 2, 16).transpose(0, 1)  # 1024 + 512; views: 0
        return (z.float() * 2.0).sum()        # 512 + 1024; 1024 + 1024;
                                              # sum 1024 + 4
    mode = dryrun._BytesMode((x, w, unused))
    with mode:
        out = f(x, w, unused)
    assert mode.bytes == ((512 + 256) + (256 + 1024 + 512) + (512 + 1024)
                          + (1024 + 1024) + (1024 + 4))
    assert mode.used == {0, 1}
    # alive at once at most: y (512), z.float() (1024) and its product
    # (1024); the converted x (256) dies when f's first line ends
    assert mode.peak == 512 + 1024 + 1024
    assert mode.live == out.untyped_storage().nbytes() == 4


# ---------------------------------------------------------------------------
# Collective terms, by hand
# ---------------------------------------------------------------------------


def _terms(arch, kind, mesh=MESH24, **changes):
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    shape = ShapeConfig("t", 64, 8, kind)
    with dryrun.use_mesh(mesh):
        bundle = dryrun.make_step(cfg, mesh, shape)
    return {k: (t["op"], t["count"], t["bytes"], t["link"])
            for k, t in dryrun.collective_terms(cfg, shape, mesh,
                                                bundle).items()}


def test_train_terms_by_hand():
    """Reduced qwen2.5-14b (E 64, 4 heads / 2 kv heads of 16, d_ff 128,
    vocab 256, 2 layers, q/k/v biases, no remat) training on (data 2,
    model 4), B = 8, S = 64: per device B = 4, f32 masters, bf16
    activations.

    FSDP (embed over data), each leaf gathered over data to its model
    shard, forward and backward: embed (256, 64) as (64, 64) = 16384 B;
    lm_head the same; per layer stack wq (2, 64, 4, 16) as (2, 64, 1, 16)
    = 8192; wk, wv (kv heads 2 do not divide 4) 16384 each; wo 8192; wi,
    wg, wo of the MLP 16384 each: 131072 B, twice = 262144 B in 2 x (2 +
    7 x 2) = 32 gathers. Gradients: the data-sharded shards reduce-scatter
    (65536 B, 16 leaf slices); final_norm 256, bq 128, bk and bv 256 each,
    ln1 and ln2 512 each all-reduce over data: 2 x 1920 = 3840 B in 11.
    TP: the attention's and the MLP's output projections contract a
    model-sharded dim; under sequence parallelism each is a
    reduce-scatter of y / 4 and an all-gather of y, y = 4 x 64 x 64 x 2
    = 32768 B, 2 layers x 2 passes (forward, backward) x 2 projections:
    65536 and 262144 B. The vocab-sharded lookup all-reduces 4 x 64 x 64
    x 2 B (x2 = 65536), the cross-entropy 3 f32 per token (x2 = 6144).
    Every group lies within one node of 8: NVLink."""
    assert _terms("qwen2.5-14b", "train") == {
        "fsdp_all_gather": ("all-gather", 32, 262144, "nvlink"),
        "grad_reduce_scatter": ("reduce-scatter", 16, 65536, "nvlink"),
        "grad_all_reduce": ("all-reduce", 11, 3840, "nvlink"),
        "tp_reduce_scatter": ("reduce-scatter", 8, 65536, "nvlink"),
        "tp_all_gather": ("all-gather", 8, 262144, "nvlink"),
        "vocab_embed_all_reduce": ("all-reduce", 1, 65536, "nvlink"),
        "vocab_logits_all_reduce": ("all-reduce", 3, 6144, "nvlink"),
    }
    # with remat the forward runs twice: the TP terms x 3/2
    remat = _terms("qwen2.5-14b", "train", remat=True)
    assert remat["tp_all_gather"] == ("all-gather", 12, 393216, "nvlink")


def test_serving_terms_by_hand():
    """Decode on (2, 4): one token (S = 1, no sequence parallelism), so
    each model-sharded contraction all-reduces its output: the attention's
    and the MLP's wo y = 4 x 1 x 64 x 2 = 512 B (x2), 2 layers: 4096 B;
    wk and wv, whose 2 kv heads do not divide 4, fall back to their embed
    dim over model (serving_param_shardings): k and v of 4 x 1 x 32 x 2 =
    256 B (x2), 2 layers: 2048 B; the lookup 512 x 2 = 1024. Prefill (S =
    64): the wo's reduce-scatter 4 x 8192 and all-gather 4 x 32768, k and
    v 4 x 64 x 32 x 2 (x2) x 4 = 131072, the lookup 65536. Reduced
    qwen3-moe's prefill: experts over data
    (INFER_PARAM_RULES), capacity max(4, ceil(64 x 2 / 4 x 1.25)) = 40, a
    dispatch and a combine buffer of 4 x 4 experts x 40 x 64 x 2 = 81920 B
    a layer: 2 layers x 2 x 81920 = 327680 B in 4 all-to-alls."""
    assert _terms("qwen2.5-14b", "decode") == {
        "tp_all_reduce": ("all-reduce", 8, 4096 + 2048, "nvlink"),
        "vocab_embed_all_reduce": ("all-reduce", 1, 1024, "nvlink"),
    }
    assert _terms("qwen2.5-14b", "prefill") == {
        "tp_all_reduce": ("all-reduce", 4, 131072, "nvlink"),
        "tp_reduce_scatter": ("reduce-scatter", 4, 32768, "nvlink"),
        "tp_all_gather": ("all-gather", 4, 131072, "nvlink"),
        "vocab_embed_all_reduce": ("all-reduce", 1, 65536, "nvlink"),
    }
    moe = _terms("qwen3-moe-30b-a3b", "prefill")
    assert moe["moe_all_to_all"] == ("all-to-all", 4, 327680, "nvlink")


def test_serving_fallback_terms_by_hand():
    """On (1, 8) the 4 heads do not divide the model axis: the serving
    fallback shards the embed dim of wq, wk, wv and wo over it. wq, wk and
    wv contract it: all-reduce of q (8 x 1 x 4 x 16 x 2 = 1024 B) and of k
    and v (2 kv heads: 512 B each), x2, 2 layers: 8192 B; wo writes the
    residual stream sharded: all-gather of y = 8 x 64 x 2 = 1024 B, 2
    layers; the MLP's wo contracts mlp over model: all-reduce of 1024 B x2
    x 2 layers = 4096 B. Groups of 8 consecutive devices: NVLink; on 16,
    InfiniBand."""
    mesh = Mesh(("data", "model"), (1, 8))
    assert _terms("qwen2.5-14b", "decode", mesh) == {
        "tp_all_reduce": ("all-reduce", 8, 8192 + 4096, "nvlink"),
        "tp_all_gather": ("all-gather", 2, 2048, "nvlink"),
        "vocab_embed_all_reduce": ("all-reduce", 1, 2048, "nvlink"),
    }
    assert dryrun.link(Mesh(("data", "model"), (1, 16)), ["model"]) == "ib"
    prod = make_production_mesh()
    assert dryrun.link(prod, ["model"]) == dryrun.link(prod, ["data"]) == "ib"
    assert dryrun.link(Mesh(("pod", "data", "model"), (2, 2, 2)),
                       ["pod", "data", "model"]) == "nvlink"


def test_collective_seconds_by_link():
    terms = {"a": {"op": "all-gather", "count": 1, "bytes": 450e9,
                   "link": "nvlink"},
             "b": {"op": "all-reduce", "count": 2, "bytes": 100e9,
                   "link": "ib"}}
    assert dryrun.collective_seconds(terms) == pytest.approx(1.0 + 2.0)
    coll = dryrun.collectives(terms)
    assert coll["all-gather"] == {"count": 1, "bytes": 450e9}
    assert coll["all-reduce"] == {"count": 2, "bytes": 100e9}
    assert coll["total_bytes"] == 550e9


# ---------------------------------------------------------------------------
# Decode on meta; the cache write on real tensors
# ---------------------------------------------------------------------------


def _write_cache_before(cache, kv, index):
    """``_write_cache`` as it was before the meta path (the card path)."""
    idx = torch.as_tensor(index, device=cache.device)
    if idx.ndim == 1:
        T = cache.shape[1]
        onehot = (torch.arange(T, device=cache.device)[None, :]
                  == idx[:, None])
        return torch.where(onehot[:, :, None, None], kv.to(cache.dtype),
                           cache)
    n = kv.shape[1]
    start = min(max(int(idx), 0), cache.shape[1] - n)
    out = cache.clone()
    out[:, start:start + n] = kv.to(cache.dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_write_cache_unchanged_on_real_tensors(dtype):
    g = torch.Generator().manual_seed(0)
    cache = torch.randn(3, 16, 2, 8, generator=g).to(dtype)
    for n in (1, 3):
        kv = torch.randn(3, n, 2, 8, generator=g)
        for index in (0, 5, 15, 20, -2, torch.tensor(7, dtype=torch.int32),
                      torch.tensor(15)):
            got = layers._write_cache(cache, kv, index)
            want = _write_cache_before(cache, kv, index)
            assert got.dtype == want.dtype
            assert torch.equal(got.view(torch.int16 if dtype ==
                                        torch.bfloat16 else torch.int32),
                               want.view(torch.int16 if dtype ==
                                         torch.bfloat16 else torch.int32))
    kv = torch.randn(3, 1, 2, 8, generator=g)
    slots = torch.tensor([0, 9, 15])
    assert torch.equal(layers._write_cache(cache, kv, slots),
                       _write_cache_before(cache, kv, slots))


def test_write_cache_on_meta_index():
    cache = torch.empty(3, 16, 2, 8, device="meta", dtype=torch.bfloat16)
    kv = torch.empty(3, 1, 2, 8, device="meta")
    out = layers._write_cache(cache, kv,
                              torch.empty((), dtype=torch.int32,
                                          device="meta"))
    assert out.is_meta and out.shape == cache.shape
    assert out.dtype == cache.dtype


def test_decode_32k_cells_price():
    """Every decode_32k cell of qwen2.5-14b prices; its arguments are the
    bf16 weights' and cache's shards (plus the tokens and the index)."""
    cell = dryrun.run_cell("qwen2.5-14b", "decode_32k", False)
    assert cell["status"] == "ok", cell.get("error")
    cfg = get_config("qwen2.5-14b")
    # cache: 48 layers x 128 x 32768 x 8 kv heads x 128, bf16, k and v,
    # batch over data (16) and the sequence over model (16)
    cache = 2 * 48 * 128 * 32768 * 8 * 128 * 2 // 256
    assert cell["memory"]["argument_size_in_bytes"] > cache
    assert cell["memory"]["alias_size_in_bytes"] == cache
    assert cell["model"]["tokens"] == 128
    assert cell["model"]["params"] == cfg.param_count()


# ---------------------------------------------------------------------------
# Readers, the CLI, the elastic re-mesh
# ---------------------------------------------------------------------------


def test_reference_roofline_table_reads_port_cells():
    from benchmarks.roofline import pick_hillclimb, table
    cells = [dryrun.run_cell("qwen2.5-14b", "decode_32k", False),
             dryrun.run_cell("mamba2-130m", "long_500k", False),
             dryrun.run_cell("qwen2.5-14b", "long_500k", False)]
    rows = table(cells)
    assert [r["shape"] for r in rows] == ["decode_32k", "long_500k",
                                         "long_500k"]
    assert rows[0]["fraction"] == cells[0]["fraction"] > 0
    assert rows[0]["hbm_GiB"] == cells[0]["per_device_hbm_bytes"] / 2 ** 30
    assert rows[2]["note"].startswith("skip(full-attn)")
    assert pick_hillclimb(cells)["worst_fraction"] in (
        "qwen2.5-14b/decode_32k", "mamba2-130m/long_500k")
    # the port's fraction is at H100 rates, beside the reference's own
    ideal = cells[0]["model"]["model_flops_per_device"] / 989e12
    assert cells[0]["fraction"] == pytest.approx(
        ideal / cells[0]["step_bound_s"])


CLI = r"""
import json, sys
from repro_torch.launch.dryrun import main
rc = main(["--arch", "mamba2-130m", "--shape", "long_500k", "--mesh",
           "both", "--out", sys.argv[1]])
rc2 = main(["--arch", "whisper-base", "--shape", "long_500k", "--mesh",
            "single", "--out", sys.argv[1]])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
print(json.dumps({"rc": [rc, rc2], "bad": bad}))
"""


def test_cli_writes_cells_and_imports_no_jax(tmp_path):
    run = subprocess.run([sys.executable, "-c", CLI, str(tmp_path)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={**os.environ,
                                        "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out == {"rc": [0, 0], "bad": []}
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == ["mamba2-130m__long_500k__multi.json",
                     "mamba2-130m__long_500k__single.json",
                     "whisper-base__long_500k__single.json"]
    cells = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    assert cells[names[0]]["status"] == cells[names[1]]["status"] == "ok"
    assert cells[names[0]]["mesh_shape"] == [2, 16, 16]
    assert cells[names[2]]["status"] == "skip"


@pytest.mark.slow
def test_cli_full_sweep_matches_shape_applicable(tmp_path):
    """``python -m repro_torch.launch.dryrun --all --mesh both``: one JSON
    per cell, each ``ok`` or ``skip`` where the reference's
    ``shape_applicable`` says so; exits 0."""
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--all", "--mesh", "both", "--out", str(tmp_path)],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT, env={**os.environ,
                                        "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert len(list(tmp_path.glob("*.json"))) == len(CELLS)
    for arch, shape_name, multi in CELLS:
        tag = "multi" if multi else "single"
        cell = json.loads((tmp_path / f"{arch}__{shape_name}__{tag}.json")
                          .read_text())
        ok, _ = ref_shape_applicable(ref_get_config(arch), SHAPES[shape_name])
        assert cell["status"] == ("ok" if ok else "skip")


def test_elastic_plan_feeds_a_remeshed_cell():
    """One host of 64 (4 devices each) lost on (16, 16): the plan halves
    the data axis to (8, 16) and the batch to 128; the port prices
    qwen2.5-14b's train_4k there. The FSDP shards of the parameters
    double, and the per-device tokens stay as they were."""
    plan = plan_elastic_remesh((16, 16), ("data", "model"), list(range(64)),
                               [3], devices_per_host=4, global_batch=256)
    assert plan.new_mesh_shape == (8, 16) and plan.new_global_batch == 128
    cell = dryrun.remesh_cell("qwen2.5-14b", "train_4k", plan)
    base = dryrun.run_cell("qwen2.5-14b", "train_4k", False)
    assert cell["status"] == "ok" and cell["mesh"] == "remesh"
    assert cell["mesh_shape"] == [8, 16] and cell["n_devices"] == 128
    assert cell["model"]["tokens"] == 128 * 4096
    assert (cell["model"]["model_flops_per_device"]
            == base["model"]["model_flops_per_device"])
    fsdp = cell["collective_terms"]["fsdp_all_gather"]["bytes"]
    assert fsdp == base["collective_terms"]["fsdp_all_gather"]["bytes"]
    assert (cell["memory"]["argument_size_in_bytes"]
            > base["memory"]["argument_size_in_bytes"])
