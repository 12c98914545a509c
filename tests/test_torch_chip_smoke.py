"""chip_smoke.py's phases rehearsed on the CPU at a tiny width: the kernel
wrappers take their plain versions there, so every comparison passes
exactly and the launch-count guards find no kernel launched."""
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402


def test_phases_on_cpu_at_reduced_width():
    dev = torch.device("cpu")
    cfg = get_config("qwen2.5-14b").reduced()
    small = cs.small_cases(dev)
    assert sum(lb.startswith("ssd") for lb in small) == 3
    for label, (desc, args) in small.items():
        errs, _ = cs.check_forms(label, desc, args, "small")
        assert errs == {"plain": 0.0, "sliced": 0.0, "persistent": 0.0}
    # the SSD BE job needs more blocks than the CPU's 8 SMs for the sliced
    # and persistent configs to be candidates: B = 16
    ssd = cs.ssd_full_cases(get_config("mamba2-130m").reduced(), dev,
                            seqs=(64, 40, 37, 20, 16), batch_be=16,
                            seq_be=64)
    assert [d.static["L"] for d, _ in ssd.values()] == [32, 20, 1, 20, 16, 32]
    cases = {**cs.full_cases(cfg, dev, seq_hp=32, tokens_be=64, seq_be=64),
             **ssd}
    refs = {}
    for label, (desc, args) in cases.items():
        _, refs[label] = cs.check_forms(label, desc, args, desc.kernel.name)
        b_ms, by = cs.bound(desc)
        assert b_ms > 0 and by in ("bytes", "operations")
        assert (cs.library_fn(label, desc, args, cfg.num_heads) is None) \
            == label.startswith("ssd")
    # the edges of the tensor-core route: every one a bf16 launch that the
    # route takes, rehearsed through its plain version
    from repro_torch.kernels.launch import TENSOR_CORES
    for label, (desc, args) in cs.tc_cases(dev).items():
        assert desc.kernel.route(desc, args) == TENSOR_CORES, label
        errs, _ = cs.check_forms(label, desc, args, desc.kernel.name)
        assert errs == {"plain": 0.0, "sliced": 0.0, "persistent": 0.0}
    # BE work far beyond what the HP requests leave gaps for; the plain
    # versions count no launch, so the guard at the end must fire
    with pytest.raises(AssertionError, match="never launched"):
        cs.server_phase(cfg, cases, refs, dev, S=32, be_iters=150)


def test_model_phase_on_cpu_at_reduced_width():
    """Phase 5 at reduced mamba2 width: every request answered, the kernel
    path equal to the torch-ops path, and the guard firing because the
    plain versions launch nothing."""
    cfg = get_config("mamba2-130m").reduced()
    with pytest.raises(AssertionError, match="never launched"):
        cs.model_phase(cfg, torch.device("cpu"), prompts=(64, 40, 37, 20),
                       new_tokens=3, capacity=2, max_len=80)


def test_dense_phase_on_cpu_at_reduced_width(capsys):
    """Phase 6 at reduced qwen2.5-14b width: every request answered, the
    three prefill gates passed for every prompt (the prime 37 among them:
    bm = bq = 1), the kernels held against their plain versions at every
    serving shape through the comparison the card runs (``time_cases``,
    untimed on the CPU), and the launch-count guard firing because the
    plain versions launch nothing."""
    cfg = get_config("qwen2.5-14b").reduced()
    prompts = (64, 40, 37, 20)
    with pytest.raises(AssertionError, match="fewer times than the dense"):
        cs.dense_phase(cfg, torch.device("cpu"), prompts=prompts,
                       new_tokens=3, capacity=2, max_len=80,
                       f32_prompts=prompts)
    out = capsys.readouterr().out
    gated = [ln for ln in out.splitlines() if "bf16 layer-1 k" in ln]
    assert len(gated) == len(prompts)
    assert all(" ok;" in ln and "f32 layer by layer" in ln
               and "kernels vs plain versions" in ln for ln in gated), gated
    for M in (*prompts, 2):
        for proj in ("up", "down"):
            assert (f"mm_serve_{proj}_m{M} plain: max_abs=0.000e+00"
                    in out), (proj, M)
    for S in prompts:
        assert f"flash_serve_s{S} plain: max_abs=0.000e+00" in out, S
    assert "kernel not timed" in out
    assert "greedy tokens equal to the torch-ops path's" in out


def test_emulated_tensor_cores_round_apart_from_plain_versions():
    """Gate (c)'s CPU rehearsal: the emulated kernels agree with the plain
    versions to bf16 rounding on one reduced layer, and differ from them
    (the emulation is in force inside its block and gone after it)."""
    import dataclasses

    from repro_torch.kernels.matmul import MATMUL
    from repro_torch.models.transformer import build_model
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              use_pallas=True, dtype=torch.bfloat16)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, 37)))
    errs = cs.layerwise(model, model, params, x, 2,
                        kern_ctx=cs.emulated_tensor_cores)
    assert 0 < max(errs) < 5e-2, errs
    assert cs.layerwise(model, model, params, x, 2,
                        ref_ctx=cs.plain_versions) == [0.0, 0.0, 0.0]
    assert "plain" not in vars(MATMUL)


def test_route_guards():
    """A bf16 launch counted on a CUDA-core entry point fails the run; the
    main path's entry points are the tensor-core ones and the SSD's."""
    from repro_torch import kernels
    counts = {k: 0 for fam in kernels.FAMILIES for k in fam.launches}
    cs.cuda_core_guard(counts, "main path")
    assert cs.main_path_symbols() == [
        f"{n}_{f}" for n in ("matmul", "flash", "ssd")
        for f in ("plain", "sliced", "persistent")]
    counts["flash_fma_sliced"] = 1
    with pytest.raises(AssertionError, match="CUDA-core route"):
        cs.cuda_core_guard(counts, "main path")


def test_p_rounding_slack():
    """The flash gate's allowance for P rounded to bf16: 2^-8 max|v| over
    the square root of the keys each query row attends; none for f32 or
    another family."""
    from repro_torch.kernels.flash_attention import flash_attention_desc
    from repro_torch.kernels.matmul import matmul_desc
    bf = torch.bfloat16
    v = torch.zeros(2, 16, 64, dtype=bf)
    v[0, 3, 5] = -4.0
    args = (torch.zeros(4, 8, 64, dtype=bf), torch.zeros_like(v), v)
    d = flash_attention_desc(4, 8, 16, 64, 2, bf, causal=True, q_offset=4)
    got = cs.p_rounding_slack(d, args)
    n = torch.arange(8) + 5.0
    assert got.shape == (1, 8, 1)
    torch.testing.assert_close(got[0, :, 0], 2.0 ** -8 * 4.0 / n.sqrt())
    d = flash_attention_desc(4, 8, 16, 64, 2, bf, causal=False)
    torch.testing.assert_close(cs.p_rounding_slack(d, args)[0, :, 0],
                               torch.full((8,), 2.0 ** -8))
    assert cs.p_rounding_slack(
        flash_attention_desc(4, 8, 16, 64, 2, causal=False),
        tuple(t.float() for t in args)) == 0.0
    assert cs.p_rounding_slack(matmul_desc(8, 8, 8, bf),
                               (torch.zeros(8, 8, dtype=bf),) * 2) == 0.0


def test_bound_counts_each_ssd_tensor_once():
    """The SSD's bound moves each tensor of the launch once: x, dt, A, B, C
    and D read, y and the f32 state h written (the descriptor keeps the
    reference's count, without h and with dt at x's itemsize). The
    matmul's and flash's bounds stay the descriptor's."""
    from repro_torch.kernels.flash_attention import flash_attention_desc
    from repro_torch.kernels.mamba2_scan import mamba2_scan_desc
    from repro_torch.kernels.matmul import matmul_desc
    bf = torch.bfloat16
    be = mamba2_scan_desc(264, 512, 24, 64, 128, 256, bf)
    hp = mamba2_scan_desc(1, 512, 24, 64, 128, 256, bf)
    assert cs.launch_bytes(be) == 1_120_272_576
    assert be.bytes_accessed == 906_166_272
    assert cs.bound(be) == (pytest.approx(0.33441, rel=1e-4), "bytes")
    assert cs.launch_bytes(hp) == 4_243_648
    assert cs.bound(hp) == (pytest.approx(1.2668e-3, rel=1e-4), "bytes")
    for d in (matmul_desc(4096, 5120, 13824, bf),
              matmul_desc(512, 13824, 5120, bf),
              flash_attention_desc(80, 2048, 2048, 128, 5, bf),
              flash_attention_desc(40, 512, 512, 128, 5, bf)):
        t_ops = d.flops / cs.PEAK_BF16_FLOPS * 1e3
        t_bytes = d.bytes_accessed / cs.PEAK_BYTES * 1e3
        assert cs.launch_bytes(d) == d.bytes_accessed
        assert cs.bound(d) == (max(t_ops, t_bytes), "operations"
                               if t_ops >= t_bytes else "bytes")


def test_training_gates_on_cpu_at_reduced_width(tmp_path, capsys):
    """Phase 7's gates (a)-(c) on the CPU at reduced mamba2 width: the
    gradient comparison (the CPU against itself: exactly equal), the
    training gate and the restart gate (bit-exact on the CPU)."""
    dev = torch.device("cpu")
    cfg = get_config("mamba2-130m").reduced()
    assert cs.grad_gate(cfg, dev, dev, batch=2, seq=64) == (0.0, 0.0)
    cs.train_gate(dev, steps=12, batch=4, seq=32, reduced=True)
    cs.restart_gate(dev, tmp_path / "ck", batch=2, seq=32, reduced=True)
    out = capsys.readouterr().out
    assert "(a) mamba2-130m cut to 2 layers" in out and "] ok (" in out
    assert "(b) train('mamba2-130m', reduced=True" in out
    assert "(c) 8 steps straight vs 4 + checkpoint + resume" in out
    assert "bit-equal True" in out
    assert not (tmp_path / "ck").exists()


def test_colocation_gate_on_cpu_at_reduced_width(capsys):
    """Phase 7 (d) at reduced mamba2 width: the HP tokens equal with and
    without the BE trainer, exactly 5 quanta taken between the waves, and
    the launch-count guard firing because the plain versions launch
    nothing."""
    cfg = get_config("mamba2-130m").reduced()
    with pytest.raises(AssertionError, match="not every HP prefill"):
        cs.colocation_gate(cfg, torch.device("cpu"), prompts=(64, 40, 37, 20),
                           new_tokens=3, capacity=2, max_len=80, be_batch=2,
                           be_seq=32)
    out = capsys.readouterr().out
    assert "HP tokens equal in 4/4 requests" in out
    assert "5 BE quanta between them" in out and "ok" in out
    assert "HP co-located: TTFT p50" in out


def test_moe_phase_on_cpu_at_reduced_width(capsys):
    """Phase 8 (a) at reduced qwen3-moe width, cut to 2 layers: every
    request answered, the three gates passed for every prompt (the prime
    37 among them: bq = 1, one layer against the plain versions), flash
    held against its plain version at each served length, and the
    launch-count guard firing because the plain versions launch
    nothing."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    prompts = (64, 40, 37, 20)
    with pytest.raises(AssertionError, match="flash_plain launched 0 times"):
        cs.moe_phase(cfg, torch.device("cpu"), prompts=prompts,
                     new_tokens=3, capacity=2, max_len=80, layers=2)
    out = capsys.readouterr().out
    gated = [ln for ln in out.splitlines() if "(b) bf16 layer by layer" in ln]
    assert len(gated) == len(prompts)
    assert all(ln.endswith(" s") and " ok; " in ln
               and "(a) f32 layer by layer" in ln for ln in gated), gated
    assert "2 of 2 layers" in out
    assert all("(c) bf16 kernels vs plain versions, 2 layers" in ln
               for ln in gated)
    # at full width the prime length takes one layer against the plain
    # versions (bq = 1)
    full = get_config("qwen3-moe-30b-a3b")
    assert [cs.flash_bq(full, S) for S in cs.PROMPTS] == [256, 150, 1, 100,
                                                          64, 256]
    for S in prompts:
        assert f"flash_moe_s{S} plain: max_abs=0.000e+00" in out, S
    assert ("ServingEngine first tokens equal to the kernel path's own "
            "prefill: 4/4 [all] ok") in out
    assert all("logits through the whole prefill: bf16 " in ln
               for ln in gated)
    assert ("the f32 torch-ops path alone, its embedding table moved by one "
            "ulp: a 64-token prefill's logits move by ") in out
    assert re.search(r"ServingEngine greedy tokens equal, kernel path vs "
                     r"torch-ops path: bf16 \d+/12, f32 \d+/12 \(printed, "
                     r"not gated\)", out)


def test_moe_phase_fails_when_engine_first_tokens_differ(monkeypatch):
    """Phase 8 (a)'s first-token gate: an engine whose first tokens are
    not the kernel path's own prefill's fails the phase."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    gates = cs.moe_gates

    def shifted(*a):
        ops, firsts = gates(*a)
        return ops, [(t + 1) % cfg.vocab_size for t in firsts]

    monkeypatch.setattr(cs, "moe_gates", shifted)
    with pytest.raises(AssertionError, match="engine's first tokens"):
        cs.moe_phase(cfg, torch.device("cpu"), prompts=(40, 20),
                     new_tokens=2, capacity=2, max_len=48, layers=2)


def test_whisper_phase_on_cpu_at_reduced_width(capsys):
    """Phase 8 (b) at reduced whisper width: the sub-block gates passed
    on every row, the kernels held against their plain versions at the
    encoder's, the decoder prefill's and the decode step's shapes, and the
    launch-count guard firing (the plain versions launch nothing)."""
    cfg = get_config("whisper-base").reduced()
    with pytest.raises(AssertionError, match="audio path's launches") as e:
        cs.whisper_phase(cfg, torch.device("cpu"), batch=2, prompt=6,
                         steps=3)
    # 2 encoder and 2 decoder layers, 3 decode steps
    assert "{'flash_plain': 4, 'matmul_plain': 30}" in str(e.value)
    out = capsys.readouterr().out
    for gate in ("(a) f32 vs torch ops", "(b) bf16 vs torch ops",
                 "(c) bf16 vs plain versions"):
        line = next(ln for ln in out.splitlines() if gate in ln)
        assert line.count("(max ") == 4 and line.endswith(" ok"), line
    assert "greedy tokens equal:" in out and " ok\n" in out
    F_ = 2 * cfg.num_audio_frames
    for label in (f"mm_serve_up_m{F_}", f"mm_serve_down_m{F_}",
                  "mm_serve_up_m12", "mm_serve_down_m12",
                  "mm_serve_up_m2", "mm_serve_down_m2",
                  f"flash_enc_s{cfg.num_audio_frames}", "flash_dec_s6"):
        assert f"{label} plain: max_abs=0.000e+00" in out, label


def test_moe_layerwise_gates():
    """The attention sub-blocks agree within the gate's tolerance; each
    router fed its own side's input may flip top-k sets (a share in
    [0, 1]); a broken flash kernel fails the attention comparison."""
    import dataclasses

    from repro_torch.models.transformer import build_model
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(),
                              dtype=torch.bfloat16)
    kern = build_model(dataclasses.replace(cfg, use_pallas=True))
    ops = build_model(cfg)
    params = kern.init(0, device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, 37)))
    attn, flips = cs.moe_layerwise(kern, ops, params, x, 2,
                                   kern_ctx=cs.emulated_tensor_cores)
    assert attn < cs.MOE_ATTN_TOL
    assert 0.0 <= flips <= 1.0

    def zeros(desc, args, outs):
        outs[0].zero_()

    attn, flips = cs.moe_layerwise(kern, ops, params, x, 1,
                                   kern_ctx=lambda: cs.kernels_as(
                                       flash=zeros))
    assert attn > cs.MOE_ATTN_TOL and flips > 0.0


def test_whisper_row_gate_holds_every_row():
    """One token past the tolerance among many fails the gate; a broken
    matmul kernel puts every MLP row past the tolerance."""
    import dataclasses

    from repro_torch.models.transformer import build_model
    want = torch.ones(200, 8)
    got = want.clone()
    got[3] = -1.0
    e = cs.row_errs(got, want)
    assert e.shape == (200,) and e[3] == 2.0 and (e[:3] == 0).all()
    text, ok = cs.rows_line({"part": e}, 1e-2)
    assert not ok and text == "part 0.0e+00 (max 2.0e+00)"
    got[3] = 1.001
    assert cs.rows_line({"part": cs.row_errs(got, want)}, 1e-2)[1]

    cfg = dataclasses.replace(get_config("whisper-base").reduced(),
                              dtype=torch.float32)
    kern = build_model(dataclasses.replace(cfg, use_pallas=True))
    params = kern.init(0, device="cpu")
    rng = np.random.default_rng(1)
    embeds = torch.from_numpy(rng.standard_normal(
        (2, cfg.num_audio_frames, cfg.d_model), dtype=np.float32))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 5)))

    def doubled(desc, args, outs):
        a, b = args
        outs[0].copy_(2 * (a.float() @ b.float()))

    errs = cs.whisper_sublayers(kern, build_model(cfg), params, embeds, toks,
                                kern_ctx=lambda: cs.kernels_as(
                                    matmul=doubled))
    assert set(errs) == set(cs.WHISPER_PARTS)
    assert (errs["encoder MLP"] > 0.5).all()
    assert (errs["decoder MLP"] > 0.5).all()
    assert float(errs["encoder attention"].max()) < 1e-5


def test_traced_as_ranges_and_restores():
    """Calls of the wrapped function run inside a profiler range of its
    name, with the function's own operators beneath it; the function is
    restored after the block."""
    import types

    from torch.profiler import ProfilerActivity, profile
    owner = types.SimpleNamespace(step=lambda x: x + 1)
    fn = owner.step
    with cs.traced_as(owner, "step"):
        assert owner.step is not fn
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = owner.step(torch.ones(3))
    assert owner.step is fn and torch.equal(out, torch.full((3,), 2.0))
    ranges = [e for e in prof.events() if e.name == "step"]
    assert len(ranges) == 1
    assert any(c.name == "aten::add" for c in ranges[0].cpu_children)


def test_steps_phase_on_cpu_at_reduced_width(capsys):
    """Phase 9 at reduced deepseek-coder-33b width: bf16 weights drawn in
    the model dtype, the one-card mesh's shardings whole, the prefill and
    decode steps' gates passed (the cache passed through and written, the
    first tokens each prompt's own, the layers from one input), the
    kernels held against their plain versions at the steps' shapes, and
    the launch-count guard firing because the plain versions launch
    nothing."""
    cfg = get_config("deepseek-coder-33b").reduced()
    with pytest.raises(AssertionError, match="serving steps' launches") as e:
        cs.steps_phase(cfg, torch.device("cpu"), batch=2, prompt=32,
                       capacity=48, steps=3)
    # 2 layers: one prefill, 3 decode steps
    assert "{'flash_plain': 2, 'matmul_plain': 24}" in str(e.value)
    out = capsys.readouterr().out
    assert "in torch.bfloat16" in out and "mesh ('data', 'model') (1, 1)" \
        in out
    assert "every one of 12 leaves whole on the card True" in out
    for key in ("k", "v"):
        assert (f"cache {key}: rows < 32 unchanged True, row 32 written in "
                "every layer and sequence True, rows > 32 zero True ok") in out
    assert re.search(r"own B = 1 prefill step \[\d+, \d+\]: equal True", out)
    assert ("layer 0's row 32 against each sequence's B = 1 prefill of its "
            "prompt and first token, rel err k 0.00e+00, v 0.00e+00") in out
    line = next(ln for ln in out.splitlines() if "layer by layer, one" in ln)
    assert "2 layers: attention" in line and " ok; " in line, line
    for label in ("mm_serve_up_m64", "mm_serve_down_m64", "mm_serve_up_m2",
                  "mm_serve_down_m2", "flash_steps_s32"):
        assert f"{label} plain: max_abs=0.000e+00" in out, label


def test_decode_cache_gate_fails_on_a_changed_row():
    """The decode gate: rows below the index passed through, the index's
    row written, the rest zero; a changed old row, an unwritten row or a
    row written past the index each fail."""
    g = torch.Generator().manual_seed(0)
    old = {k: torch.randn(2, 3, 4, 2, 8, generator=g) for k in ("k", "v")}
    new = {k: torch.cat([v, torch.zeros(2, 3, 4, 2, 8)], dim=2)
           for k, v in old.items()}
    for k in new:
        new[k][:, :, 4] = 1.0
    cs.decode_cache_gate(old, new, 4)
    for broken in ("old", "unwritten", "past"):
        bad = {k: v.clone() for k, v in new.items()}
        if broken == "old":
            bad["v"][1, 0, 2, 0, 0] += 1e-3
        elif broken == "unwritten":
            bad["k"][0, 1, 4] = 0.0
        else:
            bad["k"][1, 2, 6, 1, 3] = 1.0
        with pytest.raises(AssertionError, match="decode step"):
            cs.decode_cache_gate(old, bad, 4)


def test_decode_row_gate_catches_a_wrong_row():
    """Layer 0's row that a decode step writes at the index equals the row
    of a prefill of the prompt and its token; a row roped at the next
    position, made from another token or taken from layer 1 fails."""
    from repro_torch.models.transformer import build_model, pad_cache
    model = build_model(get_config("deepseek-coder-33b").reduced())
    params = model.init(0, device="cpu", dtype=model.cfg.dtype)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, size=(2, 8)))
    nxt = torch.as_tensor([[3], [5]])
    kv = pad_cache(model.prefill(params, toks)[1], 16)

    def written(layer=0, **kw):
        c = model.decode_step(params, nxt, {k: v.clone()
                                            for k, v in kv.items()},
                              8, **kw)[1]
        return {k: c[k][layer, :, 8] for k in ("k", "v")}

    def expected(step):
        rows = [model.prefill(params, torch.cat([toks[b:b + 1],
                                                 step[b:b + 1]], dim=1))[1]
                for b in range(2)]
        return {k: [r[k][0, 0, 8] for r in rows] for k in ("k", "v")}

    right = expected(nxt)
    cs.decode_row_gate(written(), right, 8)
    for bad, want in ((written(positions=torch.full((2, 1), 9)), right),
                      (written(), expected(nxt + 1)),
                      (written(layer=1), right)):
        with pytest.raises(AssertionError, match="layer 0's written"):
            cs.decode_row_gate(bad, want, 8)


def test_compression_gate_on_cpu(capsys, monkeypatch):
    """The compression gate over a reduced mamba2 gradient tree (the CPU
    against itself: bit for bit), and its failure when the error-feedback
    identity does not hold."""
    from repro_torch.distributed import compression
    from repro_torch.launch.steps import compute_grads
    from repro_torch.models.transformer import build_model
    model = build_model(get_config("mamba2-130m").reduced())
    params = model.init(0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, size=(2, 33)))
    _, grads = compute_grads(model, params, {"tokens": toks[:, :-1],
                                             "targets": toks[:, 1:]})
    cs.compression_gate(grads, torch.device("cpu"))
    out = capsys.readouterr().out
    assert "bit for bit in both steps True" in out and "] ok; payload" in out
    from repro_torch.tree import tree_map
    whole = compression.decompress_tree
    monkeypatch.setattr(compression, "decompress_tree",
                        lambda c: tree_map(lambda x: x * 1.001, whole(c)))
    with pytest.raises(AssertionError, match="error-feedback"):
        cs.compression_gate(grads, torch.device("cpu"))


def test_colocated_obs_phase_on_cpu_at_reduced_width(capsys):
    """Phase 10 at reduced qwen2.5-14b and mamba2-130m width: the HP
    tokens equal alone, co-located and co-located without a hub; each
    hub's registry the engine's account, its exposition and JSONL round
    trips exact; the outage shedding without failover and recovered with
    it (a 2 s request budget: the CPU's p99 is far under a second); the
    kernels held against their plain versions at the prompt lengths 4 to
    11; and the launch-count guard firing because the plain versions
    launch nothing."""
    with pytest.raises(AssertionError, match="observed co-located path "
                                             "needs") as e:
        cs.colocated_obs_phase(get_config("qwen2.5-14b").reduced(),
                               get_config("mamba2-130m").reduced(),
                               torch.device("cpu"), max_len=48, be_batch=2,
                               be_seq=32, timeout_floor=2.0)
    assert "'flash_plain': (0, " in str(e.value)
    out = capsys.readouterr().out
    assert "HP tokens equal request by request (rid order): 12/12 ok" in out
    gated = [ln for ln in out.splitlines() if "registry against the engine"
             in ln]
    assert [ln.split(")")[0].strip() for ln in gated] == [
        "(a", "(b", "(d", "(e"]
    assert all("round trips ok" in ln for ln in gated), gated
    assert re.search(r"\(d\) \d+ shed \[>= 1\]; \(e\) 0 shed \[== 0\], "
                     r"12/12 answered, \d+ retries \[>= 1\] ok", out)
    assert re.search(r"\(b\) 12 answered, 0 shed, 0 retries, 12 prefills, "
                     r"\d+ decode steps, [1-9]\d* BE quanta", out)
    assert "overhead_vs(p99 of (a))" in out
    assert "    tally_serving_requests_total 12.0" in out
    for M in cs.OBS_PROMPTS:
        for label in (f"mm_serve_up_m{M}", f"mm_serve_down_m{M}",
                      f"flash_obs_s{M}"):
            assert f"{label} plain: max_abs=0.000e+00" in out, label


def test_hub_gates_fail_when_the_registry_disagrees():
    """A hub that missed one retirement is not the engine's account."""
    from repro_torch.obs import ObsHub
    from repro_torch.serving import ServingConfig, ServingEngine
    from repro_torch.models.transformer import build_model
    model = build_model(get_config("qwen2.5-14b").reduced())
    params = model.init(0, device="cpu")
    hub = ObsHub()
    eng = ServingEngine(model, params, ServingConfig(2, 32), obs=hub)
    for n in (4, 5):
        eng.submit(np.arange(n, dtype=np.int32), max_new_tokens=2)
    eng.run_until_idle()
    cs.hub_gates("ok", hub, eng, 2, 0)
    hub.serving().retired(0.5)
    with pytest.raises(AssertionError, match="'requests'"):
        cs.hub_gates("bad", hub, eng, 2, 0)
