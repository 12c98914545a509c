"""Phase 13 of ``chip_smoke.py`` rehearsed on the CPU at reduced width: the
serving steps' ``sharded_fn`` on reduced qwen2.5-14b (1, 2) and
mamba2-130m (1, 2) and (2, 1), two ranks of one gloo group each
(``chip_smoke.py --sharded-serving-rank JOB``); and on model axes that do not
divide the heads: reduced qwen2.5-14b and whisper-base on (1, 3) (2 kv
groups over 3 ranks: the last has none) and mamba2-130m with d_model 48
on (1, 4) (6 SSD heads, 2 a rank, none on the last; 96 x channels split
24 a rank), as the card's (1, 3) and (1, 16) runs lay them out; all
against one process running the same steps here. Every gate of every
rank passes (each layer from one input, the first layers against the
kernels' plain versions on the same shards, the cache, the bytes against
the dry run's, the launch shapes), and the launch guard fires at the end
because the kernels' plain versions launch nothing on the CPU. The
expert-parallel runs: qwen3-moe-30b-a3b on (2, 1) and (2, 2) and
jamba-1.5-large-398b's period on (2, 2), whose MoE blocks route as one
process and send the dry run's all-to-all bytes.
"""
import re
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402


TRAFFIC = (4, 16, 32, 2)


def test_sharded_serving_phase_on_cpu_at_reduced_width(capsys):
    # qwen2.5-14b cut to its first layer, drawn as the whole model draws
    # it, as the card's run is cut
    runs = ((cs.ShardedRun("qwen2.5-14b", ((1, 2),), TRAFFIC, layers=1),
             cs.ShardedRun("mamba2-130m", ((1, 2), (2, 1)), TRAFFIC)),)
    with pytest.raises(AssertionError, match="miss a kernel of the path"
                       ) as e:
        cs.sharded_serving_phase(torch.device("cpu"), runs, reduced=True,
                                 timeout_s=240)
    # every path's kernels: none launched off the card
    for what in ("qwen2.5-14b (1, 2) matmul_plain", "qwen2.5-14b (1, 2) "
                 "flash_plain", "mamba2-130m (1, 2) ssd_plain",
                 "mamba2-130m (2, 1) ssd_plain"):
        assert what in str(e.value)
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if " rank " in ln]
    assert len(lines) == 6
    for ln in lines:
        assert ln.endswith(" ok"), ln
        assert "the rest passed through True" in ln
        # the first layers through the kernels' path against their plain
        # versions, on the same shards inside the same ModelAxis
        assert "against their plain versions on the shards, 2 layers" in ln
        assert "launches at shard shapes True" in ln
        bytes_, priced = re.search(r"bytes (\{.*?\}), dry run (\{.*?\})",
                                   ln).groups()
        assert bytes_ == priced, ln
    # the prefill's cache on (1, 2) splits the 16 positions, the decode
    # step's 32: its tokens at 16 and 17 land on rank 1, and the ranks'
    # tokens equal one process's
    assert out.count("greedy tokens equal on 2 of 2 ranks") == 3
    assert "qwen2.5-14b (1, 2) rank 1 {'data': 0, 'model': 1}" in out
    assert "mamba2-130m (2, 1) rank 1 {'data': 1, 'model': 0}" in out
    assert "phase 13 in" in out


def test_sharded_serving_phase_on_uneven_axes_at_reduced_width(capsys):
    # one wave of three meshes, as the card runs its waves
    runs = ((cs.ShardedRun("qwen2.5-14b", ((1, 3),), TRAFFIC),
             cs.ShardedRun("whisper-base", ((1, 3),), (2, 16, 30, 2)),
             cs.ShardedRun("mamba2-130m", ((1, 4),), TRAFFIC,
                           widths=(("d_model", 48),))),)
    with pytest.raises(AssertionError, match="miss a kernel of the path"
                       ) as e:
        cs.sharded_serving_phase(torch.device("cpu"), runs, reduced=True,
                                 timeout_s=240)
    for what in ("qwen2.5-14b (1, 3) matmul_plain", "qwen2.5-14b (1, 3) "
                 "flash_plain", "whisper-base (1, 3) flash_plain",
                 "mamba2-130m (1, 4) ssd_plain"):
        assert what in str(e.value)
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if " rank " in ln]
    assert len(lines) == 3 + 3 + 4
    for ln in lines:
        assert ln.endswith(" ok"), ln
        assert "the rest passed through True" in ln
        assert "against their plain versions on the shards, 2 layers" in ln
        assert "launches at shard shapes True" in ln
        bytes_, priced = re.search(r"bytes (\{.*?\}), dry run (\{.*?\})",
                                   ln).groups()
        assert bytes_ == priced, ln
    # whisper's encoder layers are held too, through the kernels' path
    # against their plain versions as well
    for ln in lines:
        if "whisper-base" in ln:
            assert re.search(r"encoder \d\.\d\de[-+]\d\d, prefill", ln), ln
            assert "encoder " in ln.split("2 layers:")[1], ln
    assert "qwen2.5-14b (1, 3) rank 2 {'data': 0, 'model': 2}" in out
    assert "mamba2-130m (1, 4) rank 3 {'data': 0, 'model': 3}" in out
    assert out.count("wave 0 (") == 1


def test_sharded_serving_phase_moe_and_hybrid_at_reduced_width(capsys):
    """The card's three expert-parallel runs at reduced width, in one
    wave: qwen3-moe-30b-a3b on (2, 1) and (2, 2) (4 experts, 2 a rank)
    cut to its first layer, and jamba-1.5-large-398b's period of 8
    layers with its experts' width cut as on the card, on (2, 2). Every
    rank's MoE blocks, fed one process's FFN input, route as one process
    and send the dry run's all-to-all bytes."""
    runs = ((cs.ShardedRun("qwen3-moe-30b-a3b", ((2, 1), (2, 2)), TRAFFIC,
                           layers=1),
             cs.ShardedRun("jamba-1.5-large-398b", ((2, 2),), TRAFFIC,
                           widths=cs.JAMBA_PERIOD)),)
    with pytest.raises(AssertionError, match="miss a kernel of the path"
                       ) as e:
        cs.sharded_serving_phase(torch.device("cpu"), runs, reduced=True,
                                 timeout_s=240)
    # the moe family launches flash alone, the hybrid family all three
    for what in ("qwen3-moe-30b-a3b (2, 1) flash_plain",
                 "qwen3-moe-30b-a3b (2, 2) flash_plain",
                 "jamba-1.5-large-398b (2, 2) matmul_plain",
                 "jamba-1.5-large-398b (2, 2) flash_plain",
                 "jamba-1.5-large-398b (2, 2) ssd_plain"):
        assert what in str(e.value)
    assert "(2, 1) matmul_plain" not in str(e.value)
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if " rank " in ln]
    assert len(lines) == 2 + 4 + 4
    for ln in lines:
        assert ln.endswith(" ok"), ln
        assert "the rest passed through True" in ln
        assert "launches at shard shapes True" in ln
        assert re.search(r"top-2 sets equal True; fed the rank's own, \d+ "
                         r"of \d+ sets flipped", ln), ln
        pre, dec, pre_dry, dec_dry = re.search(
            r"all-to-all bytes sent (\d+) \(prefill\) and (\d+) \(a decode "
            r"step\), dry run (\d+) and (\d+)", ln).groups()
        assert (pre, dec) == (pre_dry, dec_dry) and int(pre) > 0, ln
        bytes_, priced = re.search(r"bytes (\{.*?\}), dry run (\{.*?\})",
                                   ln).groups()
        assert bytes_ == priced, ln
    # jamba's kernels against their plain versions include its first
    # attention layer (4) beside its first two, mamba2 layers
    jamba = [ln for ln in lines if "jamba" in ln]
    for ln in jamba:
        plain = ln.split("2 layers:")[1]
        assert "mixer" in plain and "mlp" in plain and "decode_mixer" in plain
    assert "jamba-1.5-large-398b: 8 layers" in out
    assert out.count("wave 0 (") == 1


def test_plain_layers_hold_an_attention_layer_of_every_stack():
    assert cs.plain_layers(get_config("qwen3-moe-30b-a3b")) == {0, 1}
    assert cs.plain_layers(get_config("jamba-1.5-large-398b")) == {0, 1, 4}
    assert cs.plain_layers(get_config("mamba2-130m")) == {0, 1}


def test_launch_shapes_gate_on_axes_that_do_not_divide_the_heads():
    """qwen2.5-14b on (1, 3): flash on 15, 15 and 10 heads (G = 5), the
    MLP's matmuls at 4608 columns; whisper-base on (1, 3): 3, 3 and 2
    heads, its whole MLP sliced to 688, 688 and 672 columns (units of 8);
    mamba2-130m on (1, 16): the SSD on 2 heads on ranks 0-11, none on
    12-15, which must not launch and the others must."""
    cfg = get_config("qwen2.5-14b")
    E = cfg.d_model
    for rank, hq in ((0, 15), (2, 10)):
        good = {"matmul": {(2048, E, 4608), (2048, 4608, E)},
                "flash": {(4 * hq, 512, 512, 128, 5)}, "ssd": set()}
        assert cs.launch_shapes_gate(cfg, good, 4, 3, rank)
        assert not cs.launch_shapes_gate(cfg, good, 4, 3, 2 - rank)
        assert not cs.launch_shapes_gate(
            cfg, {**good, "flash": {(4 * 40, 512, 512, 128, 5)}}, 4, 3, rank)
    w = get_config("whisper-base")
    for rank, hq, f in ((0, 3, 688), (2, 2, 672)):
        good = {"matmul": {(3000, 512, f), (3000, f, 512)},
                "flash": {(2 * hq, 1500, 1500, 64, 1),
                          (2 * hq, 16, 16, 64, 1)}, "ssd": set()}
        assert cs.launch_shapes_gate(w, good, 2, 3, rank)
        assert not cs.launch_shapes_gate(
            w, {**good, "matmul": {(3000, 512, 2048)}}, 2, 3, rank)
    m = get_config("mamba2-130m")
    ssd = {"matmul": set(), "flash": set(), "ssd": {(4, 512, 2, 64, 128)}}
    none = {**ssd, "ssd": set()}
    assert cs.launch_shapes_gate(m, ssd, 4, 16, 11)
    assert cs.launch_shapes_gate(m, none, 4, 16, 12)
    assert not cs.launch_shapes_gate(m, ssd, 4, 16, 12)
    assert not cs.launch_shapes_gate(m, none, 4, 16, 0)


def test_launch_shapes_gate_catches_a_whole_width_launch():
    """The gate takes the MLP's matmuls at N or K = d_ff / 2 and flash on
    half the heads (qwen2.5-14b on (1, 2), 4 rows), the SSD on half the
    heads (mamba2-130m); a launch at the whole width fails it."""
    cfg = get_config("qwen2.5-14b")
    E, F, H = cfg.d_model, cfg.d_ff, cfg.num_heads
    good = {"matmul": {(2048, E, F // 2), (2048, F // 2, E)},
            "flash": {(4 * H // 2, 512, 512, 128, cfg.q_per_kv)},
            "ssd": set()}
    assert cs.launch_shapes_gate(cfg, good, 4, 2)
    assert not cs.launch_shapes_gate(cfg, {**good, "matmul": {(2048, E, F)}},
                                     4, 2)
    assert not cs.launch_shapes_gate(
        cfg, {**good, "flash": {(4 * H, 512, 512, 128, cfg.q_per_kv)}}, 4, 2)
    m = get_config("mamba2-130m")
    nh = m.ssm.num_heads(m.d_model)
    ssd = {"matmul": set(), "flash": set(),
           "ssd": {(4, 512, nh // 2, 64, 128)}}
    assert cs.launch_shapes_gate(m, ssd, 4, 2)
    assert not cs.launch_shapes_gate(m, ssd, 4, 1)
    assert not cs.launch_shapes_gate(m, {**ssd, "ssd": set()}, 4, 2)


def test_launch_shapes_gate_of_the_moe_and_hybrid_families():
    """qwen3-moe-30b-a3b on (2, 2), 2 rows a rank: flash on 16 heads (G =
    8) and no matmul (its MoE blocks are torch ops); jamba-1.5-large-398b
    on (2, 2): flash on 32 heads (G = 8), the SSD on 64 of its 128 heads
    of 128 columns (launched as 128 heads of 64), the dense MLP's
    matmuls at 12288 of 24576 columns; a missing family or a whole-width
    launch fails it."""
    q = get_config("qwen3-moe-30b-a3b")
    good = {"matmul": set(), "flash": {(2 * 16, 512, 512, 128, 8)},
            "ssd": set()}
    assert cs.launch_shapes_gate(q, good, 2, 2)
    assert not cs.launch_shapes_gate(
        q, {**good, "matmul": {(1024, 2048, 384)}}, 2, 2)
    assert not cs.launch_shapes_gate(
        q, {**good, "flash": {(2 * 32, 512, 512, 128, 8)}}, 2, 2)
    j = get_config("jamba-1.5-large-398b")
    E = j.d_model
    good = {"matmul": {(1024, E, 12288), (1024, 12288, E)},
            "flash": {(2 * 32, 512, 512, 128, 8)},
            "ssd": {(2, 512, 128, 64, 128)}}
    assert cs.launch_shapes_gate(j, good, 2, 2)
    for fam, bad in (("ssd", set()), ("ssd", {(2, 512, 256, 64, 128)}),
                     ("matmul", {(1024, E, 24576)}), ("flash", set())):
        assert not cs.launch_shapes_gate(j, {**good, fam: bad}, 2, 2), fam
