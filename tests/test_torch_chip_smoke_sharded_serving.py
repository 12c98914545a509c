"""Phase 13 of ``chip_smoke.py`` rehearsed on the CPU at reduced width: the
serving steps' ``sharded_fn`` on reduced qwen2.5-14b (1, 2) and
mamba2-130m (1, 2) and (2, 1), two ranks of one gloo group each
(``chip_smoke.py --sharded-serving JOB``), against one process running
the same steps here. Every gate of every rank passes (each layer from one
input, the first layers against the kernels' plain versions on the same
shards, the cache, the bytes against the dry run's, the launch shapes),
and the launch guard fires at the end because the kernels' plain versions
launch nothing on the CPU.
"""
import re
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402


def test_sharded_serving_phase_on_cpu_at_reduced_width(capsys):
    with pytest.raises(AssertionError, match="miss a kernel of the path"
                       ) as e:
        cs.sharded_serving_phase(torch.device("cpu"), reduced=True, batch=4,
                                 prompt=16, capacity=32, steps=2,
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
