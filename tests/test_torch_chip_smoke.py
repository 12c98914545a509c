"""chip_smoke.py's phases rehearsed on the CPU at a tiny width: the kernel
wrappers take their plain versions there, so every comparison passes
exactly and the launch-count guard finds no kernel launched."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402


def test_phases_on_cpu_at_reduced_width():
    dev = torch.device("cpu")
    cfg = get_config("qwen2.5-14b").reduced()
    for label, (desc, args) in cs.small_cases(dev).items():
        errs, _ = cs.check_forms(label, desc, args, "small")
        assert errs == {"plain": 0.0, "sliced": 0.0, "persistent": 0.0}
    cases = cs.full_cases(cfg, dev, seq_hp=32, tokens_be=64, seq_be=64)
    refs = {}
    for label, (desc, args) in cases.items():
        kind = "matmul" if label.startswith("mm") else "flash"
        _, refs[label] = cs.check_forms(label, desc, args, kind)
        b_ms, by = cs.bound(desc)
        assert b_ms > 0 and by in ("bytes", "operations")
    # BE work far beyond what the HP requests leave gaps for; the plain
    # versions count no launch, so the guard at the end must fire
    with pytest.raises(AssertionError, match="never launched"):
        cs.server_phase(cfg, cases, refs, dev, S=32, be_iters=150)
