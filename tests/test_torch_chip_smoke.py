"""chip_smoke.py's phases rehearsed on the CPU at a tiny width: the kernel
wrappers take their plain versions there, so every comparison passes
exactly and the launch-count guards find no kernel launched."""
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
