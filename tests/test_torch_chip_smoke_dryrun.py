"""Phase 11 of ``chip_smoke.py`` rehearsed on the CPU: the dry run's cells
and its one-card gates against what phase 9 passes to the serving steps.

deepseek-coder-33b at full width is priced on meta tensors (no memory);
the bytes "passed" are those of the trees that phase 9 builds, here with
meta weights and cache (``tensor_bytes`` reads shapes only). Device ms and
peaks are not measured off the card, and the phase says so.
"""
import re
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config, kv_cache_specs  # noqa: E402
from repro_torch.launch.steps import serving_param_shapes  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402


def _measured(cfg, batch=cs.STEPS_BATCH, prompt=cs.STEPS_PROMPT,
              capacity=cs.STEPS_CAPACITY):
    params = serving_param_shapes(build_model(cfg))
    toks = torch.zeros((batch, prompt), dtype=torch.int32)
    cache = {k: torch.empty(s, dtype=d, device="meta")
             for k, (s, d) in kv_cache_specs(cfg, batch, capacity).items()}
    dbatch = {"tokens": toks[:, :1], "cache": cache,
              "cache_index": torch.tensor(prompt, dtype=torch.int32)}
    return {"prefill_bytes": cs.tensor_bytes((params, {"tokens": toks})),
            "decode_bytes": cs.tensor_bytes((params, dbatch)),
            "prefill_device_ms": None, "decode_device_ms": None,
            "prefill_peak": None, "decode_peak": None, "phase_peak": None}


def test_dryrun_phase_on_cpu(capsys):
    cfg = get_config("deepseek-coder-33b")
    got = cs.dryrun_phase(cfg, _measured(cfg), "cpu", torch.device("cpu"),
                          cells=(("mamba2-130m", "long_500k"),))
    out = capsys.readouterr().out
    assert "mamba2-130m x long_500k x single: ok:" in out
    assert "mamba2-130m x long_500k x multi: ok:" in out
    assert "qwen2.5-14b x long_500k x multi: skip:" in out
    assert re.search(r"re-meshed to \(8, 16\), batch 128: ok:", out)
    for k in ("prefill", "decode"):
        line = next(ln for ln in out.splitlines()
                    if f"deepseek-coder-33b {k} step" in ln)
        assert "equal True" in line and "fits True" in line, line
        assert "device ms not measured" in line
        assert "peak not measured" in line
    assert "f32 masters, AdamW) on (1, 1)" in out and "fits False" in out
    # 62.1 GiB of bf16 weights; f32 masters with AdamW's two moments
    assert got["prefill"]["memory"]["argument_size_in_bytes"] > 62 * 2 ** 30
    assert got["train"]["memory"]["argument_size_in_bytes"] > 3 * 124 * 2 ** 30
    # the decode step reuses its donated k and v cache: 62 layers, B = 4,
    # 1024 positions, 8 kv heads of 128, bf16
    cache = 2 * 62 * 4 * 1024 * 8 * 128 * 2
    assert got["decode"]["memory"]["alias_size_in_bytes"] == cache


def test_dryrun_phase_fails_when_bytes_differ():
    cfg = get_config("deepseek-coder-33b")
    measured = _measured(cfg)
    measured["decode_bytes"] += 4
    with pytest.raises(AssertionError, match="predicted arguments"):
        cs.dryrun_phase(cfg, measured, "cpu", torch.device("cpu"), cells=())
