"""Quickstart: Tally's non-intrusive performance isolation on one device.

A high-priority client and a best-effort client share one device through
the Tally server. The BE kernel is transparently transformed (sliced or
made preemptible) and scheduled opportunistically; the HP kernel runs
immediately. Results match direct execution.

    PYTHONPATH=src python -m repro_torch.quickstart              # the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.virtualization import TallyServer
from repro_torch.kernels import ref
from repro_torch.kernels.matmul import matmul_desc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False     # full-f32 oracle
    server = TallyServer(device=args.device)
    dev = server.device
    hp = server.register("inference", priority=0)
    be = server.register("training", priority=1)

    rng = np.random.default_rng(0)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)

    a_big = tensor(256, 128)
    b_big = tensor(128, 96)
    big = matmul_desc(256, 128, 96, bm=32, bk=64, bn=32)   # BE: many blocks

    a_sm = tensor(64, 128)
    small = matmul_desc(64, 128, 96, bm=32, bk=64, bn=32)  # HP: small

    print("submitting best-effort matmul (256x128x96) ...")
    job_be = be.launch(big, a_big, b_big)
    print("submitting HIGH-PRIORITY matmul (64x128x96) ...")
    job_hp = hp.launch(small, a_sm, b_big)

    server.serve_until_idle(max_seconds=120)

    torch.testing.assert_close(job_hp.result(0)[0],
                               ref.matmul_ref(a_sm, b_big),
                               rtol=5e-4, atol=1e-5)
    torch.testing.assert_close(job_be.result(0)[0],
                               ref.matmul_ref(a_big, b_big),
                               rtol=5e-4, atol=1e-5)
    print("numerics: exact (vs direct execution)")
    assert job_hp.complete_t <= job_be.complete_t
    print("priority: HP finished first even though BE was submitted first")
    cfg = server.profiler.lookup_launch_config(job_be)
    print(f"BE kernel was transparently transformed: config = {cfg}")
    print(f"(profiled {server.profiler.profiled_kernels} unique kernels; "
          "HP kernels are never transformed)")


if __name__ == "__main__":
    main()
