#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py          # one CUDA card; exits non-zero without one

Phases, each raising on failure:
  1. card and build: the card's name and power limit, then every kernel
     built from ``src/repro_torch/kernels/csrc`` (one nvcc per source);
  2. kernel against plain: each kernel family in each launch form (plain;
     sliced with k=3; persistent with W=132 and budgets cycling 1, 2, 5)
     against its plain PyTorch version, at the small parity shapes of the
     transform tests (f32) and at the qwen2.5-14b shapes of the main path
     (bf16);
  3. times at the qwen2.5-14b shapes: kernel, plain version, one library
     call as yardstick (timed here only, never used by the port) and the
     bound max(flops / 989 TFLOP/s, bytes / 3.35 TB/s);
  4. the main path: a TallyServer on the card, a best-effort "training"
     client with the full-width matmul and flash attention, and a
     high-priority "inference" client sending prefill requests of one
     qwen2.5-14b decoder layer. Launch counts are zeroed before and read
     after; every entry point must have run.
The line before the last is the kernels' JSON summary, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 (data sheet)
SMALL_TOL = dict(rtol=1e-4, atol=1e-4)
WORKERS, SLICES, BUDGETS = 132, 3, (1, 2, 5)
REPS = 5                      # timed runs per kernel form (median kept)
SEED = 0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# Running one launch form to completion: the kernel or its plain version
# ---------------------------------------------------------------------------


def run_form(desc, args, form: str, kernel: bool):
    """Outputs (and the persistent form's ``done`` per launch) of ``desc``
    run to completion in ``form`` by the CUDA kernel or the plain version."""
    from repro_torch.core import transforms as T
    from repro_torch.core.descriptor import new_outputs
    fam = desc.kernel
    outs = new_outputs(desc, args[0].device, zero=True)
    dones = []
    if form == "plain":
        (fam.plain if kernel else fam.plain_version)(desc, args, outs)
    elif form == "sliced":
        for off, ln in T.slice_plan(desc, SLICES):
            sub = T.make_slice(desc, off, ln)
            (fam.sliced if kernel else fam.sliced_version)(sub, args, outs)
    else:
        W = max(1, min(WORKERS, desc.num_blocks))
        start, i = 0, 0
        while start < desc.num_blocks:
            b = BUDGETS[i % len(BUDGETS)]
            run = fam.persistent if kernel else fam.persistent_version
            dones.append(run(desc, W, start, b, args, outs))
            start = T.preempt_watermark(start, b, W, desc.num_blocks)
            i += 1
    return outs, dones


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits), no smaller than at 2^-8."""
    mag = x.float().abs().clamp_min(2.0 ** -8)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def compare(name, got, want, kind: str) -> float:
    """Max abs error of ``got`` against ``want``; raises past tolerance."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (g - w).abs()
    max_abs = err.max().item()
    max_rel = (err / w.abs().clamp_min(1e-6)).max().item()
    if kind == "small":
        ok = bool(torch.allclose(g, w, **SMALL_TOL))
        tol = "rtol=atol=1e-4 (f32; only the summation order differs)"
    elif kind == "matmul":
        # f32 sums of the same bf16 products in another order
        bound = 1e-3 * w.abs().max().item()
        ok = max_abs <= bound
        tol = f"max_abs <= 1e-3*max|ref| = {bound:.3e}"
    else:
        # f32 online softmax in another order, then one rounding to bf16:
        # the two may round apart by an ulp or so
        ok = bool((err <= 2 * bf16_ulp(w)).all())
        tol = "<= 2 bf16 ulps (ulps taken no smaller than at 2^-8)"
    print(f"  {name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} [{tol}] "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return max_abs


def check_forms(label, desc, args, kind: str):
    """Each form: kernel against plain version; returns errors and the
    plain form's plain-version outputs."""
    errs, ref = {}, None
    for form in ("plain", "sliced", "persistent"):
        k_outs, k_done = run_form(desc, args, form, kernel=True)
        p_outs, p_done = run_form(desc, args, form, kernel=False)
        if args[0].is_cuda:
            torch.cuda.synchronize()
        for kd, pd in zip(k_done, p_done):
            if not torch.equal(kd.cpu(), pd.cpu()):
                raise AssertionError(f"{label} {form}: done differs")
        if len(k_done) != len(p_done):
            raise AssertionError(f"{label} {form}: launch counts differ")
        errs[form] = max(compare(f"{label} {form}", k, p, kind)
                         for k, p in zip(k_outs, p_outs))
        if form == "plain":
            ref = p_outs
    return errs, ref


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


def tensor(rng, shape, dtype, device, scale=1.0):
    x = rng.standard_normal(size=shape, dtype=np.float32) * scale
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def small_cases(dev):
    """The parity geometries of tests/test_transforms.py (f32)."""
    from repro_torch.kernels.flash_attention import flash_attention_desc
    from repro_torch.kernels.matmul import matmul_desc
    rng = np.random.default_rng(7)
    f32 = torch.float32
    mm = (matmul_desc(96, 64, 48, bm=16, bk=32, bn=16),
          (tensor(rng, (96, 64), f32, dev), tensor(rng, (64, 48), f32, dev)))
    BH, S, D, G = 6, 32, 8, 2
    fl = (flash_attention_desc(BH, S, S, D, G, causal=True, bq=8, bk=8),
          (tensor(rng, (BH, S, D), f32, dev),
           tensor(rng, (BH // G, S, D), f32, dev),
           tensor(rng, (BH // G, S, D), f32, dev)))
    return {"matmul 96x64x48 f32": mm, "flash 6x32x32x8 g2 causal f32": fl}


def full_cases(cfg, dev, seq_hp=512, tokens_be=4096, seq_be=2048):
    """The main path's launches at the model's width (bf16): the HP
    prefill's MLP and attention, and a BE training micro-batch."""
    from repro_torch.kernels.flash_attention import flash_attention_desc
    from repro_torch.kernels.matmul import matmul_desc
    rng = np.random.default_rng(SEED + 1)
    bf = torch.bfloat16
    E, F = cfg.d_model, cfg.d_ff
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    G = H // KVH
    cases = {}
    for label, M, K, N in (("mm_hp_up", seq_hp, E, F),
                           ("mm_hp_down", seq_hp, F, E),
                           ("mm_be", tokens_be, E, F)):
        cases[label] = (matmul_desc(M, K, N, bf),
                        (tensor(rng, (M, K), bf, dev),
                         tensor(rng, (K, N), bf, dev, 1 / math.sqrt(K))))
    for label, B, S in (("flash_hp", 1, seq_hp), ("flash_be", 2, seq_be)):
        cases[label] = (flash_attention_desc(B * H, S, S, D, G, bf,
                                             causal=True),
                        (tensor(rng, (B * H, S, D), bf, dev),
                         tensor(rng, (B * KVH, S, D), bf, dev),
                         tensor(rng, (B * KVH, S, D), bf, dev)))
    return cases


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median ms of ``fn`` over ``reps`` runs, each between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(desc):
    t_ops = desc.flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = desc.bytes_accessed / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def library_fn(label, desc, args, heads: int):
    """One PyTorch call computing the same function (yardstick only)."""
    import torch.nn.functional as F
    if label.startswith("mm"):
        a, b = args
        return lambda: torch.matmul(a, b)
    q, k, v = args
    s = desc.static
    BH, S, D = q.shape
    B = BH // heads
    # (B, H, S, D) views; kv heads repeated once, outside the timed call,
    # in the kernel's i // group order
    qb = q.reshape(B, heads, S, D)
    kb = k.repeat_interleave(s["group"], dim=0).reshape(B, heads, -1, D)
    vb = v.repeat_interleave(s["group"], dim=0).reshape(B, heads, -1, D)
    return lambda: F.scaled_dot_product_attention(qb, kb, vb,
                                                  is_causal=s["causal"])


def time_cases(cases, reps: int, heads: int):
    rows = {}
    for label, (desc, args) in cases.items():
        b_ms, b_by = bound(desc)
        lib_ms = cuda_ms(library_fn(label, desc, args, heads), reps)
        plain_ms = cuda_ms(lambda: run_form(desc, args, "plain", False), 1,
                           warmup=0)
        for form in ("plain", "sliced", "persistent"):
            ms = cuda_ms(lambda: run_form(desc, args, form, True), reps)
            rows[(label, form)] = dict(ms=ms, plain_ms=plain_ms,
                                       bound_ms=b_ms, bound_by=b_by,
                                       library_ms=lib_ms)
            print(f"  {label} {form}: kernel {ms:.3f} ms, plain version "
                  f"{plain_ms:.1f} ms, library {lib_ms:.3f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound",
                  flush=True)
    return rows


# ---------------------------------------------------------------------------
# The main path: the Tally server with HP inference and BE training
# ---------------------------------------------------------------------------


def layer_weights(cfg, dev):
    """A numpy-seeded one-layer parameter tree of the model's shape, in the
    JAX package's layout, carried over by ``params_from_jax``."""
    from repro_torch.weights import mlp_weights, params_from_jax
    rng = np.random.default_rng(SEED)
    E, F = cfg.d_model, cfg.d_ff

    def w(*shape):
        return rng.standard_normal(size=shape, dtype=np.float32) \
            / np.float32(math.sqrt(shape[-2]))

    tree = {"layers": {"p0": {"ffn": {"wg": w(1, E, F), "wi": w(1, E, F),
                                      "wo": w(1, F, E)}}}}
    return mlp_weights(params_from_jax(tree, dev, torch.bfloat16), 0)


def hp_request(hp, cfg, inp, weights, descs):
    """One prefill request of one decoder layer on the use_pallas path:
    flash attention, then x@wg and x@wi, h = silu(.)*(.), then h@wo.
    Returns (latency s, [(desc, job)], y)."""
    import torch.nn.functional as F
    wg, wi, wo = weights
    q, k, v, x = inp
    t0 = time.monotonic()
    jobs = [(descs["flash"], hp.launch(descs["flash"], q, k, v))]
    jobs[0][1].result(60)
    jg = hp.launch(descs["up"], x, wg)
    ji = hp.launch(descs["up"], x, wi)
    g = jg.result(60)[0].to(torch.bfloat16)
    u = ji.result(60)[0].to(torch.bfloat16)
    h = (F.silu(g) * u).contiguous()
    jo = hp.launch(descs["down"], h, wo)
    y = jo.result(60)[0].to(torch.bfloat16)
    lat = time.monotonic() - t0
    jobs += [(descs["up"], jg), (descs["up"], ji), (descs["down"], jo)]
    return lat, jobs, y


def server_phase(cfg, cases, refs, dev, S=512, be_iters=4):
    """The main path. ``be_iters`` training steps are queued before the
    co-located HP requests: many more BE quanta than the requests leave
    gaps for, so the BE work is still pending when the last request ends."""
    from repro_torch import kernels
    from repro_torch.core.virtualization import TallyServer
    from repro_torch.kernels.flash_attention import flash_attention_desc
    from repro_torch.kernels.matmul import matmul_desc
    server = TallyServer() if dev.type == "cuda" else TallyServer(dev)
    hp = server.register("inference", priority=0)
    be = server.register("training", priority=1)
    weights = layer_weights(cfg, dev)
    E, F = cfg.d_model, cfg.d_ff
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    descs = {"flash": flash_attention_desc(H, S, S, D, H // KVH,
                                           torch.bfloat16, causal=True),
             "up": matmul_desc(S, E, F, torch.bfloat16),
             "down": matmul_desc(S, F, E, torch.bfloat16)}
    rng = np.random.default_rng(SEED + 2)
    bf = torch.bfloat16
    inputs = [(tensor(rng, (H, S, D), bf, dev),
               tensor(rng, (KVH, S, D), bf, dev),
               tensor(rng, (KVH, S, D), bf, dev),
               tensor(rng, (S, E), bf, dev)) for _ in range(8)]
    be_work = [cases["mm_be"], cases["flash_be"]]
    server.sync()

    for fam in kernels.FAMILIES:
        fam.reset_counts()
    stop = threading.Event()
    loop = threading.Thread(target=server.serve_forever, args=(stop,),
                            daemon=True)
    loop.start()
    try:
        # BE alone first: the profiler measures every candidate config
        warm = [be.launch(d, *a) for d, a in be_work]
        for j in warm:
            j.result(600)
        alone = [hp_request(hp, cfg, inp, weights, descs) for inp in inputs]
        be_jobs = [be.launch(d, *a) for _ in range(be_iters)
                   for d, a in be_work]
        coloc = [hp_request(hp, cfg, inp, weights, descs) for inp in inputs]
        hp_end = time.monotonic()
        be_done_at_hp_end = sum(j.done.is_set() for j in be_jobs)
        for j in be_jobs:
            j.result(600)
    finally:
        stop.set()
        loop.join(timeout=60)
    if loop.is_alive():
        raise RuntimeError("server loop did not stop")
    counts = {k: v for fam in kernels.FAMILIES
              for k, v in fam.launches.items()}

    # -- checks ---------------------------------------------------------------
    print("  BE configs chosen by the profiler:", flush=True)
    for j in warm:
        e = server.profiler.entry(j)
        print(f"    {j.desc.name}: {e.config} (exec {e.exec_time * 1e3:.2f} "
              f"ms, turnaround {e.turnaround * 1e3:.3f} ms)")
    for (d, a), ref_out in zip(be_work, (refs["mm_be"], refs["flash_be"])):
        kind = "matmul" if d.name.startswith("matmul") else "flash"
        for j in [x for x in warm + be_jobs if x.desc is d]:
            compare(f"server BE {d.name}", j.result(0)[0], ref_out[0], kind)
    from repro_torch.core.descriptor import new_outputs
    for r, (lat, jobs, y) in enumerate(alone):
        if tuple(y.shape) != (S, E) or not torch.isfinite(y).all():
            raise AssertionError(f"HP request {r}: bad output")
        for (d, j), (_, jc) in zip(jobs, coloc[r][1]):
            plain = new_outputs(d, dev)
            d.kernel.plain_version(d, j.args, plain)
            kind = "matmul" if d.name.startswith("matmul") else "flash"
            compare(f"server HP req{r} {d.name}", j.result(0)[0], plain[0],
                    kind)
            if not torch.equal(j.result(0)[0], jc.result(0)[0]):
                raise AssertionError(f"HP request {r}: co-located output "
                                     "differs from the alone run")
    last_be = max(j.complete_t for j in be_jobs)
    for r, (lat, jobs, _) in enumerate(coloc):
        if max(j.complete_t for _, j in jobs) > last_be:
            raise AssertionError(f"HP request {r} finished after the BE "
                                 "work it overtook")
    print(f"  every co-located HP request finished before the BE work "
          f"({be_done_at_hp_end}/{len(be_jobs)} BE launches done when the "
          f"last request ended, {(last_be - hp_end) * 1e3:.1f} ms of BE "
          f"work after it)")

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs) * 1e3, q))

    la = [x[0] for x in alone]
    lc = [x[0] for x in coloc]
    print(f"  HP request latency alone: p50 {pct(la, 50):.3f} ms, p99 "
          f"{pct(la, 99):.3f} ms; co-located: p50 {pct(lc, 50):.3f} ms, "
          f"p99 {pct(lc, 99):.3f} ms", flush=True)
    print(f"  launches on the main path: {json.dumps(counts)}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"entry points never launched on the main "
                             f"path: {missing}")
    return counts


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    # the plain versions are the full-f32 reference: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.monotonic()
    built = kernels.build_all()
    print(f"  built {built} in {time.monotonic() - t0:.1f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")

    dev = torch.device("cuda")
    cfg = get_config("qwen2.5-14b")
    print("[2] kernel against plain version", flush=True)
    for label, (desc, args) in small_cases(dev).items():
        check_forms(label, desc, args, "small")
    cases = full_cases(cfg, dev)
    errs, refs = {}, {}
    for label, (desc, args) in cases.items():
        kind = "matmul" if label.startswith("mm") else "flash"
        errs[label], refs[label] = check_forms(label, desc, args, kind)

    print("[3] times at qwen2.5-14b width (bf16)", flush=True)
    rows = time_cases(cases, REPS, cfg.num_heads)

    print("[4] main path: Tally server, HP inference + BE training",
          flush=True)
    counts = server_phase(cfg, cases, refs, dev)

    fams = {f.name: f for f in kernels.FAMILIES}
    summary = []
    for fname, label in (("matmul", "mm_be"), ("flash", "flash_be")):
        fam = fams[fname]
        desc = cases[label][0]
        for form in ("plain", "sliced", "persistent"):
            r = rows[(label, form)]
            summary.append({
                "name": f"{fname}_{form}", "route": "cuda",
                "source": fam.source, "replaces": fam.replaces,
                "shape": desc.name,
                "launches": counts[f"{fname}_{form}"],
                "max_abs_err": errs[label][form], **r})
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
