#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py          # one CUDA card; exits non-zero without one

Phases, each raising on failure:
  1. card and build: the card's name and power limit, then every kernel
     built from ``src/repro_torch/kernels/csrc`` (one nvcc per source);
  2. kernel against plain: each kernel family in each launch form (plain;
     sliced with k=3; persistent with W=132 and budgets cycling 1, 2, 5)
     against its plain PyTorch version, at the small parity shapes of the
     transform tests (f32, the CUDA-core route), at the edges of the
     tensor-core route (bf16: K not a multiple of 64, 256-wide blocks,
     chunked-prefill and non-causal flash, D = 64; the SSD scan at chunk
     lengths 256, 150, 64 and 1 and at DS = 64), at the qwen2.5-14b
     shapes of the main path and at the mamba2-130m shapes of the SSD scan
     (bf16);
  3. times at those shapes (the L = 150 and L = 1 prefills in the plain
     form only): kernel (on outputs made before the timed window), plain
     version (the plain form's kernel output held against it once more),
     one library call as yardstick where one PyTorch call computes the
     same function (timed here only, never used by the port) and the
     bound max(flops / 989 TFLOP/s, bytes / 3.35 TB/s);
  4. the main path: a TallyServer on the card, a best-effort "training"
     client with the full-width matmul, flash attention and SSD scan, and a
     high-priority "inference" client sending prefill requests of one
     qwen2.5-14b decoder layer (one of them traced by torch.profiler);
  5. the model path: mamba2-130m at full width on its use_pallas path,
     served by the ported ServingEngine (6 requests, 8 new tokens each);
     every prefill of every layer runs the SSD kernel, and each prompt's
     prefill is held against the torch-ops path;
  6. the dense model path: qwen2.5-14b at full width (48 layers, 14.8 B
     f32 parameters) on its use_pallas path behind the ServingEngine, the
     same 6 requests; every prefill of every layer runs flash attention
     and every prefill and decode step the three SwiGLU matmuls; each
     prompt's prefill is held against the torch-ops path (f32 and bf16)
     and, layer by layer in bf16, against the kernels' plain versions;
     the kernels are held against their plain versions and timed at every
     serving shape (each prompt length and a decode step);
     then the serving driver ``repro_torch.launch.serve`` once, at the
     reduced width it runs;
  7. training on the card: (a) the gradients of mamba2-130m at full width
     cut to 2 layers (f32) on the card against the CPU; (b) the full model
     trained by ``repro_torch.launch.train`` for 20 steps (bf16
     activations, f32 masters, remat, AdamW), one step traced and the
     optimizer update timed; (c) 8 steps straight against 4 + checkpoint +
     resume to 8, in a subprocess under deterministic algorithms
     (``--restart-gate``); (d) the paper's scenario: phase 5's engine
     serving its six prompts in two waves, alone and with a second
     full-width mamba2-130m trainer taking one step in each of the idle
     quanta between the waves; the HP tokens must be equal; (e) the
     serving driver with ``colocate_train=True``;
  8. the MoE and audio model paths: (a) qwen3-moe-30b-a3b at full width
     cut to 8 of its 48 layers (5.6 B f32 parameters) on its use_pallas
     path behind the ServingEngine, phase 5's 6 requests; every prefill of
     every layer runs flash attention (G = 8, D = 128), the MoE block runs
     torch ops as the reference's runs einsums; each prompt's prefill held
     layer by layer from one input against the torch-ops path and the
     kernels' plain versions, the flipped top-k share printed; flash timed
     at each served length; then the serving driver on reduced qwen3-moe
     and jamba; (b) whisper-base whole (109.7 M parameters): the encoder
     on 2 x 1500 random frame embeddings (non-causal flash attention, the
     SwiGLU matmuls at M = 3000), a 16-token decoder prefill and 8 greedy
     decode steps (matmuls at M = 2) with the cross K/V in the cache, every
     token row of each kernel-bearing sub-block held from one input
     against the torch-ops path and the plain versions;
  9. the serving steps: deepseek-coder-33b whole (62 layers, 33.34 B
     parameters drawn leaf by leaf in bf16, 62.1 GiB) on its use_pallas
     path through ``make_prefill_step`` (4 prompts of 512 tokens) and 16
     greedy ``make_decode_step`` steps (the cache padded to 1024) on the
     one-card mesh; every prefill layer runs flash attention (G = 7, D =
     128) and the three SwiGLU matmuls (M = 2048), every decode step the
     matmuls at M = 4; the shardings put every leaf whole on the card, the
     decode step passes the cache through and writes its row, each first
     token equals the prompt's own B = 1 prefill's, and the layers are
     held from one input against the plain versions (bf16) and the
     torch-ops path (f32 activations); then ``ef_compress_tree`` over
     phase 7's gradient tree on the card, bit for bit the CPU's;
 10. the co-location example at full width, observed by the telemetry hub:
     qwen2.5-14b whole on its use_pallas path behind the ServingEngine
     (capacity 4), driven by the serving driver's own loop (``drive``: 12
     requests of 4 to 11 tokens at MAF2-like arrivals, 6 new tokens each),
     beside a full-width mamba2-130m ``BestEffortTrainer`` (B = 8, S = 512,
     torch ops) taking one step in each idle quantum; runs (a) alone, (b)
     co-located, (c) co-located without a hub, (d) an outage, (e) an outage
     with failover; the HP tokens of (a)-(c) equal, each hub's registry
     equal to its engine's account (requests, latency count and sum, TTFT
     count, sheds, retries, BE quanta, hedges), the exposition and the
     JSONL round trips exact, (d) shedding and (e) recovering; every
     prefill runs flash attention and every prefill and decode step the
     three SwiGLU matmuls, held and timed at the prompt lengths 4 to 11;
     then ``python -m repro_torch.colocate_serve_train --chaos --failover``
     at the reduced width that ``serve`` runs;
 11. the dry run (``repro_torch.launch.dryrun``, a cost model on meta
     tensors, no launches): (a) one cell per family on the (16, 16) and
     (2, 16, 16) meshes, with every cell that ``shape_applicable`` skips,
     each status as it says, and a cell re-meshed by the elastic plan; (b)
     phase 9's prefill and decode steps priced on the one-card mesh: the
     predicted argument bytes equal to the bytes phase 9 passed,
     ``fits_hbm`` true for both and false for a train step with f32
     masters, the predicted roofline terms and peak against phase 9's
     device ms and peaks;
 12. the train step sharded over a mesh of processes: ``python -m
     repro_torch.launch.train --full --nproc 2`` trains mamba2-130m whole
     (B = 8, S = 512, 5 steps) on the (2, 1) and (1, 2) meshes, both ranks
     of one gloo group on ``cuda:0`` (parameters and optimizer state stored
     by the reference's shardings as DTensors, compute on gathered
     tensors, all-reduces only); every loss within SHARDED_LOSS_TOL of
     ``train()`` in one process, each rank's argument bytes equal to the
     dry run's for the mesh, every shard on the card. No kernel runs: the
     train step runs torch ops (``use_pallas`` training is refused);
 13. the serving steps sharded over a mesh of processes, tensor-parallel
     on the model axis and the MoE blocks expert-parallel over the data
     axes (``make_prefill_step`` / ``make_decode_step``'s
     ``sharded_fn``), the ranks of one gloo group all on ``cuda:0``
     (each ``chip_smoke.py --sharded-serving-rank JOB``), each drawing
     only its shards, cut to their first layers as the whole model draws
     them: qwen2.5-14b in bf16 cut to 2 layers on (1, 2) and to 24 on
     (1, 3) (its attention weights whole on every rank, 3, 3 and 2 kv
     groups of 5 heads), mamba2-130m cut to 8 layers on (1, 2), (2, 1)
     and the production model axis (1, 16) (2 SSD heads on ranks 0-11,
     none on 12-15; 4 decode steps), qwen3-moe-30b-a3b cut to 8 layers
     on (2, 1) and (2, 2), jamba-1.5-large-398b's first period (experts'
     d_ff 6144) on (2, 2), on phase 9's traffic; whisper-base whole on
     (1, 3) (encoder, decoder and cross-attention on 3, 3 and 2 heads,
     its MLP, embedding and head whole) on phase 8 (b)'s. Against one
     process running the same steps on the same weights here first:
     each layer from one input (the encoder's, prefill and decode
     outputs, the cache at the rank's positions, the cross K/V, the
     decode token's row; a MoE layer's mixer half, and its block fed one
     process's FFN input with the same top-k sets) within PLAIN_TOL, the
     rest of the cache passed through; the first PLAIN_LAYERS layers (and
     jamba's first attention layer) through the kernels within PLAIN_TOL
     of their plain versions on the same shards (the MLP's matmuls with
     the f32 partial, flash and the SSD at shard shapes); argument bytes
     and all-to-all bytes equal to the dry run's, peak memory below the
     step's arguments (shards, batch, cache) plus one whole leaf plus the
     step's temporaries, every kernel launched at the rank's shard
     shapes (a rank with no heads launching no flash or SSD kernel), every
     kernel family of the path on some rank.
``python3 chip_smoke.py --gloo-probe`` lists which collectives gloo
carries on CUDA tensors in the card's torch (a pair of ranks each);
``--reduce-probe`` times the model axis's all-gather and sum against its
all_reduce on 2, 3 and 16 ranks; ``--phase13-draws`` runs phase 13's
gates on other draws of its 8-layer qwen2.5-14b run, and in f32.
Phases 4, 5, 6, 7 (d), 8 (a), 8 (b), 9, 10 and 13 each zero the launch counts
before their path and read them after; every entry point of the path must
have run, and no bf16 launch may have taken a CUDA-core (f32) route. The
line before the last is the kernels' JSON summary, the last line ``{"ok":
true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 (data sheet)
SMALL_TOL = dict(rtol=1e-4, atol=1e-4)
WORKERS, SLICES, BUDGETS = 132, 3, (1, 2, 5)
# phase 5: prompt lengths (chunk lengths L = 256, 150, 1, 100, 64, 256)
PROMPTS, NEW_TOKENS = (512, 300, 257, 100, 64, 512), 8
# phase 5 gates, relative L2 error of the kernel path against torch ops:
# f32 logits and states (sum order through 24 layers), bf16 layer-0 state
MODEL_TOL_F32, STATE0_TOL = 1e-3, 1e-4
# phase 6 gate (b), relative L2 error of bf16 layer 1's k cache, the first
# cache entry made from the kernels' outputs: the CPU rehearsal
# (``rehearse_gates``) gives 1.9e-2 to 2.8e-2 over the six prompts (the
# random init's attention is near one-hot, and the two paths round q's
# scaling and P apart), so 5e-2
KV1_TOL = 5e-2
# phase 6 gate (c), relative L2 error of each of the first PLAIN_LAYERS
# layers in bf16 (attention, MLP and layer output), the kernels against
# their plain versions from the same input: the CPU rehearsal with the
# kernels' roundings emulated (``rehearse_gates``) gives 6.3e-4 to 7.2e-4
# for the attention and the layer, 3.0e-3 to 3.25e-3 for the MLP (its bf16
# input rounds apart where the attention differs), so 1e-2
PLAIN_LAYERS, PLAIN_TOL = 2, 1e-2
# phase 7: (a) the card's loss and gradients against the CPU's, f32 with
# TF32 off (sums in another order); (b) the reference's training gate
# (tests/test_train_driver.py); (c) its restart tolerance; (d) the idle
# engine steps between the two waves, one BE quantum each
GRAD_LOSS_TOL, GRAD_REL_TOL = 1e-4, 1e-4
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, LOSS_DROP = 20, 8, 512, 0.1
RESTART_TOL = dict(rtol=2e-4, atol=2e-5)
IDLE_QUANTA = 5
# phase 8 (a): qwen3-moe-30b-a3b at full width, cut to MOE_LAYERS of its 48
# layers (5.61 B f32 parameters, 20.9 GiB; cut from 24 layers, 58.0 GiB,
# to pay for phase 13's expert-parallel runs; all 48 hold 113.7 GiB);
# gate (b), relative L2 error of each layer's bf16 attention sub-block on
# the kernel path against the torch-ops path from the same input: the CPU
# rehearsal (``rehearse_phase8``) gives 1.7e-2 to 2.1e-2, so 5e-2
MOE_LAYERS = 8
MOE_ATTN_TOL = 5e-2
# phase 8 (b): whisper-base whole, B = 2 sequences of 1500 frames, a
# 16-token prompt and 8 greedy decode steps; relative L2 error of each row
# (one token) of each bf16 sub-block on the kernel path against the
# torch-ops path from the same input: the CPU rehearsal
# (``rehearse_phase8``) gives at most 2.8e-3, so 5e-2, as MOE_ATTN_TOL
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_STEPS = 2, 16, 8
WHISPER_TOL = 5e-2
# phase 9: deepseek-coder-33b whole (62 layers, 33.34 B parameters, 62.1 GiB
# in bf16) through the serving steps: STEPS_BATCH prompts of STEPS_PROMPT
# tokens prefilled, the cache padded to STEPS_CAPACITY, STEPS_NEW greedy
# decode steps; its layer-wise gates are phase 6's (PLAIN_TOL, MODEL_TOL_F32)
STEPS_BATCH, STEPS_PROMPT, STEPS_CAPACITY, STEPS_NEW = 4, 512, 1024, 16
# phase 9, relative L2 error of layer 0's k and v row that the first decode
# step writes at index STEPS_PROMPT, against the same row of a B = 1
# prefill of the prompt and its first token: one projection deep, so the
# random init's chaos does not reach it. The two differ in the
# projection's M (STEPS_BATCH rows against STEPS_PROMPT + 1), so in the
# order of the f32 sums, and round apart by at most a bf16 step (2^-8 =
# 3.9e-3 relative) where they round at all; a row from another position,
# token or layer reads O(1) (0.27 to 1.6 at reduced width). The CPU
# rehearsal reads 0 (the same ops at both M), an H100 2.8e-4, so 1e-2
DECODE_ROW_TOL = 1e-2
# the error-feedback identity of the gradient compression, within the
# reference's tolerance (tests/test_compression.py)
EF_TOL = dict(rtol=1e-5, atol=1e-6)
# phase 10: the co-location example's traffic (12 requests of 4 to 11
# tokens, 6 new tokens each, MAF2-like arrivals at 50/s); the chaos runs'
# request budget is max(OBS_TIMEOUT_FLOOR, 2 p99 of the run alone), the
# outage 1.5 budgets, so only the outage's victims time out
OBS_REQUESTS, OBS_NEW_TOKENS, OBS_PROMPTS = 12, 6, tuple(range(4, 12))
OBS_TIMEOUT_FLOOR = 6.0
# phase 12: the train step sharded over two ranks of one gloo group, both
# on the one card; mamba2-130m whole at phase 7's batch for 5 steps on the
# (2, 1) and (1, 2) meshes, each loss within SHARDED_LOSS_TOL of one
# process with as many microbatches as data shards:
# tests/test_torch_sharded_train.py's TRAIN_LOSS_TOL for train() at its
# default dtypes (bit for bit on the CPU; against one microbatch on (2, 1)
# the reduced model lies 4.4e-3 away over 12 steps, the reference's own
# meshes 2.1e-3 apart over 3). At the step builders' default lr: at
# train()'s 3e-3 the whole model's loss jumps (11.27, 13.06, 9.33 in its
# first steps on an H100), which magnifies any change in the sums' order
SHARDED_STEPS, SHARDED_LOSS_TOL, SHARDED_LR = 5, 1e-2, 3e-4
# phase 13: the serving steps sharded over a mesh of ranks of one gloo
# group on the one card, tensor-parallel on the model axis and the MoE
# blocks expert-parallel over the data axes, each run an arch on its
# meshes and traffic (batch, prompt, capacity, decode steps), cut to its
# first ``layers`` layers where given, drawn as the whole model draws them
# (``widths`` replace a config's, for the reduced rehearsals and jamba's
# cut):
# phase 9's (STEPS_BATCH prompts of STEPS_PROMPT tokens, decode against a
# cache of STEPS_CAPACITY, so that on (1, 2) the decode writes land in
# rank 1's half, just past the boundary) and phase 8 (b)'s for
# whisper-base (its self cache of 48 split over positions on (1, 3));
# each layer from one input within PLAIN_TOL of one process, and the
# first PLAIN_LAYERS within PLAIN_TOL of the plain versions. (1, 3)
# divides none of qwen2.5-14b's 40 heads, 8 kv heads and 5120, nor
# whisper-base's 8 heads, 2048 and 512; (1, 16), the production model
# axis, not mamba2-130m's 24 SSD heads; (2, 1) splits qwen3-moe-30b-a3b's
# 128 experts over data alone, (2, 2) its experts over data and each
# expert's columns and the heads over model. A run's weights are drawn
# from ``seed``.
SEED = 0


class ShardedRun(NamedTuple):
    arch: str
    meshes: tuple
    traffic: tuple
    widths: tuple = ()
    layers: int = 0
    seed: int = SEED


STEPS_TRAFFIC = (STEPS_BATCH, STEPS_PROMPT, STEPS_CAPACITY, STEPS_NEW)
# jamba-1.5-large-398b cut to one period of its 8-layer interleave (the
# stack takes whole periods), its experts' hidden width from 24576 to
# 6144: one period at its published widths holds 84.07 GiB in bf16 on
# one process and 96.15 GiB over (2, 2)'s ranks, the cut one 30.07 and
# 42.15 GiB; every other width stays published
JAMBA_PERIOD = (("num_layers", 8), ("moe.d_ff", 6144))
# waves of runs: a wave's meshes run their ranks at once, each mesh's
# start-up (processes, CUDA, the shards' draw) beside the others'. The
# first's 12 ranks hold ~60 GiB of the card; the 16 ranks of (1, 16)
# share their wave with jamba's 4 (~51 GiB): gloo's latency grows with the
# ranks on the host's cores (the 16 ranks' decode 1.8 tokens/s alone, 1.1
# beside jamba), but the wave took 120.0 s against 104.8 s for the 16
# ranks alone and some 40 s for jamba's (NVIDIA H100 80GB HBM3, 700 W);
# qwen3-moe's 6 ranks (~30 GiB) last, as they fit beside neither
SHARDED_SERVING = (
    (ShardedRun("qwen2.5-14b", ((1, 2),), STEPS_TRAFFIC, layers=2),
     ShardedRun("mamba2-130m", ((1, 2), (2, 1)), STEPS_TRAFFIC, layers=8),
     ShardedRun("qwen2.5-14b", ((1, 3),), STEPS_TRAFFIC, layers=24),
     ShardedRun("whisper-base", ((1, 3),),
                (WHISPER_BATCH, WHISPER_PROMPT, 48, WHISPER_STEPS))),
    (ShardedRun("mamba2-130m", ((1, 16),),
                (STEPS_BATCH, STEPS_PROMPT, STEPS_CAPACITY, 4), layers=8),
     ShardedRun("jamba-1.5-large-398b", ((2, 2),), STEPS_TRAFFIC,
                widths=JAMBA_PERIOD)),
    (ShardedRun("qwen3-moe-30b-a3b", ((2, 1), (2, 2)), STEPS_TRAFFIC,
                layers=8),))
# phase 11: the dry run's cells, one shape per family on both production
# meshes (the whole sweep, some 3 min on a CPU, is the CLI's: ``python -m
# repro_torch.launch.dryrun --all --mesh both``), and a deepseek-coder-33b
# train step with f32 masters on one card, which cannot fit (124.2 GiB of
# parameters alone)
DRYRUN_CELLS = (("qwen2.5-14b", "decode_32k"),
                ("qwen3-moe-30b-a3b", "train_4k"),
                ("mamba2-130m", "long_500k"),
                ("jamba-1.5-large-398b", "decode_32k"),
                ("whisper-base", "prefill_32k"),
                ("qwen2-vl-7b", "train_4k"))
REPS = 5                      # timed runs per kernel form (median kept)
# a sleep kernel of ~20 ms at the H100's clocks ahead of each timed window
HIDE_HOST_CYCLES = 40_000_000


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# Running one launch form to completion: the kernel or its plain version
# ---------------------------------------------------------------------------


def run_form(desc, args, form: str, kernel: bool, outs=None):
    """Outputs (and the persistent form's ``done`` per launch) of ``desc``
    run to completion in ``form`` by the CUDA kernel or the plain version,
    into ``outs`` if given (every form writes every tile), else into fresh
    zeroed buffers."""
    from repro_torch.core import transforms as T
    from repro_torch.core.descriptor import new_outputs
    fam = desc.kernel
    if outs is None:
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


def bf16_ulp(x: torch.Tensor, floor: float = 2.0 ** -8) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits), no smaller than at
    ``floor``."""
    mag = x.float().abs().clamp_min(floor)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def p_rounding_slack(desc, args):
    """What rounding P to bf16 before P·V may add to a bf16 flash output.

    The tensor-core kernel rounds each p_j (<= 1) to bf16, which keeps 8
    significant bits: a relative error d_j of at most 2^-8 (half an ulp at
    the bottom of a binade). The row's output is sum_j p_j v_j / l with l
    summed from the unrounded p, so the error sum_j d_j p_j v_j / l, with
    independent d_j, is of order 2^-8 max|v| / sqrt(n) for a row that
    attends n keys (and 0 for n = 1, whose p = 1 is exact); for softmax
    weights of random scores that is some 8 standard deviations of it.
    Returns that bound for each query row, (1, S, 1), or 0 for any other
    launch."""
    if desc.kernel.name != "flash" or args[0].dtype != torch.bfloat16:
        return 0.0
    s = desc.static
    rows = torch.arange(args[0].shape[1], device=args[0].device)
    n = ((rows + s["q_offset"] + 1).clamp(1, s["T"]) if s["causal"]
         else torch.full_like(rows, s["T"]))
    vmax = args[2].float().abs().max()
    return (2.0 ** -8 * vmax / n.float().sqrt())[None, :, None]


def compare(name, got, want, kind: str, slack=0.0) -> float:
    """Max abs error of ``got`` against ``want``; raises past tolerance.
    ``slack`` (flash attention only) is ``p_rounding_slack``."""
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
    elif kind == "ssd" and got.dtype == torch.float32:
        # the SSD state h: f32 sums of the same terms in another order
        bound = 1e-4 * w.abs().max().item()
        ok = max_abs <= bound
        tol = f"max_abs <= 1e-4*max|ref| = {bound:.3e}"
    elif kind == "ssd":
        # y: f32 sums in another order, then one rounding to bf16; the
        # sums' error scales with their terms, of the order of max|y|, so
        # the ulp is taken no smaller than at 2^-8 max|y|
        floor = 2.0 ** -8 * w.abs().max().item()
        ok = bool((err <= 2 * bf16_ulp(w, floor)).all())
        tol = "<= 2 bf16 ulps (ulps taken no smaller than at 2^-8 max|ref|)"
    else:
        # f32 online softmax in another order, then one rounding to bf16:
        # the two may round apart by an ulp or so; and P rounded to bf16
        # before P·V on the tensor cores (p_rounding_slack)
        ok = bool((err <= 2 * bf16_ulp(w) + slack).all())
        tol = ("<= 2 bf16 ulps (ulps taken no smaller than at 2^-8) + "
               "2^-8 max|v|/sqrt(keys attended)")
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
        slack = p_rounding_slack(desc, args)
        errs[form] = max(
            compare(f"{label} {form}" + (f" out{i}" if i else ""), k, p,
                    kind, slack)
            for i, (k, p) in enumerate(zip(k_outs, p_outs)))
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
    cases = {"matmul 96x64x48 f32": mm, "flash 6x32x32x8 g2 causal f32": fl}
    # the SSD scan: the transform tests' parity geometry, a prime S (L = 1)
    # and S < chunk
    for B, S, NH, HD, DS, chunk in ((3, 24, 2, 4, 4, 8), (2, 13, 2, 4, 4, 8),
                                    (2, 20, 3, 8, 5, 32)):
        desc, args = ssd_case(rng, dev, B, S, NH, HD, DS, chunk, f32)
        L = desc.static["L"]
        cases[f"ssd {B}x{S}x{NH}x{HD}x{DS} chunk {chunk} L={L} f32"] = (
            desc, args)
    return cases


# bf16 launches at the edges of the tensor-core route: K not a multiple of
# the 64-deep stage; 256-wide blocks, walked as 128 x 128 sub-tiles;
# chunked prefill (T != S, q_offset > 0); non-causal with a ragged last key
# tile; G = 5 with D = 64, where bq = 192 leaves the second pass's second
# consumer without rows; the SSD scan at mamba2-130m width (B = 3) with the
# chunk lengths of phase 5's prompts: 256-token pieces cut across chunks of
# 150 and 64 tokens and hold 256 chunks of one token, S = 300 and 257 end
# in a ragged slab; and DS = 64, where one consumer holds the whole state
TC_EDGES = {
    "mm_tc 256x200x384 b128": dict(M=256, K=200, N=384, blk=128),
    "mm_tc 512x320x512 b256": dict(M=512, K=320, N=512, blk=256),
    # column tiles of the MLP split over 16 ranks (qwen2.5-14b's 13824 /
    # 16, qwen2-vl-7b's 18944 / 16) and whisper-base's 688 of its 2048 on
    # (1, 3): the largest divisor of N up to 128 would be 108, 74 and 86
    "mm_tc 512x5120x864 b128": dict(M=512, K=5120, N=864, blk=128),
    "mm_tc 512x3584x1184 b128": dict(M=512, K=3584, N=1184, blk=128),
    "mm_tc 256x512x688 b128": dict(M=256, K=512, N=688, blk=128),
    "flash_tc chunked S=128 T=384 q_offset=256":
        dict(S=128, T=384, D=128, causal=True, q_offset=256, bq=256),
    "flash_tc non-causal S=256 T=320":
        dict(S=256, T=320, D=128, causal=False, q_offset=0, bq=256),
    "flash_tc D=64 G=5 S=T=384":
        dict(S=384, T=384, D=64, causal=True, q_offset=0, bq=192),
    "ssd_tc L=256 S=512": dict(S=512, chunk=256, DS=128),
    "ssd_tc L=150 S=300": dict(S=300, chunk=256, DS=128),
    "ssd_tc L=64 S=192": dict(S=192, chunk=64, DS=128),
    "ssd_tc L=1 S=257": dict(S=257, chunk=256, DS=128),
    "ssd_tc DS=64 S=512": dict(S=512, chunk=256, DS=64),
}


def tc_cases(dev):
    """The ``TC_EDGES`` launches (flash: 10 heads, G = 5; the SSD: B = 3,
    24 heads of 64)."""
    from repro_torch.kernels.flash_attention import flash_attention_desc
    from repro_torch.kernels.matmul import matmul_desc
    rng = np.random.default_rng(11)
    bf = torch.bfloat16
    cases = {}
    for label, g in TC_EDGES.items():
        if label.startswith("ssd"):
            cases[label] = ssd_case(rng, dev, 3, g["S"], 24, 64, g["DS"],
                                    g["chunk"], bf)
            continue
        if label.startswith("mm"):
            M, K, N = g["M"], g["K"], g["N"]
            cases[label] = (matmul_desc(M, K, N, bf, bm=g["blk"],
                                        bn=g["blk"]),
                            (tensor(rng, (M, K), bf, dev),
                             tensor(rng, (K, N), bf, dev, 1 / math.sqrt(K))))
            continue
        BH, G, S, T, D = 10, 5, g["S"], g["T"], g["D"]
        cases[label] = (flash_attention_desc(BH, S, T, D, G, bf,
                                             causal=g["causal"],
                                             q_offset=g["q_offset"],
                                             bq=g["bq"]),
                        (tensor(rng, (BH, S, D), bf, dev),
                         tensor(rng, (BH // G, T, D), bf, dev),
                         tensor(rng, (BH // G, T, D), bf, dev)))
    return cases


def check_route(desc, before, route: str) -> None:
    """Every launch since ``before`` (a copy of the family's counts) took
    ``route``, in each of the three forms."""
    fam = desc.kernel
    for form in ("plain", "sliced", "persistent"):
        for r in fam.routes:
            sym = fam.symbol(r, form)
            ran = fam.launches[sym] - before[sym]
            if (r == route) != (ran > 0):
                raise AssertionError(f"{desc.name} {form}: {sym} launched "
                                     f"{ran} times, but the route is {route}")


def ssd_case(rng, dev, B, S, NH, HD, DS, chunk, dtype):
    """An SSD launch as the model makes it: x, Bm, Cm in ``dtype`` (B and C
    scaled so that C.B is of order one), dt, A and D in f32."""
    from repro_torch.kernels.mamba2_scan import mamba2_scan_desc

    def f32(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    args = (tensor(rng, (B, S, NH, HD), dtype, dev),
            f32(rng.uniform(0.1, 0.9, size=(B, S, NH))),
            -f32(rng.uniform(0.5, 2.0, size=(NH,))),
            tensor(rng, (B, S, DS), dtype, dev, DS ** -0.25),
            tensor(rng, (B, S, DS), dtype, dev, DS ** -0.25),
            f32(rng.standard_normal(size=(NH,))))
    return mamba2_scan_desc(B, S, NH, HD, DS, chunk, dtype), args


def ssd_full_cases(cfg, dev, seqs=PROMPTS[:5], batch_be=264, seq_be=512):
    """The SSD launches of the mamba2 path at the model's width (bf16): one
    HP prefill per prompt length of phase 5 (L = 256, 150, 1, 100, 64) and
    the BE job of phase 4, whose batch is two waves of 132 blocks."""
    rng = np.random.default_rng(SEED + 3)
    s = cfg.ssm
    NH, HD, DS = s.num_heads(cfg.d_model), s.head_dim, s.d_state
    cases = {}
    for S in seqs:
        label = "ssd_hp" if S == seqs[0] else f"ssd_hp_s{S}"
        cases[label] = ssd_case(rng, dev, 1, S, NH, HD, DS, s.chunk_size,
                                torch.bfloat16)
    cases["ssd_be"] = ssd_case(rng, dev, batch_be, seq_be, NH, HD, DS,
                               s.chunk_size, torch.bfloat16)
    return cases


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


def cuda_ms(fn, reps: int, warmup: int = 1, hide_host: bool = True
            ) -> float:
    """Median ms of ``fn`` over ``reps`` runs, each between CUDA events.
    With ``hide_host``, a sleep kernel ahead of the first event keeps the
    card busy while the host enqueues ``fn``'s launches (tens of µs each,
    as long as a small kernel), so the time is the launches' device time
    back to back, not the host's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(HIDE_HOST_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def launch_bytes(desc) -> float:
    """The bytes a launch must move, each input read once and each output
    written once. For the SSD they come from its tensors: x, dt, A, B, C
    and D read, y and the f32 state h written; the descriptor's count is
    the reference's, which leaves h out and counts dt at x's itemsize. For
    the matmul and flash attention the descriptor's count matches their
    tensors."""
    if desc.kernel.name != "ssd":
        return desc.bytes_accessed
    ((B, S, NH, HD), dtype), ((_, _, _, DS), _) = desc.out_shape
    io = dtype.itemsize
    return float(2 * B * S * NH * HD * io + 2 * B * S * DS * io
                 + B * S * NH * 4 + 2 * NH * 4 + B * NH * HD * DS * 4)


def bound(desc):
    t_ops = desc.flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = launch_bytes(desc) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def library_fn(label, desc, args, heads: int):
    """One PyTorch call computing the same function (yardstick only), or
    None where there is none: no single PyTorch call computes the SSD
    scan."""
    import torch.nn.functional as F
    if label.startswith("ssd"):
        return None
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


def time_cases(cases, reps: int, heads: int, plain_only=()):
    """Each form of each case (the plain form alone for the labels in
    ``plain_only``) timed on outputs made before the timed window (a fresh
    zeroed f32 output of mm_be alone is 226 MB to write), and the plain
    form's kernel output held against the plain version's (run once, for
    its time): the row gets its ``max_abs_err``. On the CPU nothing is
    timed (the times are None) and the comparison alone runs. The matmul
    kernel writes f32, as the reference's does; ``torch.matmul``, the
    yardstick, writes bf16."""
    from repro_torch.core.descriptor import new_outputs

    def clock(fn, n, **kw):
        if on_card:
            return cuda_ms(fn, n, **kw)
        fn()
        return None

    def ms_s(ms, fmt):
        return "not timed" if ms is None else f"{ms:{fmt}} ms"

    rows = {}
    for label, (desc, args) in cases.items():
        on_card = args[0].is_cuda
        b_ms, b_by = bound(desc)
        lib = library_fn(label, desc, args, heads)
        lib_ms = None if lib is None or not on_card else cuda_ms(lib, reps)
        ref = new_outputs(desc, args[0].device, zero=True)
        # the plain version's eager tile walk is host-bound: its time is
        # the host's
        plain_ms = clock(lambda: run_form(desc, args, "plain", False, ref),
                         1, warmup=0, hide_host=False)
        outs = new_outputs(desc, args[0].device, zero=True)
        forms = (("plain",) if label in plain_only
                 else ("plain", "sliced", "persistent"))
        for form in forms:
            ms = clock(lambda: run_form(desc, args, form, True, outs), reps)
            rows[(label, form)] = dict(ms=ms, plain_ms=plain_ms,
                                       bound_ms=b_ms, bound_by=b_by,
                                       library_ms=lib_ms)
            if form == "plain":
                rows[(label, form)]["max_abs_err"] = max(
                    compare(f"{label} plain", k, p, desc.kernel.name,
                            p_rounding_slack(desc, args))
                    for k, p in zip(outs, ref))
            share = "" if ms is None else f", {b_ms / ms:.1%} of bound"
            print(f"  {label} {form}: kernel {ms_s(ms, '.3f')}, plain "
                  f"version {ms_s(plain_ms, '.1f')}, library "
                  f"{'none' if lib is None else ms_s(lib_ms, '.3f')}, bound "
                  f"{b_ms:.4f} ms ({b_by}){share}", flush=True)
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


def cuda_core_guard(counts, where: str) -> None:
    """No bf16 launch of a family that has a tensor-core route may take its
    CUDA-core route: on the main path those are all bf16."""
    from repro_torch import kernels
    from repro_torch.kernels.launch import CUDA_CORES, TENSOR_CORES
    wrong = {fam.symbol(CUDA_CORES, f): counts[fam.symbol(CUDA_CORES, f)]
             for fam in kernels.FAMILIES if TENSOR_CORES in fam.routes
             for f in ("plain", "sliced", "persistent")}
    if any(wrong.values()):
        raise AssertionError(f"bf16 launches on the {where} took the "
                             f"CUDA-core route: {wrong}")


def main_path_symbols():
    """The entry points the main path launches: each family's
    tensor-core route where it has one, else its only route."""
    from repro_torch import kernels
    from repro_torch.kernels.launch import TENSOR_CORES
    return [fam.symbol(TENSOR_CORES if TENSOR_CORES in fam.routes
                       else next(iter(fam.routes)), f)
            for fam in kernels.FAMILIES
            for f in ("plain", "sliced", "persistent")]


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
    be_labels = [lb for lb in ("mm_be", "flash_be", "ssd_be") if lb in cases]
    be_work = [cases[lb] for lb in be_labels]
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
        # where a lone request's time goes (its launches count on the path)
        profile_once("lone HP request",
                     lambda: hp_request(hp, cfg, inputs[0], weights, descs),
                     dev)
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
    for (d, a), lb in zip(be_work, be_labels):
        for j in [x for x in warm + be_jobs if x.desc is d]:
            for k, (got, want) in enumerate(zip(j.result(0), refs[lb])):
                compare(f"server BE {d.name} out{k}", got, want,
                        d.kernel.name, p_rounding_slack(d, a))
    from repro_torch.core.descriptor import new_outputs
    for r, (lat, jobs, y) in enumerate(alone):
        if tuple(y.shape) != (S, E) or not torch.isfinite(y).all():
            raise AssertionError(f"HP request {r}: bad output")
        for (d, j), (_, jc) in zip(jobs, coloc[r][1]):
            plain = new_outputs(d, dev)
            d.kernel.plain_version(d, j.args, plain)
            compare(f"server HP req{r} {d.name}", j.result(0)[0], plain[0],
                    d.kernel.name, p_rounding_slack(d, j.args))
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

    la = [x[0] for x in alone]
    lc = [x[0] for x in coloc]
    print(f"  HP request latency alone: p50 {pct(la, 50):.3f} ms, p99 "
          f"{pct(la, 99):.3f} ms; co-located: p50 {pct(lc, 50):.3f} ms, "
          f"p99 {pct(lc, 99):.3f} ms", flush=True)
    print(f"  launches on the main path: {json.dumps(counts)}")
    cuda_core_guard(counts, "main path")
    missing = [k for k in main_path_symbols() if counts[k] <= 0]
    if missing:
        raise AssertionError(f"entry points never launched on the main "
                             f"path: {missing}")
    return counts


# ---------------------------------------------------------------------------
# The model path: mamba2 behind the ported ServingEngine
# ---------------------------------------------------------------------------


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative L2 error ||got - want|| / ||want|| in f32."""
    g, w = got.float(), want.float()
    return ((g - w).norm() / w.norm().clamp_min(1e-30)).item()


def pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def serve(model, params, prompts, scfg, new_tokens):
    """Requests for ``prompts`` through a fresh ServingEngine, run until
    idle. Returns (requests, seconds of each decode step, wall seconds)."""
    from repro_torch.device import synchronize
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(model, params, scfg)
    dev = params["embed"].device
    decode_s = []
    step = eng._decode

    def timed(*a):
        t = time.monotonic()
        out = step(*a)
        synchronize(dev)
        decode_s.append(time.monotonic() - t)
        return out

    eng._decode = timed
    synchronize(dev)
    t0 = time.monotonic()
    reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    eng.run_until_idle()
    synchronize(dev)
    return reqs, decode_s, time.monotonic() - t0


def check_served(cfg, dev, reqs, prompts, new_tokens, decode_s, wall):
    """Every request answered with ``new_tokens`` in-vocab tokens; prints
    TTFT, request latency, decode tokens/s and the peak device memory."""
    for r, n in zip(reqs, prompts):
        if not r.done or r.shed or len(r.tokens) != new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.rid} ({n} tokens): "
                                 f"{len(r.tokens)} tokens, done={r.done}")
    ttft = [r.ttft for r in reqs]
    lat = [r.latency for r in reqs]
    dec_tokens = sum(len(r.tokens) - 1 for r in reqs)
    print(f"  {len(reqs)} requests of {list(prompts)} tokens, "
          f"{new_tokens} new tokens each, in {wall * 1e3:.1f} ms", flush=True)
    print(f"  TTFT by request {[round(t * 1e3, 1) for t in ttft]} ms")
    print(f"  TTFT p50 {pct(ttft, 50):.1f} ms, p99 {pct(ttft, 99):.1f} ms; "
          f"request latency p50 {pct(lat, 50):.1f} ms, p99 "
          f"{pct(lat, 99):.1f} ms; decode {dec_tokens} tokens in "
          f"{len(decode_s)} steps, {dec_tokens / sum(decode_s):.1f} tokens/s "
          f"({sum(decode_s) / len(decode_s) * 1e3:.2f} ms a step)")
    if dev.type == "cuda":
        print(f"  peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")


def model_phase(cfg, dev, prompts=PROMPTS, new_tokens=NEW_TOKENS,
                capacity=4, max_len=1024):
    """mamba2 on its use_pallas path behind the ported ServingEngine, with
    weights drawn from a seeded generator on the device. Every prefill of
    every layer runs the SSD kernel; decode runs ``ssd_decode`` (torch
    ops). Returns the launch counts of the run."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.kernels.mamba2_scan import chunk_len
    from repro_torch.models.common import param_count_tree
    from repro_torch.models.transformer import build_model
    from repro_torch.serving import ServingConfig
    cfg = dataclasses.replace(cfg, use_pallas=True)
    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    rng = np.random.default_rng(SEED + 4)
    toks = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in prompts]
    scfg = ServingConfig(capacity=capacity, max_len=max_len)
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {param_count_tree(params) / 1e6:.1f} M "
          f"parameters ({cfg.param_dtype}), activations {cfg.dtype}; "
          f"ServingEngine(capacity={capacity}, max_len={max_len})",
          flush=True)
    serve(model, params, toks[-2:-1], scfg, 2)      # warm-up, not counted
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    for fam in kernels.FAMILIES:
        fam.reset_counts()
    reqs, decode_s, wall = serve(model, params, toks, scfg, new_tokens)
    counts = {k: v for fam in kernels.FAMILIES
              for k, v in fam.launches.items()}

    # -- checks ---------------------------------------------------------------
    check_served(cfg, dev, reqs, prompts, new_tokens, decode_s, wall)

    # each prompt's prefill, the kernel path against the torch-ops path
    # (ssd_chunked), on the same weights. Gated: (a) with f32 activations,
    # the logits and every layer's ssm_state, whose difference is the sums'
    # order (~1e-6 a layer) carried through 24 layers; (b) in bf16, as
    # served, layer 0's ssm_state, whose inputs are identical in both paths.
    # Printed only: bf16 logits and deeper states, where the paths' y round
    # apart by an ulp here and there and 24 random-init layers amplify it.
    models = {(dt, pal): build_model(dataclasses.replace(
        cfg, dtype=dt, use_pallas=pal))
        for dt in (torch.float32, cfg.dtype) for pal in (True, False)}
    for n, t in zip(prompts, toks):
        x = torch.as_tensor(t[None], dtype=torch.long, device=dev)
        err = {}
        for dt in (torch.float32, cfg.dtype):
            lk, ck = models[(dt, True)].prefill(params, x)
            lp, cp = models[(dt, False)].prefill(params, x)
            if not torch.isfinite(lk).all():
                raise AssertionError(f"prefill of {n} tokens: non-finite")
            err[dt] = (rel_err(lk, lp),
                       [rel_err(ck["ssm_state"][i], cp["ssm_state"][i])
                        for i in range(cfg.num_layers)])
        e32, ebf = err[torch.float32], err[cfg.dtype]
        ok = (max(e32[0], *e32[1]) <= MODEL_TOL_F32
              and ebf[1][0] <= STATE0_TOL)
        print(f"  prefill {n} tokens (L={chunk_len(n, cfg.ssm.chunk_size)}): "
              f"f32 logits rel err {e32[0]:.2e}, states max "
              f"{max(e32[1]):.2e} [<= {MODEL_TOL_F32:g}]; bf16 layer-0 "
              f"state {ebf[1][0]:.2e} "
              f"[<= {STATE0_TOL:g}] {'ok' if ok else 'FAIL'}; bf16 logits "
              f"{ebf[0]:.2e}, states max {max(ebf[1]):.2e} (not gated)",
              flush=True)
        if not ok:
            raise AssertionError(f"prefill of {n} tokens: the kernel path "
                                 "disagrees with the torch-ops path")
    ops_reqs, _, _ = serve(models[(cfg.dtype, False)], params, toks, scfg,
                           new_tokens)
    same = sum(a == b for r, o in zip(reqs, ops_reqs)
               for a, b in zip(r.tokens, o.tokens))
    print(f"  greedy tokens equal to the torch-ops path's: {same}/"
          f"{len(reqs) * new_tokens} (printed, not gated)")
    where_the_time_goes(model, params, cfg, dev, toks[0], capacity)

    print(f"  launches on the model path: {json.dumps(counts)}")
    cuda_core_guard(counts, "model path")
    need = cfg.num_layers * len(prompts)
    if counts["ssd_plain"] < need:
        raise AssertionError(f"ssd_plain launched {counts['ssd_plain']} "
                             f"times on the model path, fewer than "
                             f"{need}: entry points never launched")
    return counts


def where_the_time_goes(model, params, cfg, dev, prompt, capacity,
                        max_len=1, span=None):
    """One lone prefill and one decode step of ``capacity`` slots, each
    slot holding the prompt (a k/v cache of ``max_len`` positions), each
    traced by ``profile_once`` (with its ``span``)."""
    from repro_torch.configs import kv_cache_specs
    x = torch.as_tensor(prompt[None], dtype=torch.long, device=dev)
    cache = {k: torch.zeros(shape, dtype=dtype, device=dev) for k, (
        shape, dtype) in kv_cache_specs(cfg, capacity, max_len).items()}
    tok = torch.zeros(capacity, 1, dtype=torch.long, device=dev)
    lengths = torch.full((capacity,), min(len(prompt), max_len - 1),
                         dtype=torch.int32, device=dev)
    profile_once(f"prefill {len(prompt)} tokens",
                 lambda: model.prefill(params, x), dev, span)
    profile_once(f"decode step, {capacity} slots",
                 lambda: model.decode_step(params, tok, cache, lengths), dev,
                 span)


@contextlib.contextmanager
def traced_as(owner, name: str):
    """Within the block, every call of ``owner.name`` runs inside a
    torch.profiler range called ``name``, so that ``profile_once`` can
    read its kernels' share of the trace."""
    fn = getattr(owner, name)

    def ranged(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)

    setattr(owner, name, ranged)
    try:
        yield
    finally:
        setattr(owner, name, fn)


def kernel_rows(prof, span=None):
    """The kernels' own events of a ``torch.profiler`` trace as (ms, count,
    name), largest first (an operator's self device time repeats its
    kernels' time; a range's device-side annotation, ``span``, is not a
    kernel)."""
    from torch.autograd import DeviceType
    return sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.key != span),
                  reverse=True)


def profile_once(label, fn, dev, span=None):
    """``fn`` timed on the host clock (after one warm-up call) and traced
    by torch.profiler: device-busy time (the kernels' summed self time),
    idle share and the top kernels; with ``span``, the device time of the
    kernels launched inside the profiler ranges of that name
    (``traced_as``) and their share of the busy time, from the same trace.
    The profiler's own host cost inflates the traced wall time. Returns
    the device-busy ms, or None where the trace saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.device import synchronize
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    fn()
    synchronize(dev)
    t = time.monotonic()
    fn()
    synchronize(dev)
    bare = time.monotonic() - t
    with profile(activities=acts) as prof:
        t = time.monotonic()
        fn()
        synchronize(dev)
        traced = time.monotonic() - t
    rows = kernel_rows(prof, span)
    busy = sum(r[0] for r in rows)
    if not rows:
        print(f"  {label}: {bare * 1e3:.2f} ms; device time not measured "
              "(the profiler saw no device activity)")
        return None
    within = ""
    if span is not None:
        # a host range's device time is its launched kernels' time
        ms = sum(e.device_time_total for e in prof.events()
                 if e.name == span and e.device_type == DeviceType.CPU) / 1e3
        within = f", {span} {ms:.3f} ms of it ({ms / busy:.1%})"
    print(f"  {label}: {bare * 1e3:.2f} ms; traced {traced * 1e3:.2f} ms, "
          f"device busy {busy:.3f} ms{within}, idle share "
          f"{1 - busy / (traced * 1e3):.1%}; top by device time:")
    for ms, count, key in rows[:6]:
        print(f"    {ms:8.3f} ms  {count:5d}x  {key[:70]}")
    return busy


# ---------------------------------------------------------------------------
# The dense model path: qwen2.5-14b behind the ported ServingEngine
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def kernels_as(**impl):
    """Within the block, the families named in ``impl`` (``matmul``,
    ``flash``, ``ssd``) run ``impl[name](desc, args, outs)`` where a model
    launches their plain form; the rest run as they are. It stands in for
    the plain form only, the one that the model's ``ops`` call."""
    from repro_torch import kernels
    fams = {f.name: f for f in kernels.FAMILIES}
    for name, fn in impl.items():
        fams[name].plain = fn
    try:
        yield
    finally:
        for name in impl:
            del fams[name].plain


def plain_versions():
    """The model's kernel calls run the kernels' plain versions, on any
    device: the reference side of gate (c)."""
    from repro_torch import kernels
    return kernels_as(**{f.name: f.plain_version for f in kernels.FAMILIES})


def emulated_tensor_cores():
    """The bf16 kernels' roundings emulated in PyTorch, to rehearse gate
    (c) on the CPU (where the kernel path runs the plain versions): the
    matmul's f32 sums in another order (summed in f64, then rounded to
    f32), flash attention's P rounded to bf16 before P·V with l summed from
    the unrounded P (``p_rounding_slack``), in one pass over the keys."""

    def matmul(desc, args, outs):
        a, b = args
        outs[0].copy_((a.double() @ b.double()).float())

    def flash(desc, args, outs):
        q, k, v = args
        st = desc.static
        kf = k.float().repeat_interleave(st["group"], dim=0)
        vf = v.float().repeat_interleave(st["group"], dim=0)
        sc = (q.float() / math.sqrt(st["D"])) @ kf.transpose(1, 2)
        if st["causal"]:
            pos = torch.arange(max(q.shape[1], st["T"]), device=q.device)
            qpos = st["q_offset"] + pos[:q.shape[1], None]
            sc = sc.masked_fill(qpos < pos[None, :st["T"]], -math.inf)
        p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
        o = (p.bfloat16().float() @ vf) / p.sum(-1, keepdim=True).clamp_min(
            1e-30)
        outs[0].copy_(o.to(outs[0].dtype))

    return kernels_as(matmul=matmul, flash=flash)


def layerwise(kern, ref, params, x, layers, kern_ctx=contextlib.nullcontext,
              ref_ctx=contextlib.nullcontext):
    """Gates (a) and (c) for one prompt: each of the first ``layers``
    layers of the model ``kern`` (run inside ``kern_ctx()``) against the
    same layer of ``ref`` (inside ``ref_ctx()``) from the same input,
    ``ref``'s own output of the layer before: the attention block's output
    (flash attention), the SwiGLU MLP's output (three matmuls) and the
    layer's output. Returns the largest relative error of each over the
    layers. Layer by layer, because random layers amplify a difference:
    carried through the whole stack, the sums' order alone grows some 15
    to 40 times a layer (``rehearse_gates``)."""
    from repro_torch.models.transformer import _layer
    h = ref.embed_tokens(params, x)
    worst = [0.0, 0.0, 0.0]
    for i in range(layers):
        lp = _layer(params["layers"]["p0"], i)
        with kern_ctx():
            got = kern._sublayer(0, lp, h)
        with ref_ctx():
            want = ref._sublayer(0, lp, h)
        worst = [max(w, rel_err(g, o)) for w, g, o in zip(
            worst, (got[1], got[2], got[0]), (want[1], want[2], want[0]))]
        h = want[0]
    return worst


def dense_gates(cfg, dev, params, prompts, toks, f32_prompts,
                plain_layers=PLAIN_LAYERS):
    """Each prompt's prefill on the kernel path against the torch-ops path
    (chunked attention, torch matmuls) on the same weights. Gated: (a) for
    the prompts in ``f32_prompts``, with f32 activations, each layer's
    attention, MLP and output from the same input (``layerwise``), whose
    difference is the sums' order; (b) in bf16, as served, through the
    whole prefill, layer 1's k, the first cache entry made from the
    kernels' outputs (layer 0's k and v come before any kernel: printed,
    they must be equal); (c) in bf16, as served, the first
    ``plain_layers`` layers from the same input through the kernels and
    through their plain versions (``layerwise``), whose difference is the
    kernels' own rounding. Printed only: bf16 logits and deeper caches,
    which random layers amplify."""
    import dataclasses
    from repro_torch.models.transformer import build_model
    models = {pal: build_model(dataclasses.replace(cfg, use_pallas=pal))
              for pal in (True, False)}
    f32 = [build_model(dataclasses.replace(cfg, dtype=torch.float32,
                                           use_pallas=pal))
           for pal in (True, False)]
    L = cfg.num_layers
    for n, t in zip(prompts, toks):
        x = torch.as_tensor(t[None], dtype=torch.long, device=dev)
        t0 = time.monotonic()
        lk, ck = models[True].prefill(params, x)
        lp, cp = models[False].prefill(params, x)
        if not torch.isfinite(lk).all():
            raise AssertionError(f"prefill of {n} tokens: non-finite")
        kv1 = rel_err(ck["k"][1], cp["k"][1])
        kv0 = all(torch.equal(ck[key][0], cp[key][0]) for key in ("k", "v"))
        kv_max = max(rel_err(ck[key][i], cp[key][i])
                     for key in ("k", "v") for i in range(L))
        del ck, cp
        e16 = layerwise(models[True], models[True], params, x, plain_layers,
                        ref_ctx=plain_versions)
        ok = kv1 <= KV1_TOL and max(e16) <= PLAIN_TOL
        line = f"  prefill {n} tokens: "
        if n in f32_prompts:
            e32 = layerwise(*f32, params, x, L)
            ok = ok and max(e32) <= MODEL_TOL_F32
            line += (f"f32 layer by layer: attention {e32[0]:.2e}, MLP "
                     f"{e32[1]:.2e}, output {e32[2]:.2e} "
                     f"[<= {MODEL_TOL_F32:g}]; ")
        else:
            line += "f32 not gated; "
        print(line + f"bf16 layer-1 k {kv1:.2e} [<= {KV1_TOL:g}]; bf16 "
              f"kernels vs plain versions, {plain_layers} layers: attention "
              f"{e16[0]:.2e}, MLP {e16[1]:.2e}, output {e16[2]:.2e} "
              f"[<= {PLAIN_TOL:g}] {'ok' if ok else 'FAIL'}; bf16 layer-0 "
              f"k/v equal: {kv0}; bf16 logits {rel_err(lk, lp):.2e}, k/v max "
              f"{kv_max:.2e} (not gated); {time.monotonic() - t0:.1f} s",
              flush=True)
        if not ok:
            raise AssertionError(f"prefill of {n} tokens: the kernel path "
                                 "disagrees with the torch-ops path or the "
                                 "plain versions")
    return models[False]


def weight_cast_ms(params, cfg) -> float:
    """Device time of the casts that one forward pass makes of the f32
    weights to the activation type: every attention and MLP weight of every
    layer and the lm_head (the reference casts at each call)."""
    from repro_torch.models.transformer import _layer
    stack = params["layers"]["p0"]
    leaves = [w for i in range(cfg.num_layers)
              for sub in ("attn", "ffn")
              for w in _layer(stack[sub], i).values()] + [params["lm_head"]]
    n = sum(w.numel() for w in leaves)

    def cast():
        for w in leaves:
            w.to(cfg.dtype)

    ms = cuda_ms(cast, 3)
    gb = n * (4 + 2) / 1e9
    print(f"  per-forward weight casts f32 -> {cfg.dtype}: {n / 1e9:.2f} G "
          f"parameters, {gb:.1f} GB moved, {ms:.2f} ms (bound "
          f"{gb * 1e9 / PEAK_BYTES * 1e3:.2f} ms)", flush=True)
    return ms


def mm_serve_cases(cfg, dev, Ms, rng):
    """The SwiGLU MLP's launches (bf16) at each row count in ``Ms``: the
    up-projection (E x F, as x @ wg and x @ wi) and the down-projection
    (F x E), block geometry of the reference's ``_pick_block``."""
    from repro_torch.kernels.matmul import matmul_desc
    bf = torch.bfloat16
    E, F = cfg.d_model, cfg.d_ff
    weights = {"up": tensor(rng, (E, F), bf, dev, 1 / math.sqrt(E)),
               "down": tensor(rng, (F, E), bf, dev, 1 / math.sqrt(F))}
    cases = {}
    for M in Ms:
        for proj, w in weights.items():
            K, N = w.shape
            cases[f"mm_serve_{proj}_m{M}"] = (
                matmul_desc(M, K, N, bf), (tensor(rng, (M, K), bf, dev), w))
    return cases


def flash_serve_cases(cfg, dev, seqs, rng, batch=1, causal=True,
                      label="flash_serve"):
    """A prefill's flash attention (bf16) at the model's heads, at each
    length in ``seqs`` for ``batch`` sequences (bq = 1 at a prime
    length)."""
    from repro_torch.kernels.flash_attention import flash_attention_desc
    bf = torch.bfloat16
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    BH, BKV = batch * H, batch * KVH
    return {f"{label}_s{S}": (
        flash_attention_desc(BH, S, S, D, H // KVH, bf, causal=causal),
        (tensor(rng, (BH, S, D), bf, dev), tensor(rng, (BKV, S, D), bf, dev),
         tensor(rng, (BKV, S, D), bf, dev))) for S in seqs}


def serving_cases(cfg, dev, prompts=PROMPTS, decode_rows=4):
    """The dense serving path's kernel launches at full width (bf16), at
    each prompt length that phase 6 serves: the MLP's matmuls at M = the
    prompt length and at a decode step of ``decode_rows`` slots, and the
    prefill's flash attention."""
    rng = np.random.default_rng(SEED + 5)
    seqs = sorted(set(prompts), reverse=True)
    return {**mm_serve_cases(cfg, dev, (*seqs, decode_rows), rng),
            **flash_serve_cases(cfg, dev, seqs, rng)}


def dense_phase(cfg, dev, prompts=PROMPTS, new_tokens=NEW_TOKENS,
                capacity=4, max_len=1024, f32_prompts=PROMPTS):
    """qwen2.5-14b on its use_pallas path behind the ported ServingEngine,
    with weights drawn from a seeded generator on the device. Every prefill
    of every layer runs flash attention; every prefill and decode step of
    every layer runs the three SwiGLU matmuls. Returns the launch counts of
    the served run and the serving-shape kernel rows."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.models.common import param_count_tree
    from repro_torch.models.transformer import build_model
    from repro_torch.serving import ServingConfig
    cfg = dataclasses.replace(cfg, use_pallas=True)
    model = build_model(cfg)
    t0 = time.monotonic()
    params = model.init(SEED, device=dev)
    n_params = param_count_tree(params)
    rng = np.random.default_rng(SEED + 4)
    toks = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in prompts]
    scfg = ServingConfig(capacity=capacity, max_len=max_len)
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv heads of "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.3f} B parameters ({cfg.param_dtype}, "
          f"{n_params * 4 / 2 ** 30:.1f} GiB, drawn in "
          f"{time.monotonic() - t0:.1f} s), activations {cfg.dtype}; "
          f"ServingEngine(capacity={capacity}, max_len={max_len})",
          flush=True)
    serve(model, params, toks[-2:-1], scfg, 2)      # warm-up, not counted
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    for fam in kernels.FAMILIES:
        fam.reset_counts()
    reqs, decode_s, wall = serve(model, params, toks, scfg, new_tokens)
    counts = {k: v for fam in kernels.FAMILIES
              for k, v in fam.launches.items()}

    # -- checks ---------------------------------------------------------------
    check_served(cfg, dev, reqs, prompts, new_tokens, decode_s, wall)
    ops_model = dense_gates(cfg, dev, params, prompts, toks, f32_prompts)
    ops_reqs, _, _ = serve(ops_model, params, toks, scfg, new_tokens)
    same = sum(a == b for r, o in zip(reqs, ops_reqs)
               for a, b in zip(r.tokens, o.tokens))
    print(f"  greedy tokens equal to the torch-ops path's: {same}/"
          f"{len(reqs) * new_tokens} (printed, not gated)")
    where_the_time_goes(model, params, cfg, dev, toks[0], capacity, max_len)
    if dev.type == "cuda":
        weight_cast_ms(params, cfg)
    print("  the kernels at the serving shapes (plain form, as served):",
          flush=True)
    cases = serving_cases(cfg, dev, prompts, capacity)
    rows = time_cases(cases, REPS, cfg.num_heads, plain_only=tuple(cases))

    print(f"  launches on the dense model path: {json.dumps(counts)}")
    cuda_core_guard(counts, "dense model path")
    L = cfg.num_layers
    need = {"flash_plain": L * len(prompts),
            "matmul_plain": 3 * L * (len(prompts) + len(decode_s))}
    short = {k: (counts[k], v) for k, v in need.items() if counts[k] < v}
    if short:
        raise AssertionError(f"entry points launched fewer times than the "
                             f"dense path needs (launched, needed): {short}")
    return counts, rows


def rehearse_gates(layers=2, vocab=1024, prompts=PROMPTS,
                   dtype=torch.bfloat16):
    """CPU rehearsal of phase 6's bf16 prefill gates at full width:
    qwen2.5-14b cut to ``layers`` layers and a ``vocab``-token vocabulary,
    activations in ``dtype``. Gate (b): the kernel path (the plain versions
    on the CPU) against the torch-ops path, each layer's k error and the
    logits'. Gate (c): the kernels' roundings emulated
    (``emulated_tensor_cores``) against the plain versions, layer by layer.
    Prints one line per prompt.

        python3 -c 'import chip_smoke as c; c.rehearse_gates()'
    """
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import build_model
    dev = torch.device("cpu")
    cfg = dataclasses.replace(get_config("qwen2.5-14b"), num_layers=layers,
                              vocab_size=vocab, dtype=dtype)
    kern = build_model(dataclasses.replace(cfg, use_pallas=True))
    ops = build_model(cfg)
    params = kern.init(SEED, device=dev)
    rng = np.random.default_rng(SEED + 4)
    for n in prompts:
        x = torch.as_tensor(rng.integers(0, vocab, size=(1, n)))
        lk, ck = kern.prefill(params, x)
        lp, cp = ops.prefill(params, x)
        errs = [f"{rel_err(ck['k'][i], cp['k'][i]):.3e}"
                for i in range(layers)]
        e16 = layerwise(kern, kern, params, x, layers,
                        kern_ctx=emulated_tensor_cores)
        print(f"prefill {n} tokens ({dtype}): (b) k rel err by layer {errs}, "
              f"logits {rel_err(lk, lp):.3e}; layer 0 k/v equal: "
              f"{torch.equal(ck['k'][0], cp['k'][0])}; (c) emulated kernels "
              f"vs plain versions: attention {e16[0]:.3e}, MLP "
              f"{e16[1]:.3e}, output {e16[2]:.3e}", flush=True)


# ---------------------------------------------------------------------------
# Training: the BE tenant
# ---------------------------------------------------------------------------


def leaf_paths(tree, prefix=""):
    """``tree`` (nested dicts) with each leaf replaced by its path."""
    if isinstance(tree, dict):
        return {k: leaf_paths(v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return prefix


def grad_gate(cfg, dev, ref_dev, batch=2, seq=512, layers=2):
    """Gate (a): loss and gradients of ``cfg`` cut to ``layers`` layers, in
    f32, on ``dev`` against ``ref_dev`` (the path that
    tests/test_torch_train.py holds against the JAX package), the same
    seeded parameters and one ``SyntheticLMDataset`` batch. Returns (loss
    error, the largest relative L2 error of a gradient leaf)."""
    import dataclasses
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.steps import compute_grads
    from repro_torch.models.transformer import build_model
    from repro_torch.tree import tree_flatten, tree_map
    cfg = dataclasses.replace(cfg, num_layers=layers, dtype=torch.float32)
    model = build_model(cfg)
    ref_params = model.init(SEED, device=ref_dev)
    params = tree_map(lambda t: t.to(dev), ref_params)
    host = SyntheticLMDataset(DataConfig(cfg.vocab_size, seq, batch,
                                         seed=SEED)).batch_at(0)
    runs = []
    for d, p in ((dev, params), (ref_dev, ref_params)):
        b = {k: torch.as_tensor(v, dtype=torch.long, device=d)
             for k, v in host.items()}
        t0 = time.monotonic()
        loss, grads = compute_grads(model, p, b)
        runs.append((float(loss), tree_flatten(grads)[0],
                     time.monotonic() - t0))
    (loss, g, t), (rloss, rg, rt) = runs
    if not math.isfinite(loss):
        raise AssertionError("gate (a): non-finite loss")
    errs = [rel_err(a.to(ref_dev), b) for a, b in zip(g, rg)]
    ok = abs(loss - rloss) <= GRAD_LOSS_TOL and max(errs) <= GRAD_REL_TOL
    names = tree_flatten(leaf_paths(ref_params))[0]
    worst = sorted(zip(errs, names), reverse=True)[:3]
    print(f"  (a) {cfg.name} cut to {layers} layers (d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}), f32, B={batch}, S={seq}: loss "
          f"{loss:.6f} on {dev}, {rloss:.6f} on {ref_dev} (|diff| "
          f"{abs(loss - rloss):.2e} [<= {GRAD_LOSS_TOL:g}]); gradients of "
          f"{len(errs)} leaves, largest rel L2 err {max(errs):.2e} "
          f"[<= {GRAD_REL_TOL:g}] {'ok' if ok else 'FAIL'} ({t:.1f} s and "
          f"{rt:.1f} s); largest: "
          f"{', '.join(f'{n} {e:.2e}' for e, n in worst)}", flush=True)
    if not ok:
        raise AssertionError("gate (a): the card's gradients disagree with "
                             "the CPU's")
    return abs(loss - rloss), max(errs)


def rehearse_grad_gate(layers=2, batch=2, seq=512, threads=(8, 1)):
    """How far the sums' order alone moves each gradient leaf of gate (a):
    mamba2-130m at full width cut to ``layers`` layers, f32, on the CPU
    with each thread count of ``threads``; prints each leaf's relative L2
    difference between the two.

        python3 -c 'import chip_smoke as c; c.rehearse_grad_gate()'
    """
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.steps import compute_grads
    from repro_torch.models.transformer import build_model
    from repro_torch.tree import tree_flatten
    cfg = dataclasses.replace(get_config("mamba2-130m"), num_layers=layers,
                              dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(SEED, device="cpu")
    b = {k: torch.as_tensor(v, dtype=torch.long) for k, v in
         SyntheticLMDataset(DataConfig(cfg.vocab_size, seq, batch,
                                       seed=SEED)).batch_at(0).items()}
    before = torch.get_num_threads()
    grads = []
    try:
        for n in threads:
            torch.set_num_threads(n)
            grads.append(tree_flatten(compute_grads(model, params, b)[1])[0])
    finally:
        torch.set_num_threads(before)
    names = tree_flatten(leaf_paths(params))[0]
    for name, a, c in zip(names, *grads):
        print(f"{name}: {rel_err(a, c):.2e} between {threads[0]} and "
              f"{threads[1]} threads")


def train_gate(dev, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               reduced=False):
    """Gate (b): ``repro_torch.launch.train`` on the full mamba2-130m (its
    reduced config with ``reduced``, for a rehearsal on the CPU), then
    one step traced (host and device time, idle share) and the AdamW
    update timed against its bound (each parameter, gradient and moment
    read once, each parameter and moment written once: 28 bytes a
    parameter)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.device import synchronize
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (compute_grads, make_optimizer,
                                          make_train_step)
    from repro_torch.launch.train import train
    from repro_torch.models.common import param_count_tree
    from repro_torch.models.transformer import build_model
    from repro_torch.tree import tree_map
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = train("mamba2-130m", reduced=reduced, steps=steps, batch=batch,
                seq=seq, device=dev, log_every=5)
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    losses = out["losses"]
    ok = all(math.isfinite(x) for x in losses) and out["loss_drop"] > LOSS_DROP
    step_ms = float(np.median(out["step_ms"][1:]))
    print(f"  (b) train('mamba2-130m', reduced={reduced}, steps={steps}, "
          f"batch={batch}, seq={seq}) on {out['device']}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, drop {out['loss_drop']:.4f} "
          f"[> {LOSS_DROP:g}], all finite: "
          f"{all(math.isfinite(x) for x in losses)} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    print(f"  step host ms (first {out['step_ms'][0]:.1f}, median of the "
          f"rest {step_ms:.2f}), {batch * seq / step_ms * 1e3:.0f} tokens/s"
          + ("" if peak is None else f", peak device memory {peak:.2f} GiB"))
    if not ok:
        raise AssertionError("gate (b): the full model did not train")
    del out

    cfg = get_config("mamba2-130m")
    cfg = cfg.reduced() if reduced else cfg
    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    opt = make_optimizer(cfg)
    state = opt.init(params)
    step = make_train_step(model, make_host_mesh(device=dev),
                           ShapeConfig("t", seq, batch, "train")).fn
    b = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
         for k, v in SyntheticLMDataset(DataConfig(
             cfg.vocab_size, seq, batch, seed=SEED)).batch_at(0).items()}
    profile_once(f"one train step (B={batch}, S={seq}, remat "
                 f"{cfg.remat})", lambda: step(params, state, b), dev)
    _, grads = compute_grads(model, params, b)
    n = param_count_tree(params)
    bound_ms = n * 28 / PEAK_BYTES * 1e3
    if dev.type == "cuda":
        ms = cuda_ms(lambda: opt.update(params, grads, state, 1.0), REPS)
        print(f"  AdamW update of {n / 1e6:.1f} M parameters: {ms:.3f} ms, "
              f"bound {bound_ms:.3f} ms (28 B a parameter at "
              f"{PEAK_BYTES / 1e12:.2f} TB/s), {bound_ms / ms:.1%} of "
              "bound", flush=True)
    synchronize(dev)
    return tree_map(lambda g: g.cpu(), grads)


def restart_gate(dev, ckpt_dir, steps=8, batch=4, seq=256, reduced=False):
    """Gate (c), the reference's restart case at full width: 8 steps
    straight against 4 steps + checkpoint + resume to 8, final parameters
    within the reference's tolerance. Run under deterministic algorithms
    (``--restart-gate``: cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG`` before
    its first call)."""
    from repro_torch.launch.train import train
    from repro_torch.tree import tree_flatten
    kw = dict(reduced=reduced, steps=steps, batch=batch, seq=seq,
              log_every=100, lr=1e-2, device=dev)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.monotonic()
    try:
        straight = train("mamba2-130m", **kw)
        train("mamba2-130m", ckpt_dir=str(ckpt_dir), ckpt_every=steps // 2,
              total_steps=steps, **{**kw, "steps": steps // 2})
        resumed = train("mamba2-130m", ckpt_dir=str(ckpt_dir),
                        ckpt_every=100, resume=True, **kw)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    worst, same = 0.0, True
    for a, b in zip(tree_flatten(straight["params"])[0],
                    tree_flatten(resumed["params"])[0]):
        a, b = a.float(), b.float()
        excess = ((a - b).abs() - RESTART_TOL["rtol"] * b.abs()).max().item()
        worst = max(worst, excess)
        same = same and torch.equal(a, b)
    ok = worst <= RESTART_TOL["atol"]
    print(f"  (c) {steps} steps straight vs {steps // 2} + checkpoint + "
          f"resume ({'reduced' if reduced else 'full'} width, B={batch}, "
          f"S={seq}, deterministic algorithms: "
          f"{torch.are_deterministic_algorithms_enabled()}): bit-equal "
          f"{same}; max(|diff| - rtol|ref|) "
          f"{worst:.2e} [<= atol {RESTART_TOL['atol']:g}, rtol "
          f"{RESTART_TOL['rtol']:g}] {'ok' if ok else 'FAIL'}; losses "
          f"{[round(x, 4) for x in straight['losses'][steps // 2:]]} and "
          f"{[round(x, 4) for x in resumed['losses']]}; "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    if not ok:
        raise AssertionError("gate (c): the resumed run disagrees with the "
                             "straight run")


def serve_waves(model, params, scfg, prompts, new_tokens, hook=None,
                idle=IDLE_QUANTA):
    """The prompts through a fresh ServingEngine in two waves: the first
    half, run until idle, then ``idle`` engine steps with nothing to serve
    (each one best-effort quantum when ``hook`` is given), then the second
    half. Returns (requests, the engine's BE quanta)."""
    from repro_torch.device import synchronize
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(model, params, scfg, best_effort_hook=hook)
    half = len(prompts) // 2
    reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts[:half]]
    eng.run_until_idle()
    for _ in range(idle):
        eng.step()
    reqs += [eng.submit(p, max_new_tokens=new_tokens)
             for p in prompts[half:]]
    eng.run_until_idle()
    synchronize(params["embed"].device)
    return reqs, eng.be_quanta


def colocation_gate(cfg, dev, prompts=PROMPTS, new_tokens=NEW_TOKENS,
                    capacity=4, max_len=1024, be_batch=TRAIN_BATCH,
                    be_seq=TRAIN_SEQ):
    """Gate (d), the paper's scenario: phase 5's engine (use_pallas) serves
    ``prompts`` in two waves, alone and with a second model's trainer
    (torch ops, parameters from ``SEED + 1``) taking one train step in each
    idle quantum between the waves. The HP tokens must be equal, token for
    token; every HP prefill must launch the SSD kernel. Returns the launch
    counts of the co-located run."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.device import synchronize
    from repro_torch.launch.serve import BestEffortTrainer
    from repro_torch.models.transformer import build_model
    from repro_torch.serving import ServingConfig
    model = build_model(dataclasses.replace(cfg, use_pallas=True))
    params = model.init(SEED, device=dev)
    rng = np.random.default_rng(SEED + 4)
    toks = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in prompts]
    scfg = ServingConfig(capacity=capacity, max_len=max_len)
    trainer = BestEffortTrainer(
        build_model(dataclasses.replace(cfg, use_pallas=False)),
        batch=be_batch, seq=be_seq, seed=SEED, device=dev)
    quantum_s = []

    def be_quantum():
        t = time.monotonic()
        trainer()
        synchronize(dev)
        quantum_s.append(time.monotonic() - t)

    serve_waves(model, params, scfg, toks[-2:-1], 2, idle=0)   # warm-up
    alone, _ = serve_waves(model, params, scfg, toks, new_tokens)
    for fam in kernels.FAMILIES:
        fam.reset_counts()
    coloc, quanta = serve_waves(model, params, scfg, toks, new_tokens,
                                hook=be_quantum)
    counts = {k: v for fam in kernels.FAMILIES
              for k, v in fam.launches.items()}

    same = sum(a.tokens == b.tokens for a, b in zip(alone, coloc))
    losses = [float(x) for x in trainer.losses]
    ok = (same == len(prompts) and quanta == trainer.quanta == IDLE_QUANTA
          and all(math.isfinite(x) for x in losses)
          and all(r.done and len(r.tokens) == new_tokens for r in coloc))
    for label, reqs in (("alone", alone), ("co-located", coloc)):
        ttft = [r.ttft for r in reqs]
        lat = [r.latency for r in reqs]
        print(f"  HP {label}: TTFT p50 {pct(ttft, 50):.1f} ms, p99 "
              f"{pct(ttft, 99):.1f} ms; latency p50 {pct(lat, 50):.1f} ms, "
              f"p99 {pct(lat, 99):.1f} ms", flush=True)
    print(f"  (d) {len(prompts)} requests in two waves, {quanta} BE quanta "
          f"between them [== {IDLE_QUANTA}]: HP tokens equal in {same}/"
          f"{len(prompts)} requests; BE losses {[round(x, 4) for x in losses]}"
          f" (finite: {all(math.isfinite(x) for x in losses)}); BE quantum "
          f"(one train step of B={be_batch}, S={be_seq}) "
          f"{[round(q * 1e3, 1) for q in quantum_s]} ms, longest "
          f"{max(quantum_s, default=0) * 1e3:.1f} ms: the longest an HP "
          f"request arriving in a quantum waits {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("gate (d): the co-located BE job changed the HP "
                             "answers or did not take its quanta")
    print(f"  launches on the co-located path: {json.dumps(counts)}")
    cuda_core_guard(counts, "co-located path")
    need = cfg.num_layers * len(prompts)
    if counts["ssd_plain"] < need:
        raise AssertionError(f"ssd_plain launched {counts['ssd_plain']} "
                             f"times on the co-located path, fewer than "
                             f"{need}: not every HP prefill ran the kernel")
    return counts


def training_phase(mcfg, dev):
    """Phase 7, gates (a) to (e); returns the launch counts of (d) and the
    full model's gradient tree of gate (b) (on the CPU), which phase 9
    compresses."""
    t0 = time.monotonic()
    grad_gate(mcfg, dev, torch.device("cpu"))
    grads = train_gate(dev)
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = Path(__file__).resolve().parent / "build" / "restart_gate"
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--restart-gate", str(ckpt)], env=env,
                         capture_output=True, text=True, timeout=600)
    sys.stdout.write(run.stdout)
    if run.returncode != 0:
        sys.stdout.write(run.stderr[-4000:])
        raise AssertionError(f"gate (c) exited {run.returncode}")
    counts = colocation_gate(mcfg, dev)
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.launch.serve import serve as serve_driver
    out = serve_driver("mamba2-130m", requests=16, colocate_train=True)
    print(f"  (e) repro_torch.launch.serve.serve('mamba2-130m', requests=16, "
          f"colocate_train=True) (reduced width): {json.dumps(out)}",
          flush=True)
    if (out["requests"] != 16 or out["shed"] or out["device"] != "cuda:0"
            or out["be_quanta"] <= 0):
        raise AssertionError("gate (e): the co-located serving driver did "
                             "not answer every request on the card with "
                             "BE quanta taken")
    print(f"  phase 7 in {time.monotonic() - t0:.1f} s", flush=True)
    return counts, grads


# ---------------------------------------------------------------------------
# Phase 8: the MoE and audio model paths
# ---------------------------------------------------------------------------


def flash_bq(cfg, S: int) -> int:
    """The query block of a prefill's flash launch at length ``S``."""
    from repro_torch.kernels.flash_attention import flash_attention_desc
    return flash_attention_desc(cfg.num_heads, S, S, cfg.head_dim_,
                                cfg.q_per_kv).static["bq"]


def moe_layerwise(kern, ref, params, x, layers,
                  kern_ctx=contextlib.nullcontext,
                  ref_ctx=contextlib.nullcontext):
    """Phase 8 (a)'s gates for one prompt, each of the first ``layers``
    layers from the same input (``ref``'s output of the layer before): the
    attention sub-block of ``kern`` (inside ``kern_ctx()``) against
    ``ref``'s (inside ``ref_ctx()``), and the share of tokens whose top-k
    set differs when each router is fed its own side's attention output.
    The next layer starts from ``ref``'s MoE block (torch ops on both
    paths: near-tied experts flip on the attention's rounding and move a
    token by O(1), so the paths are not compared past the router). Returns
    (largest attention relative error, flipped share)."""
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.moe import choose
    from repro_torch.models.transformer import _layer
    cfg = ref.cfg
    h = ref.embed_tokens(params, x)
    attn = 0.0
    flips = tokens = 0
    for i in range(layers):
        lp = _layer(params["layers"]["p0"], i)
        with kern_ctx():
            xk, ak, _ = kern._mixer(0, lp, h)
        with ref_ctx():
            xr, ar, _ = ref._mixer(0, lp, h)
        attn = max(attn, rel_err(ak, ar))
        h, _, _ = ref._ffn(0, lp, xr)
        sets = [choose(lp["ffn"], rms_norm(z, lp["ln2"], cfg.rms_eps),
                       cfg)[2].sort(dim=-1).values for z in (xk, xr)]
        flips += int((sets[0] != sets[1]).any(dim=-1).sum())
        tokens += sets[0][..., 0].numel()
    return attn, flips / tokens


def moe_gates(cfg, dev, params, prompts, toks):
    """Each prompt's prefill on the kernel path against the torch-ops path
    and the kernels' plain versions, layer by layer from one input
    (``moe_layerwise``). Gated: (a) with f32 activations, every layer's
    attention sub-block within MODEL_TOL_F32 of the torch-ops path's; (b)
    in bf16, as served, every layer's attention within MOE_ATTN_TOL of the
    torch-ops path's; (c) in bf16, the first PLAIN_LAYERS layers (one at a
    length whose query block is 1 row, where the plain version takes
    seconds a layer) within PLAIN_TOL of the kernels' plain versions.
    Printed: the flipped top-k share and the bf16 and f32 logits' errors
    through the whole prefill. Returns the torch-ops model and each
    prompt's greedy first token from the kernel path's own prefill."""
    import dataclasses
    from repro_torch.models.transformer import build_model
    models = {pal: build_model(dataclasses.replace(cfg, use_pallas=pal))
              for pal in (True, False)}
    f32 = [build_model(dataclasses.replace(cfg, dtype=torch.float32,
                                           use_pallas=pal))
           for pal in (True, False)]
    L = cfg.num_layers
    firsts = []
    for n, t in zip(prompts, toks):
        x = torch.as_tensor(t[None], dtype=torch.long, device=dev)
        t0 = time.monotonic()
        lk, _ = models[True].prefill(params, x)
        lp, _ = models[False].prefill(params, x)
        if not torch.isfinite(lk).all():
            raise AssertionError(f"prefill of {n} tokens: non-finite")
        firsts.append(int(lk[0, -1].argmax()))
        l32 = rel_err(*(m.prefill(params, x)[0] for m in f32))
        e16 = moe_layerwise(models[True], models[False], params, x, L)
        pl = 1 if flash_bq(cfg, n) == 1 else PLAIN_LAYERS
        ep = moe_layerwise(models[True], models[True], params, x, pl,
                           ref_ctx=plain_versions)
        e32 = moe_layerwise(*f32, params, x, L)
        ok = (e32[0] <= MODEL_TOL_F32 and e16[0] <= MOE_ATTN_TOL
              and ep[0] <= PLAIN_TOL)
        print(f"  prefill {n} tokens: (a) f32 layer by layer: attention "
              f"{e32[0]:.2e} [<= {MODEL_TOL_F32:g}], flipped top-"
              f"{cfg.moe.experts_per_token} sets {e32[1]:.2%}; "
              f"(b) bf16 layer by layer: attention {e16[0]:.2e} "
              f"[<= {MOE_ATTN_TOL:g}], flipped sets {e16[1]:.2%} (not "
              f"gated); (c) bf16 kernels vs plain versions, {pl} layers: "
              f"attention {ep[0]:.2e} [<= {PLAIN_TOL:g}], flipped sets "
              f"{ep[1]:.2%} {'ok' if ok else 'FAIL'}; logits through "
              f"the whole prefill: bf16 {rel_err(lk, lp):.2e}, f32 "
              f"{l32:.2e} (not gated); {time.monotonic() - t0:.1f} s",
              flush=True)
        if not ok:
            raise AssertionError(f"prefill of {n} tokens: the kernel path "
                                 "disagrees with the torch-ops path or the "
                                 "plain versions")
    return models[False], firsts


def moe_phase(cfg, dev, prompts=PROMPTS, new_tokens=NEW_TOKENS, capacity=4,
              max_len=1024, layers=MOE_LAYERS):
    """Phase 8 (a): qwen3-moe-30b-a3b at full width, cut to ``layers``
    layers, on its use_pallas path behind the ported ServingEngine, with
    weights drawn from a seeded generator on the device. Every prefill of
    every layer runs flash attention (G = 8, D = 128); the MoE block is
    torch ops, as the reference's is einsums outside any kernel. Returns
    the launch counts of the served run and the serving-shape rows."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.common import param_count_tree
    from repro_torch.models.transformer import build_model
    from repro_torch.serving import ServingConfig
    full = cfg.num_layers
    cfg = dataclasses.replace(cfg, num_layers=layers, use_pallas=True)
    model = build_model(cfg)
    t0 = time.monotonic()
    params = model.init(SEED, device=dev)
    n_params = param_count_tree(params)
    rng = np.random.default_rng(SEED + 4)
    toks = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in prompts]
    scfg = ServingConfig(capacity=capacity, max_len=max_len)
    e = cfg.moe
    print(f"  {cfg.name}: {layers} of {full} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv heads of "
          f"{cfg.head_dim_}, {e.num_experts} experts top-"
          f"{e.experts_per_token} of d_ff {e.d_ff}, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.3f} B parameters ({cfg.param_dtype}, "
          f"{n_params * 4 / 2 ** 30:.1f} GiB, drawn in "
          f"{time.monotonic() - t0:.1f} s), activations {cfg.dtype}; "
          f"ServingEngine(capacity={capacity}, max_len={max_len})",
          flush=True)
    serve(model, params, toks[-2:-1], scfg, 2)      # warm-up, not counted
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    for fam in kernels.FAMILIES:
        fam.reset_counts()
    reqs, decode_s, wall = serve(model, params, toks, scfg, new_tokens)
    counts = {k: v for fam in kernels.FAMILIES
              for k, v in fam.launches.items()}

    # -- checks ---------------------------------------------------------------
    check_served(cfg, dev, reqs, prompts, new_tokens, decode_s, wall)
    ops_model, firsts = moe_gates(cfg, dev, params, prompts, toks)
    served = [r.tokens[0] for r in reqs]
    print(f"  ServingEngine first tokens equal to the kernel path's own "
          f"prefill: {sum(a == b for a, b in zip(served, firsts))}/"
          f"{len(reqs)} [all] {'ok' if served == firsts else 'FAIL'}",
          flush=True)
    if served != firsts:
        raise AssertionError(f"the engine's first tokens {served} are not "
                             f"the model's own prefill's {firsts}")
    ops_reqs, _, _ = serve(ops_model, params, toks, scfg, new_tokens)
    # the same served comparison with f32 activations, where the layerwise
    # gate (a) flips no top-k set: the two paths' tokens part in f32 too,
    # as the whole-prefill logits do (printed by moe_gates)
    r32 = [serve(build_model(dataclasses.replace(
        cfg, dtype=torch.float32, use_pallas=pal)), params, toks, scfg,
        new_tokens)[0] for pal in (True, False)]
    same = [sum(a == b for r, o in zip(*pair)
                for a, b in zip(r.tokens, o.tokens))
            for pair in ((reqs, ops_reqs), r32)]
    print(f"  ServingEngine greedy tokens equal, kernel path vs torch-ops "
          f"path: bf16 {same[0]}/{len(reqs) * new_tokens}, f32 {same[1]}/"
          f"{len(reqs) * new_tokens} (printed, not gated)", flush=True)
    del r32
    # the model's own sensitivity: the f32 torch-ops path alone, its
    # embedding table moved by at most one f32 ulp
    m32 = build_model(dataclasses.replace(cfg, dtype=torch.float32,
                                          use_pallas=False))
    x = torch.as_tensor(toks[0][None], dtype=torch.long, device=dev)
    moved = {**params, "embed": params["embed"] * (1 + 2.0 ** -23)}
    print(f"  the f32 torch-ops path alone, its embedding table moved by "
          f"one ulp: a {prompts[0]}-token prefill's logits move by "
          f"{rel_err(m32.prefill(moved, x)[0], m32.prefill(params, x)[0]):.2e}"
          f" (printed, not gated)", flush=True)
    del moved
    with traced_as(moe_lib, "moe_block"):
        where_the_time_goes(model, params, cfg, dev, toks[0], capacity,
                            max_len, span="moe_block")
    if dev.type == "cuda":
        weight_cast_ms(params, cfg)
    print("  flash attention at the served lengths (plain form, as "
          "served):", flush=True)
    cases = flash_serve_cases(cfg, dev, sorted(set(prompts), reverse=True),
                              np.random.default_rng(SEED + 7),
                              label="flash_moe")
    rows = time_cases(cases, REPS, cfg.num_heads, plain_only=tuple(cases))

    print(f"  launches on the MoE model path: {json.dumps(counts)}")
    cuda_core_guard(counts, "MoE model path")
    need = layers * len(prompts)
    if counts["flash_plain"] != need:
        raise AssertionError(f"flash_plain launched {counts['flash_plain']} "
                             f"times on the MoE model path, not {need} (one "
                             "a layer of each prefill)")
    return counts, rows


def whisper_greedy(model, params, embeds, toks, steps):
    """``prefill`` of ``toks`` with the frame embeddings, then ``steps``
    greedy ``decode_step``s with the cross K/V in the cache (the
    reference's own API: its engine does not serve audio). Returns the
    greedy tokens (B, steps + 1) and the prefill's logits."""
    from repro_torch.models.transformer import pad_cache
    S = toks.shape[1]
    logits, cache = model.prefill(params, toks, encoder_embeds=embeds)
    first = logits
    cache = pad_cache(cache, S + steps)
    out = [logits[:, -1].argmax(dim=-1)]
    for i in range(steps):
        logits, cache = model.decode_step(params, out[-1][:, None], cache,
                                          S + i)
        out.append(logits[:, -1].argmax(dim=-1))
    return torch.stack(out, dim=1), first


def row_errs(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Relative L2 error of each row (the last axis: one token's vector)."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    return (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)


WHISPER_PARTS = ("encoder attention", "encoder MLP", "decoder attention",
                 "decoder MLP")


def whisper_sublayers(kern, ref, params, embeds, toks,
                      kern_ctx=contextlib.nullcontext,
                      ref_ctx=contextlib.nullcontext):
    """Every kernel-bearing sub-block of whisper, ``kern`` (inside
    ``kern_ctx()``) against ``ref`` (inside ``ref_ctx()``) from the same
    input: each encoder layer's self-attention (flash attention) and MLP
    (three matmuls), each decoder layer's self-attention and MLP, the MLP
    fed ``ref``'s attention output (the decoder's, after the
    cross-attention to ``ref``'s encoder output, which has no kernel).
    Each next layer starts from ``ref``'s output. Returns, for each of
    WHISPER_PARTS, the rows' relative errors (one row a token) over all
    layers."""
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import _layers
    errs = {k: [] for k in WHISPER_PARTS}
    h = embeds.to(ref.cfg.dtype)
    for lp in _layers(params["encoder"]["layers"], ref.cfg.encoder_layers):
        with kern_ctx():
            _, ak = kern._enc_attn(lp, h)
        with ref_ctx():
            x, ar = ref._enc_attn(lp, h)
        with kern_ctx():
            _, mk = kern._enc_mlp(lp, x)
        with ref_ctx():
            h, mr = ref._enc_mlp(lp, x)
        errs["encoder attention"].append(row_errs(ak, ar))
        errs["encoder MLP"].append(row_errs(mk, mr))
    enc = rms_norm(h, params["encoder"]["norm"], ref.cfg.rms_eps)
    h = ref.embed_tokens(params, toks)
    for lp in _layers(params["layers"]["p0"], ref.cfg.num_layers):
        with kern_ctx():
            _, ak, _ = kern._mixer(0, lp, h, enc_out=enc)
        with ref_ctx():
            x, ar, _ = ref._mixer(0, lp, h, enc_out=enc)
        with kern_ctx():
            _, mk, _ = kern._ffn(0, lp, x)
        with ref_ctx():
            h, mr, _ = ref._ffn(0, lp, x)
        errs["decoder attention"].append(row_errs(ak, ar))
        errs["decoder MLP"].append(row_errs(mk, mr))
    return {k: torch.cat(v) for k, v in errs.items()}


def rows_line(errs, tol):
    """Each part's median and largest row error; ok when every row of every
    part is within ``tol``."""
    ok = all(float(e.max()) <= tol for e in errs.values())
    text = ", ".join(f"{k} {e.median().item():.1e} (max {e.max().item():.1e})"
                     for k, e in errs.items())
    return text, ok


def whisper_phase(cfg, dev, batch=WHISPER_BATCH, prompt=WHISPER_PROMPT,
                  steps=WHISPER_STEPS):
    """Phase 8 (b): whisper-base whole on its use_pallas path, weights from
    a seeded generator on the device, random frame embeddings (``batch`` x
    frames x d_model) from a seed: the encoder (non-causal flash attention
    at S = T = frames, the SwiGLU matmuls at M = batch x frames), a
    ``prompt``-token decoder prefill and ``steps`` greedy decode steps.

    The random init makes this model chaotic: its attention scores have a
    standard deviation of some 64 (the init's fan-in of wq is its 8-head
    axis), each softmax is a hard argmax over up to 1500 keys, and a
    perturbation at the last bit moves the logits by O(1), in float64 as
    in bf16 (``rehearse_phase8``). So nothing is compared end to end:
    every kernel-bearing sub-block is held from the same input
    (``whisper_sublayers``), every row (one token) of every part gated:
    (a) in f32 against the torch-ops path (MODEL_TOL_F32), (b) in bf16
    against the torch-ops path (WHISPER_TOL), (c) in bf16 against the
    kernels' plain versions (PLAIN_TOL); and every logit finite, every
    token in the vocabulary.
    Printed: the encoder output, prefill logits and greedy tokens against
    the torch-ops path's. Returns the launch counts of the counted run and
    the kernel rows."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import kv_cache_specs
    from repro_torch.device import synchronize
    from repro_torch.models.common import param_count_tree
    from repro_torch.models.transformer import build_model
    cfg = dataclasses.replace(cfg, use_pallas=True)
    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    rng = np.random.default_rng(SEED + 6)
    F_, E = cfg.num_audio_frames, cfg.d_model
    embeds = torch.from_numpy(rng.standard_normal(
        (batch, F_, E), dtype=np.float32)).to(dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        size=(batch, prompt)), device=dev)
    print(f"  {cfg.name}: {cfg.encoder_layers} encoder + {cfg.num_layers} "
          f"decoder layers, d_model {E}, {cfg.num_heads} heads of "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
          f"{param_count_tree(params) / 1e6:.1f} M parameters "
          f"({cfg.param_dtype}), activations {cfg.dtype}; {batch} x {F_} "
          f"frames, a {prompt}-token prompt, {steps} decode steps",
          flush=True)
    whisper_greedy(model, params, embeds, toks, steps)   # warm-up
    for fam in kernels.FAMILIES:
        fam.reset_counts()
    synchronize(dev)
    t0 = time.monotonic()
    got, lk = whisper_greedy(model, params, embeds, toks, steps)
    synchronize(dev)
    wall = time.monotonic() - t0
    counts = {k: v for fam in kernels.FAMILIES
              for k, v in fam.launches.items()}
    print(f"  encode + prefill + {steps} greedy decode steps: "
          f"{wall * 1e3:.1f} ms (host clock); tokens {got.tolist()}",
          flush=True)

    # -- checks ---------------------------------------------------------------
    ops = build_model(dataclasses.replace(cfg, use_pallas=False))
    f32 = [build_model(dataclasses.replace(cfg, dtype=torch.float32,
                                           use_pallas=pal))
           for pal in (True, False)]
    lines, ok = [], (bool(torch.isfinite(lk).all())
                     and bool(((got >= 0) & (got < cfg.vocab_size)).all()))
    for label, (kern, ref), ctx, tol in (
            ("(a) f32 vs torch ops", f32, contextlib.nullcontext,
             MODEL_TOL_F32),
            ("(b) bf16 vs torch ops", (model, ops), contextlib.nullcontext,
             WHISPER_TOL),
            ("(c) bf16 vs plain versions", (model, model), plain_versions,
             PLAIN_TOL)):
        text, good = rows_line(whisper_sublayers(kern, ref, params, embeds,
                                                 toks, ref_ctx=ctx), tol)
        lines.append(f"{label} [every row <= {tol:g}]: {text} "
                     f"{'ok' if good else 'FAIL'}")
        ok = ok and good
    print("  sub-blocks from the same input, median row error (largest):",
          flush=True)
    for line in lines:
        print(f"    {line}", flush=True)
    want, lo = whisper_greedy(ops, params, embeds, toks, steps)
    print(f"  end to end against the torch-ops path (not gated: chaotic): "
          f"bf16 encoder output "
          f"{rel_err(model.encode(params, embeds), ops.encode(params, embeds)):.2e}"
          f", prefill logits {rel_err(lk, lo):.2e}, greedy tokens equal: "
          f"{torch.equal(got, want)} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("whisper: a sub-block on the kernel path "
                             "disagrees with the torch-ops path or the plain "
                             "versions, or the output is not finite")
    x = toks[:, -1:]
    cache = {k: torch.zeros(shape, dtype=dtype, device=dev) for k, (
        shape, dtype) in kv_cache_specs(cfg, batch, prompt + steps).items()}
    profile_once(f"encoder, {batch} x {F_} frames",
                 lambda: model.encode(params, embeds), dev)
    profile_once(f"decode step, {batch} sequences",
                 lambda: model.decode_step(params, x, cache, prompt), dev)
    print("  the kernels at the encoder's, the decoder prefill's and the "
          "decode step's shapes (plain form, as run):", flush=True)
    rng = np.random.default_rng(SEED + 9)
    cases = {**mm_serve_cases(cfg, dev, (batch * F_, batch * prompt, batch),
                              rng),
             **flash_serve_cases(cfg, dev, (F_,), rng, batch=batch,
                                 causal=False, label="flash_enc"),
             **flash_serve_cases(cfg, dev, (prompt,), rng, batch=batch,
                                 label="flash_dec")}
    rows = time_cases(cases, REPS, cfg.num_heads, plain_only=tuple(cases))

    print(f"  launches on the audio model path: {json.dumps(counts)}")
    cuda_core_guard(counts, "audio model path")
    L, EL = cfg.num_layers, cfg.encoder_layers
    need = {"flash_plain": EL + L,
            "matmul_plain": 3 * (EL + L + L * steps)}
    if {k: counts[k] for k in need} != need:
        raise AssertionError(f"the audio path's launches "
                             f"{ {k: counts[k] for k in need} } are not the "
                             f"encoder's, the prefill's and the decode "
                             f"steps' {need}")
    return counts, rows


def rehearse_phase8():
    """CPU rehearsal of phase 8's bf16 gates at full width, the kernels'
    roundings emulated (``emulated_tensor_cores``): (a) qwen3-moe-30b-a3b
    cut to 2 layers and a 1024-token vocabulary, each of PROMPTS'
    attention against the torch-ops path (gate b) and against the plain
    versions (gate c) and the flipped top-k share; (b) whisper-base
    whole: each kernel-bearing sub-block's row errors against the
    torch-ops path and the plain versions (``whisper_sublayers``), and how
    far a 1e-12 move of the frame embeddings carries in float64. Prints
    one line per case.

        python3 -c 'import chip_smoke as c; c.rehearse_phase8()'
    """
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import build_model
    dev = torch.device("cpu")
    layers, vocab, dtype = 2, 1024, torch.bfloat16
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                              num_layers=layers, vocab_size=vocab,
                              dtype=dtype)
    kern = build_model(dataclasses.replace(cfg, use_pallas=True))
    ops = build_model(cfg)
    params = kern.init(SEED, device=dev)
    rng = np.random.default_rng(SEED + 4)
    for n in PROMPTS:
        x = torch.as_tensor(rng.integers(0, vocab, size=(1, n)))
        eb = moe_layerwise(kern, ops, params, x, layers,
                           kern_ctx=emulated_tensor_cores)
        ec = moe_layerwise(kern, kern, params, x, layers,
                           kern_ctx=emulated_tensor_cores,
                           ref_ctx=plain_versions)
        print(f"qwen3-moe prefill {n} tokens ({dtype}): (b) attention vs "
              f"torch ops {eb[0]:.3e}, flipped sets {eb[1]:.2%}; (c) "
              f"attention vs plain versions {ec[0]:.3e}, flipped sets "
              f"{ec[1]:.2%}", flush=True)
    del params, kern, ops
    gc.collect()
    wcfg = dataclasses.replace(get_config("whisper-base"), dtype=dtype)
    kern = build_model(dataclasses.replace(wcfg, use_pallas=True))
    ops = build_model(wcfg)
    params = kern.init(SEED, device=dev)
    rng = np.random.default_rng(SEED + 6)
    embeds = torch.from_numpy(rng.standard_normal(
        (WHISPER_BATCH, wcfg.num_audio_frames, wcfg.d_model),
        dtype=np.float32))
    toks = torch.as_tensor(rng.integers(0, wcfg.vocab_size,
                                        size=(WHISPER_BATCH,
                                              WHISPER_PROMPT)))
    for label, ref, ctx, tol in (
            ("(b) vs torch ops", ops, contextlib.nullcontext, WHISPER_TOL),
            ("(c) vs plain versions", kern, plain_versions, PLAIN_TOL)):
        errs = whisper_sublayers(kern, ref, params, embeds, toks,
                                 kern_ctx=emulated_tensor_cores,
                                 ref_ctx=ctx)
        text = ", ".join(
            f"{k} median {e.median().item():.2e}, 99th percentile "
            f"{e.quantile(0.99).item():.2e}, max {e.max().item():.2e} "
            f"[<= {tol:g}]"
            for k, e in errs.items())
        print(f"whisper ({dtype}) {label}: {text}", flush=True)
    # the model's sensitivity: float64, the torch-ops path, the frame
    # embeddings moved by 1e-12
    m64 = build_model(dataclasses.replace(wcfg, dtype=torch.float64))
    from repro_torch.tree import tree_map
    p64 = tree_map(lambda a: a.double(), params)
    e64 = embeds.double()
    noise = torch.from_numpy(np.random.default_rng(SEED + 10)
                             .standard_normal(e64.shape)) * 1e-12
    l0, _ = m64.prefill(p64, toks, encoder_embeds=e64)
    l1, _ = m64.prefill(p64, toks, encoder_embeds=e64 + noise)
    enc = [m64.encode(p64, e) for e in (e64, e64 + noise)]
    print(f"whisper (float64): frame embeddings moved by 1e-12 move the "
          f"encoder output by {rel_err(enc[1], enc[0]):.2e} and the prefill "
          f"logits by {rel_err(l1, l0):.2e} (relative L2)", flush=True)


# ---------------------------------------------------------------------------
# Phase 9: deepseek-coder-33b whole in bf16 through the serving steps
# ---------------------------------------------------------------------------


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in ``tree`` (a step's arguments)."""
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def step_peak(fn, dev):
    """The peak device memory of one call of ``fn`` (what was resident
    before it included), or None off the card."""
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev)


def decode_cache_gate(prefill_cache, decoded, prompt: int) -> None:
    """The first decode step's cache against the prefill's: every k/v row
    below ``prompt`` passed through bit for bit, row ``prompt`` written
    (finite, not all zero), the rows after it still the padding's
    zeros."""
    for key in ("k", "v"):
        old, new = prefill_cache[key], decoded[key]
        kept = torch.equal(new[:, :, :prompt], old)
        row = new[:, :, prompt]
        written = bool(torch.isfinite(row).all()) and bool(
            (row != 0).any(dim=(-2, -1)).all())
        rest = not bool(new[:, :, prompt + 1:].any())
        print(f"  decode step 1, cache {key}: rows < {prompt} unchanged "
              f"{kept}, row {prompt} written in every layer and sequence "
              f"{written}, rows > {prompt} zero {rest} "
              f"{'ok' if kept and written and rest else 'FAIL'}", flush=True)
        if not (kept and written and rest):
            raise AssertionError(f"decode step: the {key} cache was not "
                                 "passed through and written at the index")


def decode_row_gate(written, expected, prompt: int) -> None:
    """Layer 0's k and v rows that the decode step wrote at ``prompt``
    (``written[key]``, (B, KV heads, D)) against the rows that a B = 1
    prefill of each prompt and its first token puts there
    (``expected[key]``): each sequence's relative L2 error within
    DECODE_ROW_TOL."""
    errs = {key: [rel_err(w, e) for w, e in zip(written[key],
                                                 expected[key])]
            for key in ("k", "v")}
    ok = max(max(e) for e in errs.values()) <= DECODE_ROW_TOL
    print(f"  decode step 1, layer 0's row {prompt} against each sequence's "
          f"B = 1 prefill of its prompt and first token, rel err k "
          f"{max(errs['k']):.2e}, v {max(errs['v']):.2e} "
          f"[<= {DECODE_ROW_TOL:g}] {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("decode step: layer 0's written k/v row is not "
                             "the prefill's row at that position")


def steps_phase(cfg, dev, batch=STEPS_BATCH, prompt=STEPS_PROMPT,
                capacity=STEPS_CAPACITY, steps=STEPS_NEW):
    """Phase 9: ``cfg`` whole on its use_pallas path through the serving
    steps on the one-card mesh (``make_host_mesh()``), weights drawn leaf
    by leaf in the model dtype (bf16; ``model.init(..., dtype=...)`` draws
    a narrow leaf slice by slice): ``make_prefill_step`` on ``batch``
    prompts of ``prompt`` tokens, the cache padded to ``capacity``, then
    ``steps`` greedy ``make_decode_step`` steps. Every prefill layer runs
    flash attention and the three SwiGLU matmuls, every decode step the
    three matmuls at M = ``batch``. The decode step's ``cache_index`` is
    a host scalar: the cache write slices at it (``int(index)``), which
    for a scalar on the card would wait for the card twice a layer.
    Gated: the shardings put every leaf whole on the card; the decode
    step's cache (``decode_cache_gate``) and layer 0's row it writes
    against a B = 1 prefill of the prompt and its first token
    (``decode_row_gate``); each first greedy token against the same
    path's own B = 1 prefill of that prompt; layer by layer from one
    input (``layerwise``), the bf16 kernels against their plain versions
    (PLAIN_LAYERS layers, PLAIN_TOL) and, with f32 activations on the same
    bf16 weights, the kernel path against the torch-ops path (every layer,
    MODEL_TOL_F32). Returns the launch counts of the prefill and decode
    steps, the kernel rows and what the phase measured for the dry run
    (phase 11): the bytes of the tensors passed to each step (``*_bytes``),
    each step's device-busy ms in its trace (``*_device_ms``), the peak
    device memory of one call of each (``*_peak``; the weights resident)
    and of the phase (``phase_peak``), None where not measured."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import ShapeConfig, kv_cache_specs
    from repro_torch.device import synchronize
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                          serving_param_shapes,
                                          serving_param_shardings)
    from repro_torch.models.common import param_count_tree
    from repro_torch.models.transformer import build_model, pad_cache
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(cfg, use_pallas=True)
    model = build_model(cfg)
    mesh = make_host_mesh(device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    params = model.init(SEED, device=dev, dtype=cfg.dtype)
    synchronize(dev)
    n_params = param_count_tree(params)
    drawn = time.monotonic() - t0
    peak = (f", peak device memory of the draw "
            f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB"
            if dev.type == "cuda" else "")
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv heads of "
          f"{cfg.head_dim_} (G = {cfg.q_per_kv}), d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; {n_params / 1e9:.3f} B parameters in "
          f"{cfg.dtype} ({n_params * 2 / 2 ** 30:.1f} GiB, drawn in "
          f"{drawn:.1f} s{peak}); mesh {mesh.axis_names} {mesh.shape}",
          flush=True)

    pre = make_prefill_step(model, mesh, ShapeConfig("prefill", prompt,
                                                     batch, "prefill"))
    dec = make_decode_step(model, mesh, ShapeConfig("decode", capacity,
                                                    batch, "decode"))
    shards = serving_param_shardings(model.param_axes(),
                                     serving_param_shapes(model), mesh)
    leaves = tree_leaves(params)
    whole = all(s.shard_shape(p.shape) == tuple(p.shape)
                for s, p in zip(tree_leaves(shards), leaves))
    layout = all((tuple(a.shape), a.dtype) == (tuple(p.shape), p.dtype)
                 for a, p in zip(tree_leaves(pre.abstract_inputs[0]), leaves))
    print(f"  serving_param_shardings on {mesh.shape}: every one of "
          f"{len(leaves)} leaves whole on the card {whole}; the weights "
          f"match the steps' abstract inputs {layout} "
          f"{'ok' if whole and layout else 'FAIL'}", flush=True)
    if not (whole and layout):
        raise AssertionError("the one-card mesh's shardings split a leaf, "
                             "or the weights are not the steps' inputs")

    rng = np.random.default_rng(SEED + 11)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        size=(batch, prompt)),
                           dtype=torch.int32, device=dev)
    pre.fn(params, {"tokens": toks})                 # warm-up, not counted
    synchronize(dev)

    for fam in kernels.FAMILIES:
        fam.reset_counts()
    t = time.monotonic()
    logits, cache = pre.fn(params, {"tokens": toks})
    synchronize(dev)
    prefill_s = time.monotonic() - t
    out = [logits[:, -1].argmax(dim=-1)]
    kv = pad_cache(cache, capacity)
    measured = {"prefill_bytes": tensor_bytes((params, {"tokens": toks}))}
    step_s, first = [], None
    for i in range(steps):
        t = time.monotonic()
        dbatch = {"tokens": out[-1][:, None].to(torch.int32), "cache": kv,
                  "cache_index": torch.tensor(prompt + i, dtype=torch.int32)}
        if i == 0:
            measured["decode_bytes"] = tensor_bytes((params, dbatch))
        logits_d, kv = dec.fn(params, dbatch)
        del dbatch
        out.append(logits_d[:, -1].argmax(dim=-1))
        synchronize(dev)
        step_s.append(time.monotonic() - t)
        first = kv if first is None else first
    counts = {k: v for fam in kernels.FAMILIES
              for k, v in fam.launches.items()}
    tokens = torch.stack(out, dim=1)
    print(f"  prefill step, {batch} x {prompt} tokens: "
          f"{prefill_s * 1e3:.1f} ms (host clock); {steps} decode steps: "
          f"{batch * steps / sum(step_s):.1f} tokens/s "
          f"({sum(step_s) / steps * 1e3:.2f} ms a step); greedy tokens "
          f"{tokens.tolist()}", flush=True)
    measured["phase_peak"] = None
    if dev.type == "cuda":
        measured["phase_peak"] = torch.cuda.max_memory_allocated(dev)
        print(f"  peak device memory {measured['phase_peak'] / 2 ** 30:.2f} "
              f"GiB", flush=True)

    # -- checks ---------------------------------------------------------------
    if not (torch.isfinite(logits).all() and torch.isfinite(logits_d).all()
            and ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError("serving steps: non-finite logits or a token "
                             "outside the vocabulary")
    decode_cache_gate(cache, first, prompt)
    written = {k: first[k][0, :, prompt].clone() for k in ("k", "v")}
    del first, kv
    one = make_prefill_step(model, mesh, ShapeConfig("prefill1", prompt, 1,
                                                     "prefill"))
    alone = [one.fn(params, {"tokens": toks[b:b + 1]})[0][0, -1]
             for b in range(batch)]
    firsts = [int(a.argmax()) for a in alone]
    diffs = [rel_err(logits[b, -1], a) for b, a in enumerate(alone)]
    same = firsts == out[0].tolist()
    print(f"  first greedy tokens {out[0].tolist()} of the {batch}-prompt "
          f"prefill step, each prompt's own B = 1 prefill step "
          f"{firsts}: equal {same} (last-token logits rel err "
          f"{max(diffs):.2e}) {'ok' if same else 'FAIL'}", flush=True)
    if not same:
        raise AssertionError("the batched prefill's first tokens are not "
                             "each prompt's own prefill's")
    del alone, cache, logits, logits_d
    ext = make_prefill_step(model, mesh, ShapeConfig(
        "prefill1+1", prompt + 1, 1, "prefill"))
    expected = {"k": [], "v": []}
    for b in range(batch):
        seq = torch.cat([toks[b:b + 1],
                         out[0][b:b + 1, None].to(torch.int32)], dim=1)
        c = ext.fn(params, {"tokens": seq})[1]
        for k in expected:
            expected[k].append(c[k][0, 0, prompt])
        del c
    decode_row_gate(written, expected, prompt)
    del written, expected
    x = toks[:1].long()
    t = time.monotonic()
    e16 = layerwise(model, model, params, x, PLAIN_LAYERS,
                    ref_ctx=plain_versions)
    f32 = [build_model(dataclasses.replace(cfg, dtype=torch.float32,
                                           use_pallas=pal))
           for pal in (True, False)]
    e32 = layerwise(*f32, params, x, cfg.num_layers)
    ok = max(e16) <= PLAIN_TOL and max(e32) <= MODEL_TOL_F32
    print(f"  layer by layer, one {prompt}-token prompt: bf16 kernels vs "
          f"plain versions, {PLAIN_LAYERS} layers: attention {e16[0]:.2e}, "
          f"MLP {e16[1]:.2e}, output {e16[2]:.2e} [<= {PLAIN_TOL:g}]; f32 "
          f"activations on the bf16 weights, kernels vs torch ops, "
          f"{cfg.num_layers} layers: attention {e32[0]:.2e}, MLP "
          f"{e32[1]:.2e}, output {e32[2]:.2e} [<= {MODEL_TOL_F32:g}] "
          f"{'ok' if ok else 'FAIL'}; {time.monotonic() - t:.1f} s",
          flush=True)
    if not ok:
        raise AssertionError("serving steps: a layer on the kernel path "
                             "disagrees with the plain versions or the "
                             "torch-ops path")

    batch_in = {"tokens": toks}
    measured["prefill_device_ms"] = profile_once(
        f"prefill step, {batch} x {prompt} tokens",
        lambda: pre.fn(params, batch_in), dev)
    measured["prefill_peak"] = step_peak(lambda: pre.fn(params, batch_in),
                                         dev)
    dkv = {k: torch.zeros(s, dtype=d, device=dev)
           for k, (s, d) in kv_cache_specs(cfg, batch, capacity).items()}
    dbatch = {"tokens": toks[:, :1], "cache": dkv,
              "cache_index": torch.tensor(prompt, dtype=torch.int32)}
    measured["decode_device_ms"] = profile_once(
        f"decode step, {batch} sequences, cache of {capacity}",
        lambda: dec.fn(params, dbatch), dev)
    measured["decode_peak"] = step_peak(lambda: dec.fn(params, dbatch), dev)
    del dkv, dbatch
    print("  the kernels at the steps' shapes (plain form, as run):",
          flush=True)
    rng = np.random.default_rng(SEED + 12)
    cases = {**mm_serve_cases(cfg, dev, (batch * prompt, batch), rng),
             **flash_serve_cases(cfg, dev, (prompt,), rng, batch=batch,
                                 label="flash_steps")}
    rows = time_cases(cases, REPS, cfg.num_heads, plain_only=tuple(cases))

    print(f"  launches on the serving steps: {json.dumps(counts)}")
    cuda_core_guard(counts, "serving steps")
    L = cfg.num_layers
    need = {"flash_plain": L, "matmul_plain": 3 * L * (1 + steps)}
    if {k: counts[k] for k in need} != need:
        raise AssertionError(f"the serving steps' launches "
                             f"{ {k: counts[k] for k in need} } are not one "
                             f"prefill's and {steps} decode steps' {need}")
    return counts, rows, measured


def compression_gate(grads, dev):
    """Two error-feedback steps of ``ef_compress_tree`` over a gradient
    tree (``grads``, on the CPU) on ``dev`` and on the CPU: ``q`` and
    ``scale`` bit for bit equal, and on ``dev`` the error-feedback
    identity decompress + new residual == grad + old residual, within the
    reference's tolerance (tests/test_compression.py). Prints the payload
    against the raw tree and the time of one step on the card."""
    from repro_torch.device import synchronize
    from repro_torch.distributed.compression import (Compressed,
                                                     decompress_tree,
                                                     ef_compress_tree,
                                                     init_residuals,
                                                     payload_bytes)
    from repro_torch.tree import tree_leaves, tree_map

    def two_steps(g):
        r0 = init_residuals(g)
        c1, r1 = ef_compress_tree(g, r0)
        c2, r2 = ef_compress_tree(g, r1)
        return c1, c2, r1, r2

    def comp(tree):
        return tree_leaves(tree, is_leaf=lambda t: isinstance(t, Compressed))

    g = tree_map(lambda t: t.to(dev), grads)
    on_dev, on_cpu = two_steps(g), two_steps(grads)
    equal = all(torch.equal(a.q.cpu(), b.q) and torch.equal(a.scale.cpu(),
                                                            b.scale)
                for i in (0, 1) for a, b in zip(comp(on_dev[i]),
                                                comp(on_cpu[i])))
    c2, r1, r2 = on_dev[1], on_dev[2], on_dev[3]
    excess = max(((d + n) - (x + o)).abs().sub(
        EF_TOL["rtol"] * (x + o).abs()).max().item()
        for d, n, x, o in zip(tree_leaves(decompress_tree(c2)),
                              tree_leaves(r2), tree_leaves(g),
                              tree_leaves(r1)))
    ok = equal and excess <= EF_TOL["atol"]
    raw, sent = payload_bytes(g), payload_bytes(on_dev[0])
    n = sum(t.numel() for t in tree_leaves(g))
    ms = (cuda_ms(lambda: ef_compress_tree(g, r1), REPS)
          if dev.type == "cuda" else None)
    synchronize(dev)
    print(f"  gradient compression over {len(tree_leaves(g))} leaves "
          f"({n / 1e6:.1f} M values) on {dev}: q and scale equal to the "
          f"CPU's bit for bit in both steps {equal}; decompress + new "
          f"residual - (grad + old residual): max(|diff| - rtol|ref|) "
          f"{excess:.2e} [<= atol {EF_TOL['atol']:g}, rtol "
          f"{EF_TOL['rtol']:g}] {'ok' if ok else 'FAIL'}; payload "
          f"{sent / 1e6:.2f} MB against {raw / 1e6:.2f} MB raw "
          f"({raw / sent:.2f}x smaller)"
          + ("" if ms is None else f"; one step {ms:.3f} ms"), flush=True)
    if not ok:
        raise AssertionError("gradient compression: the card's q/scale "
                             "differ from the CPU's or the error-feedback "
                             "identity fails")


# ---------------------------------------------------------------------------
# Phase 10: the co-location example at full width, observed by the hub
# ---------------------------------------------------------------------------


def registry_samples(reg):
    """Every sample of ``reg``'s counters, gauges and histograms read from
    its own cells, keyed as ``parse_prometheus_text`` keys them."""
    out = {}
    for fam in reg.families():
        for values, child in fam.items():
            labels = tuple(zip(fam.labelnames, values))
            if fam.kind in ("counter", "gauge"):
                out[(fam.name, labels)] = child.v
            elif fam.kind == "histogram":
                for le, cum in child.bucket_pairs():
                    s = "+Inf" if le == math.inf else repr(float(le))
                    out[(f"{fam.name}_bucket", labels + (("le", s),))] = cum
                out[(f"{fam.name}_sum", labels)] = child.sum
                out[(f"{fam.name}_count", labels)] = child.count
    return out


def hub_gates(label, hub, eng, admissions, be_quanta):
    """The registry is the engine's account: requests, latency histogram
    (count, and its sum bit for bit the retire-order sum of the latencies),
    TTFT count against the admissions, sheds, retries, BE quanta against
    the engine's and the trainer's, hedges spawned at least won + lost;
    the exposition reproduces every sample and survives a JSONL round trip
    byte for byte (the Prometheus text less the families that have no
    child); the histogram's p50 and p99 lie in the bucket of the
    nearest-rank percentile (the sample at rank ceil(q n), which
    ``Histogram.quantile``'s target q n lands on). Raises on any failure;
    returns the exposition text."""
    import bisect

    from repro_torch.core.metrics import LatencyStats
    from repro_torch.obs import (parse_prometheus_text, prometheus_text,
                                 registry_from_jsonl, to_jsonl)
    reg = hub.registry
    text = prometheus_text(reg)
    _, samples = parse_prometheus_text(text)
    lat = reg.get("tally_serving_request_latency_seconds").child()
    ttft = reg.get("tally_serving_ttft_seconds").child()
    lat_sum = 0.0
    for r in eng.done:
        lat_sum += r.latency
    sheds = sum(c.v for _, c in reg.get("tally_serving_sheds_total").items())
    hedges = {k[0]: c.v
              for k, c in reg.get("tally_serving_hedges_total").items()}
    checks = {
        "requests": (samples[("tally_serving_requests_total", ())],
                     len(eng.done)),
        "latency count": (lat.count, len(eng.done)),
        "latency sum": (lat.sum, lat_sum),
        "ttft count": (ttft.count, admissions),
        "sheds": (sheds, len(eng.shed_requests)),
        "retries": (samples[("tally_serving_retries_total", ())],
                    sum(r.attempt for r in eng.done + eng.shed_requests)),
        "be quanta": (samples[("tally_serving_be_quanta_total", ())],
                      eng.be_quanta, be_quanta),
    }
    bad = {k: v for k, v in checks.items() if len(set(v)) != 1}
    if hedges.get("spawned", 0.0) < hedges.get("won", 0.0) + hedges.get(
            "lost", 0.0):
        bad["hedges"] = hedges
    if samples != registry_samples(reg):
        bad["parse_prometheus_text"] = "samples differ from the registry"
    # JSONL has a line per child, so a family without one (the simulator's
    # families, a counter that never fired) comes back without its
    # # HELP / # TYPE lines, in either package; every other line is exact
    empty = {f.name for f in reg.families() if not len(f)}
    kept = "".join(ln + "\n" for ln in text.splitlines()
                   if not (ln.startswith("#") and ln.split()[2] in empty))
    back = registry_from_jsonl(to_jsonl(reg))
    if prometheus_text(back) != kept or to_jsonl(back) != to_jsonl(reg):
        bad["jsonl round trip"] = "text differs"
    stats = LatencyStats()
    for r in eng.done:
        stats.record(r.latency)
    xs = sorted(stats.latencies)
    quant = []
    for q, exact in ((0.5, stats.p50()), (0.99, stats.p99())):
        if not xs:
            break
        est = lat.quantile(q)
        # the bucket that ``Histogram.observe`` puts that sample in, as a
        # closed range (past the last bound: from it to +inf)
        i = bisect.bisect_left(lat.les, xs[math.ceil(q * len(xs)) - 1])
        lo = lat.les[i - 1] if i else 0.0
        hi = lat.les[i] if i < len(lat.les) else math.inf
        quant.append(f"p{q * 100:g} {est * 1e3:.1f} ms in [{lo:g}, {hi:g}] s"
                     f" (LatencyStats {exact * 1e3:.1f} ms)")
        if not lo <= est <= hi:
            bad[f"p{q * 100:g} bucket"] = (est, lo, hi)
    print(f"  ({label}) registry against the engine: "
          + ", ".join(f"{k} {v[0]:g}" for k, v in checks.items())
          + f", hedges {hedges}; {'; '.join(quant)}; exposition and JSONL "
          f"round trips {'ok' if not bad else 'FAIL ' + repr(bad)}",
          flush=True)
    if bad:
        raise AssertionError(f"phase 10 ({label}): the registry is not the "
                             f"engine's account: {bad}")
    return text


def colocated_obs_phase(cfg, mcfg, dev, max_len=1024, be_batch=TRAIN_BATCH,
                        be_seq=TRAIN_SEQ, timeout_floor=OBS_TIMEOUT_FLOOR):
    """Phase 10, the co-location example's scenario at full width: ``cfg``
    on its use_pallas path behind ``ServingEngine(4, max_len)``,
    driven by ``serve``'s own loop (``launch.serve.drive``: the MAF2-like
    arrivals, the prompt draw, the outage) and observed by the port's
    ``ObsHub``, beside a ``BestEffortTrainer`` of ``mcfg`` (torch ops)
    taking one step in each idle quantum. Runs: (a) alone, (b) co-located,
    (c) co-located with ``obs=None``, (d) chaos, (e) chaos with failover.
    Returns the launch counts of (b) and the small-shape kernel rows."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.core.metrics import LatencyStats
    from repro_torch.device import synchronize
    from repro_torch.launch.serve import (BestEffortTrainer, drive,
                                          failover_policies)
    from repro_torch.models.common import param_count_tree
    from repro_torch.models.transformer import build_model
    from repro_torch.obs import ObsHub
    from repro_torch.serving import ServingConfig, ServingEngine
    requests, new_tokens, capacity = OBS_REQUESTS, OBS_NEW_TOKENS, 4
    t0 = time.monotonic()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(dataclasses.replace(cfg, use_pallas=True))
    params = model.init(SEED, device=dev)
    trainer = BestEffortTrainer(
        build_model(dataclasses.replace(mcfg, use_pallas=False)),
        batch=be_batch, seq=be_seq, seed=SEED, device=dev)
    synchronize(dev)                    # the draws are asynchronous
    print(f"  {cfg.name}: {cfg.num_layers} layers, "
          f"{param_count_tree(params) / 1e9:.3f} B parameters "
          f"({cfg.param_dtype}), ServingEngine(capacity={capacity}, "
          f"max_len={max_len}); BE {mcfg.name} trainer "
          f"{param_count_tree(trainer.params) / 1e6:.1f} M parameters, "
          f"B={be_batch}, S={be_seq} (torch ops); set up in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    quantum_s = []

    def be_quantum():
        t = time.monotonic()
        trainer()
        synchronize(dev)
        quantum_s.append(time.monotonic() - t)

    def run(hub, colocated, timeout=None, chaos=False, failover=False,
            stall_s=0.0):
        retry = hedge = brownout = None
        if failover:
            retry, hedge, brownout = failover_policies(timeout, capacity)
        eng = ServingEngine(
            model, params, ServingConfig(capacity, max_len,
                                         request_timeout=timeout),
            best_effort_hook=be_quantum if colocated else None, obs=hub,
            retry=retry, hedge=hedge, brownout=brownout)
        n = {"prefills": 0, "decodes": 0}
        prefill, decode = eng._prefill, eng._decode

        def counted(key, fn):
            def call(*a):
                n[key] += 1
                return fn(*a)
            return call

        eng._prefill = counted("prefills", prefill)
        eng._decode = counted("decodes", decode)
        q0, s0 = trainer.quanta, len(quantum_s)
        synchronize(dev)
        wall = drive(eng, cfg.vocab_size, requests=requests,
                     max_new_tokens=new_tokens, seed=SEED, chaos=chaos,
                     stall_s=stall_s)
        synchronize(dev)
        return dict(eng=eng, hub=hub, wall=wall, quanta=trainer.quanta - q0,
                    quantum_s=quantum_s[s0:], **n)

    # warm-up, not counted: a bare engine and one train step
    serve(model, params, [np.arange(4, dtype=np.int32)] * 2,
          ServingConfig(capacity, max_len), 2)
    be_quantum()
    quantum_s.clear()

    runs = {"a": run(ObsHub(), False)}
    for fam in kernels.FAMILIES:
        fam.reset_counts()
    runs["b"] = run(ObsHub(), True)
    counts = {k: v for fam in kernels.FAMILIES
              for k, v in fam.launches.items()}
    runs["c"] = run(None, True)
    alone = LatencyStats()
    for r in runs["a"]["eng"].done:
        alone.record(r.latency)
    timeout = max(timeout_floor, 2.0 * alone.p99())
    stall_s = 1.5 * timeout
    runs["d"] = run(ObsHub(), True, timeout, chaos=True, stall_s=stall_s)
    runs["e"] = run(ObsHub(), True, timeout, chaos=True, failover=True,
                    stall_s=stall_s)

    # -- gates ----------------------------------------------------------------
    def answers(key):
        done = sorted(runs[key]["eng"].done, key=lambda r: r.rid)
        return [r.tokens for r in done]

    toks = {k: answers(k) for k in "abc"}
    ok_tok = (toks["a"] == toks["b"] == toks["c"]
              and len(toks["a"]) == requests
              and all(len(t) == new_tokens and all(
                  0 <= x < cfg.vocab_size for x in t) for t in toks["a"]))
    print(f"  (a)/(b)/(c) HP tokens equal request by request (rid order): "
          f"{sum(a == b == c for a, b, c in zip(*toks.values()))}/{requests}"
          f" {'ok' if ok_tok else 'FAIL'}", flush=True)
    if not ok_tok:
        raise AssertionError("phase 10: the hub or the BE job changed the "
                             "HP answers")
    texts = {k: hub_gates(k, runs[k]["hub"], runs[k]["eng"],
                          runs[k]["prefills"], runs[k]["quanta"])
             for k in "abde"}
    for k in "abcde":
        r = runs[k]
        eng = r["eng"]
        print(f"  ({k}) {len(eng.done)} answered, {len(eng.shed_requests)} "
              f"shed, {sum(q.attempt for q in eng.done + eng.shed_requests)}"
              f" retries, {r['prefills']} prefills, {r['decodes']} decode "
              f"steps, {r['quanta']} BE quanta, wall {r['wall']:.3f} s",
              flush=True)
    if not runs["b"]["quanta"] > 0:
        raise AssertionError("phase 10 (b): the BE trainer took no quantum")
    for k in "ab":
        done = runs[k]["eng"].done
        ttft = [r.ttft for r in done]
        lat = [r.latency for r in done]
        print(f"  HP ({k}) {'alone' if k == 'a' else 'co-located'}: TTFT "
              f"p50 {pct(ttft, 50):.1f} ms, p99 {pct(ttft, 99):.1f} ms; "
              f"latency p50 {pct(lat, 50):.1f} ms, p99 {pct(lat, 99):.1f} ms",
              flush=True)
    bq = runs["b"]["quantum_s"]
    coloc = LatencyStats()
    for r in runs["b"]["eng"].done:
        coloc.record(r.latency)
    hub_ms = (runs["b"]["wall"] - runs["c"]["wall"]) * 1e3
    print(f"  LatencyStats(b).overhead_vs(p99 of (a)) = "
          f"{coloc.overhead_vs(alone.p99()):+.4f} (the paper's headline "
          f"ratio from one run of {requests} requests, host noise; a "
          f"latency runs from the submit, and the driver submits an arrival "
          f"only after the quantum in progress, so the wait behind a BE "
          f"quantum is not in it: a reading, not a claim); (b)'s BE quanta "
          f"{[round(q * 1e3, 1) for q in bq]} ms, longest "
          f"{max(bq, default=0.0) * 1e3:.1f} ms; the hub's overhead, (b) - "
          f"(c) wall: {hub_ms:+.1f} ms (a reading, not a gate)", flush=True)
    print("  (b) as the example prints it:")
    for ln in texts["b"].splitlines():
        if ln.startswith("tally_serving") and (
                "_count" in ln or "_total" in ln or "slots" in ln):
            print(f"    {ln}")
    d, e = runs["d"]["eng"], runs["e"]["eng"]
    e_retries = sum(r.attempt for r in e.done + e.shed_requests)
    ok_chaos = (len(d.shed_requests) >= 1 and not e.shed_requests
                and len(e.done) == requests and e_retries >= 1)
    print(f"  chaos, request budget {timeout:.3f} s (max({timeout_floor:g}, "
          f"2 p99 of (a))), outage {stall_s:.3f} s: (d) {len(d.shed_requests)}"
          f" shed [>= 1]; (e) {len(e.shed_requests)} shed [== 0], "
          f"{len(e.done)}/{requests} answered, {e_retries} retries [>= 1] "
          f"{'ok' if ok_chaos else 'FAIL'}", flush=True)
    if not ok_chaos:
        raise AssertionError("phase 10: the outage did not shed without "
                             "failover, or failover did not recover")
    if dev.type == "cuda":
        print(f"  peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")

    print("  the kernels at the prompt lengths of the example (plain form, "
          "as served):", flush=True)
    rng = np.random.default_rng(SEED + 6)
    cases = {**mm_serve_cases(cfg, dev, OBS_PROMPTS, rng),
             **flash_serve_cases(cfg, dev, OBS_PROMPTS, rng,
                                 label="flash_obs")}
    rows = time_cases(cases, REPS, cfg.num_heads, plain_only=tuple(cases))

    print(f"  launches on the observed co-located path (b): "
          f"{json.dumps(counts)}")
    print(f"  phase 10 in {time.monotonic() - t0:.1f} s", flush=True)
    cuda_core_guard(counts, "observed co-located path")
    L, b = cfg.num_layers, runs["b"]
    need = {"flash_plain": L * b["prefills"],
            "matmul_plain": 3 * L * (b["prefills"] + b["decodes"])}
    short = {k: (counts[k], v) for k, v in need.items() if counts[k] < v}
    if short:
        raise AssertionError(f"entry points launched fewer times than the "
                             f"observed co-located path needs (launched, "
                             f"needed): {short}")
    return counts, rows


# ---------------------------------------------------------------------------
# Phase 11: the dry run, checked against what phase 9 measured
# ---------------------------------------------------------------------------


def dryrun_phase(cfg, measured, card, dev, batch=STEPS_BATCH,
                 prompt=STEPS_PROMPT, capacity=STEPS_CAPACITY,
                 cells=DRYRUN_CELLS):
    """Phase 11, ``repro_torch.launch.dryrun`` (a cost model on meta
    tensors: no kernel launches, no device memory). (a) ``cells`` on both
    production meshes, with every cell that ``shape_applicable`` skips:
    each status ``ok`` or ``skip`` exactly where it says so, one line a
    cell; then a (16, 16) mesh re-meshed by the elastic plan after one
    lost host of 64, priced. (b) ``cfg`` on the one-card mesh of phase 9,
    the prefill step of ``batch`` x ``prompt`` and the decode step at
    ``capacity``, bf16 serving weights: the predicted argument bytes equal
    the bytes that phase 9 passed (``measured``), exactly; ``fits_hbm``
    true for both and false for a train step with f32 masters; the
    predicted compute and memory terms and peak against phase 9's device
    ms and peaks, each beside ``card``. Returns the cells of (b)."""
    from repro_torch.configs import (SHAPES, ShapeConfig, all_arch_names,
                                     get_config, shape_applicable)
    from repro_torch.distributed.fault_tolerance import plan_elastic_remesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.monotonic()
    skips = [(a, n) for a in all_arch_names() for n, sh in SHAPES.items()
             if not shape_applicable(get_config(a), sh)[0]]
    bad = []
    for arch, name in list(cells) + skips:
        for multi in (False, True):
            cell = dryrun.run_cell(arch, name, multi)
            want = ("ok" if shape_applicable(get_config(arch),
                                             SHAPES[name])[0] else "skip")
            print(f"  {arch} x {name} x {cell['mesh']}: "
                  f"{dryrun.cell_line(cell)}", flush=True)
            if cell["status"] != want:
                bad.append((arch, name, cell["mesh"], cell["status"]))
    plan = plan_elastic_remesh((16, 16), ("data", "model"), list(range(64)),
                               [3], devices_per_host=4, global_batch=256)
    cell = dryrun.remesh_cell("qwen2.5-14b", "train_4k", plan)
    print(f"  qwen2.5-14b x train_4k re-meshed to {plan.new_mesh_shape}, "
          f"batch {plan.new_global_batch}: {dryrun.cell_line(cell)}",
          flush=True)
    if cell["status"] != "ok":
        bad.append(("qwen2.5-14b", "train_4k", "remesh", cell["status"]))
    print(f"  {2 * (len(cells) + len(skips)) + 1} cells in "
          f"{time.monotonic() - t0:.1f} s (host clock)", flush=True)
    if bad:
        raise AssertionError(f"dry-run cells whose status is not "
                             f"shape_applicable's: {bad}")

    mesh = make_host_mesh(device=dev)
    shapes = {"prefill": ShapeConfig("prefill", prompt, batch, "prefill"),
              "decode": ShapeConfig("decode", capacity, batch, "decode"),
              "train": ShapeConfig("train", prompt, batch, "train")}
    got = {k: dryrun.price(cfg, sh, mesh) for k, sh in shapes.items()}
    ok = True
    for k in ("prefill", "decode"):
        c = got[k]
        args, passed = c["memory"]["argument_size_in_bytes"], measured[
            f"{k}_bytes"]
        r = c["roofline"]
        bound = max(r["compute_s"], r["memory_s"]) * 1e3
        dev_ms = measured[f"{k}_device_ms"]
        share = (f"{bound / dev_ms:.1%} of the measured {dev_ms:.3f} ms"
                 if dev_ms else "device ms not measured")
        mem = c["memory"]
        eager = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                 + mem["output_size_in_bytes"])
        peak = measured[f"{k}_peak"]
        peak_s = (f"measured {peak / 2 ** 30:.2f} GiB (the phase's "
                  f"{measured['phase_peak'] / 2 ** 30:.2f})" if peak
                  else "peak not measured")
        print(f"  {cfg.name} {k} step on {mesh.shape}, {card}: arguments "
              f"predicted {args} B, passed {passed} B, equal "
              f"{args == passed}; compute {r['compute_s'] * 1e3:.3f} ms, "
              f"memory {r['memory_s'] * 1e3:.3f} ms ({r['dominant']}): the "
              f"bound {bound:.3f} ms is {share}; peak predicted "
              f"{c['per_device_hbm_bytes'] / 2 ** 30:.2f} GiB (temporaries "
              f"{mem['temp_size_in_bytes'] / 2 ** 30:.2f}; without the "
              f"donated inputs' reuse, which eager torch does not do, "
              f"{eager / 2 ** 30:.2f}), {peak_s}; fits {c['fits_hbm']}",
              flush=True)
        ok &= args == passed and c["fits_hbm"]
    t = got["train"]
    print(f"  {cfg.name} train step (f32 masters, AdamW) on {mesh.shape}: "
          f"{t['per_device_hbm_bytes'] / 2 ** 30:.1f} GiB predicted, "
          f"arguments {t['memory']['argument_size_in_bytes'] / 2 ** 30:.1f} "
          f"GiB; fits {t['fits_hbm']}", flush=True)
    ok &= not t["fits_hbm"]
    if not ok:
        raise AssertionError("the dry run's one-card cells: the predicted "
                             "arguments are not what the steps were passed, "
                             "or fits_hbm is wrong")
    return got


# ---------------------------------------------------------------------------
# Phase 12: the train step sharded over a mesh of processes
# ---------------------------------------------------------------------------


def run_tree(cmd, timeout_s: float, env=None):
    """``cmd`` in a session of its own, killed with every process it
    started once ``timeout_s`` passes; (exit code, stdout, stderr)."""
    import signal
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=str(ROOT), start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        return -9, out, err + f"\nkilled after {timeout_s:.0f} s"
    return proc.returncode, out, err


def sharded_phase(arch, dev, reduced=False, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                  steps=SHARDED_STEPS, lr=SHARDED_LR, timeout_s=600.0):
    """Phase 12: ``python -m repro_torch.launch.train --nproc 2`` on the
    (2, 1) and (1, 2) meshes, every rank on ``dev`` (``cuda:0`` on the
    card), against ``train()`` in this process from the same seed with as
    many microbatches as the mesh has data shards (the rows each rank
    computes; on the CPU the two are equal bit for bit). Gates: the
    losses equal on the ranks and within SHARDED_LOSS_TOL of that run at
    every step; the bytes each rank holds of the parameters, optimizer
    state and batch equal the dry run's argument bytes for the mesh;
    every shard on the device. Returns the per-mesh readings."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import train
    t0 = time.monotonic()
    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    one = {}
    for n in (1, 2):
        one[n] = train(arch, steps=steps, batch=batch, seq=seq,
                       reduced=reduced, lr=lr, log_every=steps,
                       num_microbatches=n, device=dev)
        print(f"  one process on {one[n]['device']}, {n} microbatch(es): "
              f"losses {[round(x, 5) for x in one[n]['losses']]}, step "
              f"host ms {[round(x, 1) for x in one[n]['step_ms']]}",
              flush=True)
    where = f"{dev.type}:0" if dev.type == "cuda" else "cpu"
    print(f"  the ranks run on {where}: two processes of one gloo group "
          f"share the {'one card' if dev.type == 'cuda' else 'CPU'} (NCCL "
          "refuses two ranks on one device; gloo carries all_reduce on CUDA "
          "tensors, the one collective of the sharded step, "
          "`chip_smoke.py --gloo-probe`)", flush=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = {}
    for mp in (2, 1):
        mesh = Mesh(("data", "model"), (2 // mp, mp), dev.type)
        want = dryrun.price(cfg, ShapeConfig("driver", seq, batch, "train"),
                            mesh)["memory"]["argument_size_in_bytes"]
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               arch, "--steps", str(steps), "--batch", str(batch), "--seq",
               str(seq), "--lr", str(lr), "--nproc", "2",
               "--model-parallel", str(mp),
               "--device", dev.type, "--timeout", str(timeout_s)]
        code, stdout, stderr = run_tree(cmd + ([] if reduced else ["--full"]),
                                        timeout_s + 60, env)
        if code != 0:
            raise AssertionError(f"phase 12 {mesh.shape}: the ranks exited "
                                 f"{code}:\n{stderr[-4000:]}")
        ranks = json.loads(stdout.strip().splitlines()[-1])
        got = ranks[0]["losses"]
        diff, plain = (max(abs(a - b) for a, b in zip(got, one[n]["losses"]))
                       for n in (mesh.shape[0], 1))
        ok = (all(r["losses"] == got for r in ranks)
              and len(got) == steps and diff <= SHARDED_LOSS_TOL
              and all(r["argument_bytes"] == want for r in ranks)
              and all(r["devices"] == [where] for r in ranks)
              and sorted(r["rank"] for r in ranks) == [0, 1]
              and all(r["mesh"] == list(mesh.shape) for r in ranks))
        med = [float(np.median(r["step_ms"][1:])) for r in ranks]
        comm = [float(np.median(r["comm_ms"][1:])) for r in ranks]
        print(f"  {mesh.shape} over ('data', 'model'), ranks on "
              f"{[r['devices'] for r in ranks]}: losses "
              f"{[round(x, 5) for x in got]}, largest difference from one "
              f"process with {mesh.shape[0]} microbatch(es) {diff:.3e} [<= "
              f"{SHARDED_LOSS_TOL:g}] (from one microbatch {plain:.3e}); "
              f"bytes per rank {[r['argument_bytes'] for r in ranks]}, dry "
              f"run {want}; median step host ms per rank (steps 1..) "
              f"{[round(x, 1) for x in med]}, of which all-reduces "
              f"{[round(x, 1) for x in comm]} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError(f"phase 12 {mesh.shape}: the sharded run "
                                 "disagrees with one process, with the dry "
                                 "run's bytes or with its device")
        out[mesh.shape] = dict(losses=got, diff=diff, plain=plain,
                               step_ms=med, comm_ms=comm, bytes=want)
    print(f"  phase 12 in {time.monotonic() - t0:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 13: the serving steps sharded over a mesh of processes
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recorded_launch_shapes():
    """Within the block, the shapes of every kernel descriptor the model's
    ``kernels.ops`` calls build: {"matmul": {(M, K, N)}, "flash": {(BH, S,
    T, D, G)}, "ssd": {(B, S, NH, HD, DS)}}."""
    from repro_torch.kernels import ops
    seen = {"matmul": set(), "flash": set(), "ssd": set()}
    names = {"matmul": "matmul_desc", "flash": "flash_attention_desc",
             "ssd": "mamba2_scan_desc"}
    orig = {k: getattr(ops, n) for k, n in names.items()}

    def recorder(key):
        def desc(*args, **kw):
            seen[key].add(tuple(a for a in args[:5] if isinstance(a, int)))
            return orig[key](*args, **kw)
        return desc
    for k, n in names.items():
        setattr(ops, n, recorder(k))
    try:
        yield seen
    finally:
        for k, n in names.items():
            setattr(ops, n, orig[k])


def launch_shapes_gate(cfg, shapes, rows: int, model_size: int,
                       index: int = 0) -> bool:
    """Every launch at rank ``index``'s shard shapes on a model axis of
    ``model_size``, over the rank's ``rows``: flash attention on its query
    heads (the even split where the axis divides the heads, else its
    block of GSPMD's padded kv groups, G each; none on a rank left
    without), the SSD scan on its SSD heads likewise, the MLP's matmuls
    at N or K = its hidden columns (its even split of d_ff or, where the
    weights are whole, its ``mlp_columns``) or, where they are split on
    their embed dim, at d_ff and d_model / model_size; the moe family's
    blocks launch no matmul (torch ops, as the reference's einsums), the
    hybrid family's layers each of the three. A rank with heads or
    columns must launch their kernels."""
    from repro_torch.models.layers import mlp_columns
    def part(n):
        per = -(-n // model_size)
        return max(0, min(per, n - index * per))
    ssd = not shapes["ssd"]
    if cfg.family in ("ssm", "hybrid"):
        # a head wider than the kernel's 64 columns launches as several
        # (``kernels.ops.mamba2_scan``): the rank's channels count
        nh, hd = part(cfg.ssm.num_heads(cfg.d_model)), cfg.ssm.head_dim
        ssd = (bool(shapes["ssd"]) == bool(nh)
               and all(b == rows and h * d == nh * hd
                       for b, _, h, d, _ in shapes["ssd"]))
    if cfg.family == "ssm":
        return ssd and not shapes["matmul"]
    H, KVH, E, F = cfg.num_heads, cfg.num_kv_heads, cfg.d_model, cfg.d_ff
    G = H // KVH
    hq = part(H) if H % model_size == 0 else part(KVH) * G
    if cfg.family == "moe":
        f, mlp = 0, True
    elif F % model_size and E % model_size == 0:    # the embed fallback
        f = F
        mlp = all({k, n} == {E // model_size, F}
                  for _, k, n in shapes["matmul"])
    else:               # split, or whole and sliced (``mlp_columns``)
        lo, hi = mlp_columns(F, model_size, index)
        f = F // model_size if F % model_size == 0 else hi - lo
        mlp = all(n == f or k == f for _, k, n in shapes["matmul"])
    return (ssd and bool(shapes["matmul"]) == bool(f) and mlp
            and bool(shapes["flash"]) == bool(hq)
            and all(bh == rows * hq and g == G
                    for bh, _, _, _, g in shapes["flash"]))


def traced(fn, dev, top=4):
    """``fn()`` once, its host seconds ending in a synchronize, traced on
    the card (the trace started before the clock and stopped after it):
    (its result, the seconds, the device events' summed ms, the kernels
    and gloo's copies between card and host (``kernel_rows``), and the
    ``top`` events by time as [name, ms, count]); ms None and no events
    off the card or where the trace saw none."""
    from repro_torch.device import synchronize
    prof = None
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    try:
        synchronize(dev)
        t = time.monotonic()
        out = fn()
        synchronize(dev)
        seconds = time.monotonic() - t
    finally:
        if prof is not None:
            prof.stop()
    if prof is None:
        return out, seconds, None, []
    rows = kernel_rows(prof)
    ms = sum(r[0] for r in rows)
    return out, seconds, (ms or None), [[k[:60], round(t, 3), n]
                                        for t, n, k in rows[:top]]


def plain_layers(cfg):
    """The layers phase 13 also runs through the kernels' plain versions:
    the first PLAIN_LAYERS, and the first attention layer where a hybrid
    stack has none among them."""
    at = set(range(min(PLAIN_LAYERS, cfg.num_layers)))
    attn = [i for i in range(cfg.num_layers) if cfg.is_attention_layer(i)]
    if cfg.family == "hybrid" and attn and not at & set(attn):
        at.add(attn[0])
    return at


def stack_layer(model, params, i: int):
    """Layer ``i`` of the stack: (its period position, its parameters)."""
    from repro_torch.models.transformer import _layer
    p = i % model.period
    return p, _layer(params["layers"][f"p{p}"], i // model.period)


def serving_layers(model, params, x, d, prompt, capacity, ctx_pre=None,
                   ctx_dec=None, relay=None, enc=None):
    """Each layer from one input, prefill then decode (``_sublayer``):
    yields (i, its period position, layer parameters, the prefill's
    ``_sublayer`` outputs, the decode's, the decode's cache entry) with
    ``x(i)`` and ``d(i)`` the layer's inputs. The prefill's k/v (with a
    leading layer dim) are
    padded to ``capacity`` through ``relay`` (``pad_cache`` by default; a
    sharded cache's reshard) for the decode token at ``prompt``; the
    audio family's prefill attends to the encoder output ``enc`` and its
    decode to the cross K/V that the prefill wrote."""
    from repro_torch.models.transformer import pad_cache
    pre = ctx_pre or contextlib.nullcontext
    dec = ctx_dec or contextlib.nullcontext
    relay = relay or (lambda t, n: pad_cache({"k": t}, n)["k"])
    for i in range(model.cfg.num_layers):
        p, lp = stack_layer(model, params, i)
        with pre():
            out = model._sublayer(p, lp, x(i), collect_cache=True,
                                  enc_out=enc)
        new = out[3]
        if "k" in new:
            entry = tuple(relay(new[k][None], capacity)[0]
                          for k in ("k", "v"))
        else:
            entry = (new["conv_state"], new["ssm_state"])
        cross = ((new["cross_k"], new["cross_v"]) if "cross_k" in new
                 else None)
        with dec():
            dout = model._sublayer(p, lp, d(i), cache=entry,
                                   cache_index=prompt, cross=cross)
        yield i, p, lp, out, dout, entry


def moe_record(model, p, lp, mid, m):
    """A MoE layer's FFN input ``mid`` (the mixer's residual sum), its
    MoE block's output ``m`` and the router's top-k sets on ``mid``
    (sorted), on the CPU; None for a layer without experts."""
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.moe import choose
    if model.ffn_kind[p] != "moe":
        return None
    cfg = model.cfg
    sets = choose(lp["ffn"], rms_norm(mid, lp["ln2"], cfg.rms_eps),
                  cfg)[2].sort(dim=-1).values
    return {"mid": mid.cpu(), "m": m.cpu(), "sets": sets.cpu()}


def encoder_layer(model, lp, x):
    """One encoder layer of the audio family on its parameters ``lp``:
    non-causal self-attention, then the MLP, each with its residual."""
    x, _ = model._enc_attn(lp, x)
    return model._enc_mlp(lp, x)[0]


def sharded_serving_reference(cfg, dev, batch, prompt, capacity, steps,
                              lw_rows, path, drawn_from=None, seed=SEED):
    """Phase 13's one process: ``cfg`` (drawn as the ranks draw it: as
    ``drawn_from``, the whole model, draws its first ``cfg.num_layers``
    layers, where given) through the serving steps on the (1, 1) mesh,
    on the run's traffic; and
    the layer chain the ranks hold theirs against, saved to ``path``: the
    first ``lw_rows`` prompts' embedding, each layer's prefill output and
    cache entries, the decode token's input and each layer's decode output
    and written cache (the k/v row at ``prompt``, or the ssm states); for
    a MoE layer also its input to the FFN, the MoE block's output and
    the router's top-k sets, of the prefill and the decode (``moe`` and
    ``dmoe``: None for the other layers); for
    the audio family first the frames, each encoder layer's output and
    the encoder's (normed) output. Returns the readings and the tokens."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.device import synchronize
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.layers import rms_norm
    from repro_torch.launch.steps import serving_param_shapes
    from repro_torch.models.transformer import _layers, build_model, pad_cache
    from repro_torch.tree import tree_map
    model = build_model(cfg)
    mesh = Mesh(("data", "model"), (1, 1), dev.type)
    t0 = time.monotonic()
    params = build_model(drawn_from or cfg).init(
        seed, device=dev, dtype=cfg.dtype, parts=tree_map(
            lambda t: tuple(slice(0, n) for n in t.shape),
            serving_param_shapes(model)))
    synchronize(dev)
    drawn = time.monotonic() - t0
    inputs = sharded_serving_batch(cfg, batch, prompt, dev)
    toks = inputs["tokens"]
    pre = make_prefill_step(model, mesh, ShapeConfig("prefill", prompt,
                                                     batch, "prefill"))
    dec = make_decode_step(model, mesh, ShapeConfig("decode", capacity,
                                                    batch, "decode"))
    pre.fn(params, inputs)                            # warm-up
    synchronize(dev)
    t = time.monotonic()
    logits, cache = pre.fn(params, inputs)
    synchronize(dev)
    prefill_s = time.monotonic() - t
    first = logits[:, -1].float()
    out = [logits[:, -1].argmax(dim=-1)]
    kv = pad_cache(cache, capacity)
    del cache
    t = time.monotonic()
    for i in range(steps):
        logits, kv = dec.fn(params, {
            "tokens": out[-1][:, None].to(torch.int32), "cache": kv,
            "cache_index": torch.tensor(prompt + i, dtype=torch.int32)})
        out.append(logits[:, -1].argmax(dim=-1))
    synchronize(dev)
    decode_s = time.monotonic() - t
    del kv, logits
    x0 = model.embed_tokens(params, toks[:lw_rows].long())
    d0 = model.embed_tokens(params, out[0][:lw_rows, None].long())
    chain = {"x0": x0.cpu(), "d0": d0.cpu(), "y": [], "new": [], "dy": [],
             "dnew": [], "moe": [], "dmoe": []}
    enc = None
    if cfg.encoder_layers:
        h = inputs["encoder_embeds"][:lw_rows]
        chain.update(frames=h.cpu(), enc=[])
        for lp in _layers(params["encoder"]["layers"], cfg.encoder_layers):
            h = encoder_layer(model, lp, h)
            chain["enc"].append(h.cpu())
        enc = rms_norm(h, params["encoder"]["norm"], cfg.rms_eps)
        chain["enc_out"] = enc.cpu()
    xs, ds = [x0], [d0]
    for i, p, lp, pre_out, dec_out, _ in serving_layers(
            model, params, lambda i: xs[i], lambda i: ds[i], prompt,
            capacity, enc=enc):
        y, new, dy, dnew = pre_out[0], pre_out[3], dec_out[0], dec_out[3]
        for key, inp, sub in (("moe", xs[i], pre_out),
                              ("dmoe", ds[i], dec_out)):
            chain[key].append(moe_record(model, p, lp, inp + sub[1], sub[2]))
        xs.append(y)
        ds.append(dy)
        chain["y"].append(y.cpu())
        chain["new"].append({k: v.cpu() for k, v in new.items()})
        chain["dy"].append(dy.cpu())
        chain["dnew"].append({k: (v[:, prompt] if k in ("k", "v") else v)
                              .cpu() for k, v in dnew.items()})
        xs[i] = ds[i] = None
    torch.save(chain, path)
    del params, xs, ds, chain
    return {"first_logits": first.cpu(), "tokens": torch.stack(
                out, dim=1).cpu(), "prefill_ms": prefill_s * 1e3,
            "tokens_per_s": batch * steps / decode_s, "drawn_s": drawn}


def sharded_serving_batch(cfg, batch, prompt, dev):
    """Phase 13's prefill batch from seeds: the prompts' tokens and, for
    the audio family, ``batch`` x frames x d_model frame embeddings."""
    rng = np.random.default_rng(SEED + 13)
    out = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, size=(batch, prompt)), dtype=torch.int32,
        device=dev)}
    if cfg.encoder_layers:
        out["encoder_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.num_audio_frames, cfg.d_model), dtype=np.float32)
        ).to(dev, cfg.dtype)
    return out


def sharded_run_config(arch, reduced, widths=(), layers=0):
    """Phase 13's config of ``arch`` (reduced for the CPU rehearsal), on
    the use_pallas path, with ``widths`` where given (a ``dtype`` by its
    torch name; ``moe.d_ff`` the experts' hidden width), and the same cut
    to ``layers`` (0: every layer)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    top = {k: getattr(torch, v) if k == "dtype" else v for k, v in widths
           if not k.startswith("moe.")}
    moe = {k[4:]: v for k, v in widths if k.startswith("moe.")}
    if moe:
        top["moe"] = dataclasses.replace(cfg.moe, **moe)
    cfg = dataclasses.replace(cfg, use_pallas=True, **top)
    return cfg, dataclasses.replace(cfg, num_layers=layers or cfg.num_layers)


def sharded_serving_rank(job_path: str) -> int:
    """``chip_smoke.py --sharded-serving-rank JOB``: one rank of phase 13
    (its process group from ``run_ranks``'s environment). Draws its
    shards, holds each layer from one input against the one-process
    chain in the job's file (the audio family's encoder layers first),
    then drives the sharded prefill, traced, and decode steps (launch
    counts zeroed just before, read just after); prints its readings as
    one JSON line."""
    from repro_torch import kernels
    from repro_torch.configs import ShapeConfig, kv_cache_specs
    from repro_torch.device import synchronize
    from repro_torch.distributed.sharding import (LOCAL, NamedSharding,
                                                  PartitionSpec, ShardGroup,
                                                  entry_axes)
    from repro_torch.launch.mesh import Mesh, init_from_env
    from repro_torch.launch.steps import (cache_layout, decode_cache,
                                          init_serving_shards,
                                          make_decode_step, make_prefill_step,
                                          reshard_cache_leaf, serving_axes,
                                          use_serving_axes)
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.moe import choose
    from repro_torch.models.transformer import _layers, build_model
    from repro_torch.tree import tree_leaves, tree_map
    with open(job_path) as f:
        job = json.load(f)
    world = init_from_env(job["timeout_s"])
    # the ranks share the host's cores (gloo's latency grows with a
    # crowded host)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drawn_from, cfg = sharded_run_config(job["arch"], job["reduced"],
                                         job["widths"], job["layers"])
    mesh = Mesh(("data", "model"), tuple(job["mesh"]), job["device"])
    group = ShardGroup(mesh)
    dev = group.device
    if dev.type == "cuda":
        kernels.build_all()
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    B, S, T, steps = job["batch"], job["prompt"], job["capacity"], job["steps"]
    model = build_model(cfg)
    pre = make_prefill_step(model, mesh, ShapeConfig("prefill", S, B,
                                                     "prefill"), group)
    dec = make_decode_step(model, mesh, ShapeConfig("decode", T, B,
                                                    "decode"), group)
    t = time.monotonic()
    # the shards of the whole model's first layers (a cut run's)
    params = init_serving_shards(build_model(drawn_from), pre, group,
                                 job["seed"])
    synchronize(dev)
    init_s = time.monotonic() - t
    t_chain = time.monotonic()
    local = tree_leaves(params)

    def nbytes_of(tree):
        return sum(t.to_local().numel() * t.to_local().element_size()
                   for t in tree_leaves(tree))
    shard_bytes = nbytes_of(params)
    # the decode step never reads the encoder's weights (and the dry run,
    # as jax.jit, drops an unread input)
    decode_shards = shard_bytes - nbytes_of(params.get("encoder", {}))
    b_sh = pre.in_shardings[1]
    batch = group.layout(sharded_serving_batch(cfg, B, S, dev), b_sh)
    nbytes = {"prefill": shard_bytes + nbytes_of(batch)}

    # -- each layer from one input, against the one-process chain ----------
    chain = torch.load(job["chain"], map_location=dev)
    lw = chain["x0"].shape[0]
    data = entry_axes(b_sh["tokens"].spec[0])
    rows = group.slices(NamedSharding(mesh, PartitionSpec(data or None)),
                        (lw,))[0]
    size = mesh.sizes["model"]
    # (ModelAxis, ExpertAxis) of the prefill and the decode step, the
    # rank's rows at their places in the chain's
    axes = [serving_axes(cfg, group, cache_layout(sh), (rows.start, lw))
            for sh in (pre.out_shardings[1], dec.in_shardings[1]["cache"])]
    pre_specs = kv_cache_specs(cfg, lw, S)
    dec_specs = kv_cache_specs(cfg, lw, T)

    def part(key, specs, sh):
        """This rank's slice of one layer's cache entry ``key``."""
        return group.slices(sh[key], specs[key][0])[1:]

    def relay(t, capacity):
        """The prefill's k or v in the decode step's layout (the reshard
        that ``decode_cache`` runs between the steps)."""
        return reshard_cache_leaf(t, pre.out_shardings[1]["k"],
                                  dec.in_shardings[1]["cache"]["k"],
                                  axes[0][0] or LOCAL, capacity)

    errs = {"prefill": 0.0, "prefill_cache": 0.0, "decode": 0.0,
            "decode_cache": 0.0}
    if cfg.moe is not None:
        errs.update(moe=0.0, moe_decode=0.0)
    worst_at = {}             # the layer of each largest error
    plain_errs = {}           # mixer, mlp (where a layer has one), ...
    # the router fed one process's FFN input: its top-k sets equal one
    # process's; fed the rank's own, the share of tokens whose set flips
    routing = {"sets_equal": True, "flipped": 0, "tokens": 0}

    def held(key, err, layer):
        if err >= errs.get(key, 0.0):
            errs[key], worst_at[key] = err, layer
    def against_plain(p, lp, x, d, pre_out, dec_out, entry):
        """The layer's errors against the same layer with the kernels'
        plain versions (phase 9's gate (c)) on the same shards, inside the
        same axes, from the same inputs; the MLP from the kernel path's
        mixer output, as phase 8 (b) holds whisper's (its
        cross-attention would carry the attention kernel's roundings into
        the MLP's input, amplified). A MoE layer's mixers alone: its
        block is torch ops on both paths, and a near-tie flips on the
        mixer's rounding (phase 8 (a))."""
        cross = ((pre_out[3]["cross_k"], pre_out[3]["cross_v"])
                 if enc is not None else None)
        if model.ffn_kind[p] == "moe":
            with use_serving_axes(axes[0]), plain_versions():
                p_h = model._mixer(p, lp, x, enc_out=enc)[1]
            with use_serving_axes(axes[1]), plain_versions():
                p_dh = model._mixer(p, lp, d, cache=entry, cache_index=S,
                                    cross=cross)[1]
            return {"mixer": rel_err(pre_out[1], p_h),
                    "decode_mixer": rel_err(dec_out[1], p_dh)}
        with use_serving_axes(axes[0]):
            mid = model._mixer(p, lp, x, enc_out=enc)[0]
        with use_serving_axes(axes[0]), plain_versions():
            p_out = model._sublayer(p, lp, x, collect_cache=True,
                                    enc_out=enc)
            p_mlp = model._ffn(p, lp, mid)[1]
        with use_serving_axes(axes[1]), plain_versions():
            p_dout = model._sublayer(p, lp, d, cache=entry, cache_index=S,
                                     cross=cross)
        errs = {"mixer": rel_err(pre_out[1], p_out[1])}
        if p_mlp is not None:
            errs["mlp"] = rel_err(pre_out[2], p_mlp)
        errs["prefill"] = rel_err(pre_out[0], p_out[0])
        errs["decode"] = rel_err(dec_out[0], p_dout[0])
        return errs

    passed_through = True
    lparams = tree_map(lambda t: t.to_local(), params)
    enc = None
    if cfg.encoder_layers:    # each encoder layer from one input
        errs["encoder"] = 0.0
        h = chain["frames"][rows]
        for j, lp in enumerate(_layers(lparams["encoder"]["layers"],
                                       cfg.encoder_layers)):
            with use_serving_axes(axes[0]):
                y = encoder_layer(model, lp, h)
            if j < PLAIN_LAYERS:
                with use_serving_axes(axes[0]), plain_versions():
                    plain_errs["encoder"] = max(plain_errs.get(
                        "encoder", 0.0), rel_err(y, encoder_layer(
                            model, lp, h)))
            h = chain["enc"][j][rows]
            held("encoder", rel_err(y, h), j)
        enc = chain["enc_out"][rows]
    xs = {0: chain["x0"][rows]}
    ds = {0: chain["d0"][rows]}
    for i, p, lp, pre_out, dec_out, entry in serving_layers(
            model, lparams, lambda i: xs[i], lambda i: ds[i], S, T,
            lambda: use_serving_axes(axes[0]),
            lambda: use_serving_axes(axes[1]), relay, enc):
        y, new, dy, dnew = pre_out[0], pre_out[3], dec_out[0], dec_out[3]
        experts = model.ffn_kind[p] == "moe"
        if i in plain_layers(cfg):
            for k, err in against_plain(p, lp, xs[i], ds[i], pre_out,
                                        dec_out, entry).items():
                plain_errs[k] = max(plain_errs.get(k, 0.0), err)
        if experts:
            # the mixer half against one process's FFN input; the MoE
            # block fed that input against one process's block
            for key, inp, out, rec, ctx in (
                    ("prefill", xs[i], pre_out, chain["moe"][i], axes[0]),
                    ("decode", ds[i], dec_out, chain["dmoe"][i], axes[1])):
                mid, want = inp + out[1], rec["mid"][rows]
                held(key, rel_err(mid, want), i)
                with use_serving_axes(ctx):
                    m = model._ffn(p, lp, want)[1]
                    sets = [choose(lp["ffn"], rms_norm(
                        z, lp["ln2"], cfg.rms_eps), cfg)[2].sort(dim=-1)
                        .values for z in (want, mid)]
                held("moe" if key == "prefill" else "moe_decode",
                     rel_err(m, rec["m"][rows]), i)
                one = rec["sets"][rows]
                routing["sets_equal"] &= torch.equal(sets[0], one)
                routing["flipped"] += int((sets[1] != one).any(-1).sum())
                routing["tokens"] += one[..., 0].numel()
        else:
            held("prefill", rel_err(y, chain["y"][i][rows]), i)
            held("decode", rel_err(dy, chain["dy"][i][rows]), i)
        for k, v in new.items():
            want = chain["new"][i][k][part(k, pre_specs, pre.out_shardings[1])]
            held("prefill_cache", rel_err(v, want), i)
        for k, v in dnew.items():
            if k in ("k", "v"):
                sl = part(k, dec_specs, dec.in_shardings[1]["cache"])
                owner = sl[1].start <= S < sl[1].stop
                old = entry[("k", "v").index(k)]
                if owner:
                    at = S - sl[1].start
                    held("decode_cache", rel_err(
                        v[:, at], chain["dnew"][i][k][sl[0], sl[2]]), i)
                    keep = torch.cat([v[:, :at], v[:, at + 1:]], dim=1)
                    kept = torch.cat([old[:, :at], old[:, at + 1:]], dim=1)
                else:
                    keep, kept = v, old
                passed_through &= torch.equal(keep, kept)
            else:
                want = chain["dnew"][i][k][part(k, dec_specs,
                                                dec.in_shardings[1]["cache"])]
                held("decode_cache", rel_err(v, want), i)
        xs[i + 1], ds[i + 1] = chain["y"][i][rows], chain["dy"][i][rows]
        del xs[i], ds[i]
    del chain, xs, ds, enc
    chain_s = time.monotonic() - t_chain

    # -- the main path: the sharded steps, counted -------------------------
    for fam in kernels.FAMILIES:
        fam.reset_counts()
    comm0, a2a0 = group.comm_s, (group.a2a_s, group.a2a_bytes)
    with recorded_launch_shapes() as shapes:
        (logits, cache), prefill_s, device_ms, device_top = traced(
            lambda: pre.sharded_fn(params, batch), dev)
        prefill_comm = group.comm_s - comm0
        a2a = {"prefill_ms": (group.a2a_s - a2a0[0]) * 1e3,
               "prefill_bytes": group.a2a_bytes - a2a0[1]}
        first = group.gather(logits, pre.out_shardings[0])[:, -1].float()
        out = [first.argmax(dim=-1)]
        kv = decode_cache(cache, pre, dec, group)
        del cache
        d_sh = dec.in_shardings[1]
        comm0, step_s = group.comm_s, []
        for i in range(steps):
            t = time.monotonic()
            db = group.layout(
                {"tokens": out[-1][:, None].to(torch.int32)},
                {"tokens": d_sh["tokens"]})
            db.update(cache=kv, cache_index=torch.tensor(
                S + i, dtype=torch.int32))
            if i == 0:
                nbytes["decode"] = decode_shards + nbytes_of(
                    (db["tokens"], kv)) + 4 * ("k" in kv)
                a2a0 = (group.a2a_s, group.a2a_bytes)
            logits, kv = dec.sharded_fn(params, db)
            if i == 0:
                a2a["decode_bytes"] = group.a2a_bytes - a2a0[1]
            out.append(group.gather(logits, dec.out_shardings[0])[:, -1]
                       .argmax(dim=-1))
            synchronize(dev)
            step_s.append(time.monotonic() - t)
        decode_comm = group.comm_s - comm0
        a2a["decode_ms"] = (group.a2a_s - a2a0[0]) * 1e3
    launches = {k: v for fam in kernels.FAMILIES
                for k, v in fam.launches.items()}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    del kv, logits
    torch.save({"first_logits": first.cpu()},
               f"{job['out']}.{group.rank}.pt")
    print(json.dumps({
        "rank": group.rank, "mesh": list(mesh.shape), "coords": group.coords,
        "devices": sorted({str(p.to_local().device) for p in local}),
        "init_s": init_s, "chain_s": chain_s, "decode_s": sum(step_s),
        "shard_bytes": shard_bytes, "bytes": nbytes,
        "peak": peak, "errs": errs, "plain_errs": plain_errs,
        "worst_at": worst_at, "routing": routing, "a2a": a2a,
        "passed_through": passed_through,
        "shapes_ok": launch_shapes_gate(cfg, shapes, len(range(
            *group.slices(NamedSharding(mesh, PartitionSpec(data or None)),
                          (B,))[0].indices(B))), size,
            group.coords["model"]),
        "shapes": {k: sorted(v) for k, v in shapes.items()},
        "prefill_ms": prefill_s * 1e3, "prefill_comm_ms": prefill_comm * 1e3,
        "prefill_device_ms": device_ms, "prefill_device_top": device_top,
        "tokens_per_s": B * steps / sum(step_s),
        "decode_comm_ms": decode_comm * 1e3,
        "tokens": torch.stack(out, dim=1).tolist(), "launches": launches}))
    torch.distributed.destroy_process_group()
    return 0


# the kernel families a family's serving steps launch: the moe family's
# blocks are torch ops (the reference's einsums), its attention flash
PATH_KERNELS = {"ssm": ("ssd_plain",), "moe": ("flash_plain",),
                "hybrid": ("matmul_plain", "flash_plain", "ssd_plain"),
                "dense": ("matmul_plain", "flash_plain"),
                "vlm": ("matmul_plain", "flash_plain"),
                "audio": ("matmul_plain", "flash_plain")}


def sharded_serving_phase(dev, waves=SHARDED_SERVING, reduced=False,
                          timeout_s=600.0):
    """Phase 13: the serving steps' ``sharded_fn`` for each run of
    ``waves`` (``ShardedRun``: an arch on its meshes and traffic), one
    gloo group of ranks a mesh, all on ``dev`` (``cuda:0`` on the card),
    on the use_pallas path, against one process running the same steps
    on the same weights (``sharded_serving_reference``, run here first
    and freed). A wave's references run one by one, then the ranks of
    all its meshes at once. Gates, for every rank: each layer from one
    input (the audio family's encoder layers too), prefill and decode
    outputs and cache (the k/v at the rank's positions, the row the
    decode token writes, the cross K/V, the ssm states) within PLAIN_TOL
    of one process, the rest of the cache passed through; for a MoE
    layer the mixer half (the FFN's input) so, and the MoE block fed one
    process's FFN input within PLAIN_TOL of one process's with the same
    top-k sets (fed the rank's own, the flipped share is printed, not
    gated: near-ties flip on the mixer's rounding, as in phase 8 (a));
    the ``plain_layers`` (the first PLAIN_LAYERS and a hybrid stack's
    first attention layer): mixer, MLP and outputs through the kernels
    within PLAIN_TOL of the same layers through their plain versions, on
    the same shards inside the same axes, from the same inputs (a MoE
    layer's mixers only); argument bytes equal ``dryrun.price``'s for the
    mesh, and the bytes sent into a step's all-to-alls its
    ``moe_all_to_all`` term; peak memory
    below the step's arguments (the shards, the batch and the cache: the
    dry run's argument bytes) plus the largest leaf in f32 (a draw holds
    at most that) plus the dry run's temporaries and outputs, and below
    the whole model where the weights outweigh those; every launch at
    the rank's shard shapes, a rank left without heads launching no
    flash or SSD kernel; every kernel family of the path launched on
    some rank. Printed: host and device ms of a prefill per rank, the
    collectives' share (the all-to-alls' apart), decode tokens/s, the
    first logits and greedy
    tokens beside one process, each wave's seconds. Returns the ranks'
    summed launch counts; raises at the end if a kernel of a path
    launched no time (as on the CPU, where the plain versions launch
    nothing)."""
    import concurrent.futures as cf
    import tempfile
    from repro_torch.launch.mesh import run_ranks
    t0 = time.monotonic()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    total, missed = {}, {}
    with tempfile.TemporaryDirectory(prefix="phase13-") as tmp:
        for w, wave in enumerate(waves):
            t_wave = time.monotonic()
            jobs = [job for k, run in enumerate(wave) for job in
                    sharded_serving_jobs(run, dev, reduced, timeout_s,
                                         os.path.join(tmp, f"{w}_{k}"))]
            with cf.ThreadPoolExecutor(len(jobs)) as ex:
                done = list(ex.map(lambda j: run_ranks(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--sharded-serving-rank", j["path"]],
                    math.prod(j["shape"]), timeout_s, env=env,
                    cwd=str(ROOT)), jobs))
            for job, ranks in zip(jobs, done):
                launches = sharded_serving_held(job, ranks)
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
                cfg, shape = job["cfg"], job["shape"]
                need = PATH_KERNELS[cfg.family]
                if cfg.dtype == torch.float32:      # a probe's f32 run
                    need = tuple(k.replace("_plain", "_fma_plain")
                                 for k in need)
                else:
                    cuda_core_guard(launches, f"sharded serving {shape}")
                print(f"  launches on {shape}, all {len(ranks)} ranks: "
                      f"{ {k: launches[k] for k in need} }", flush=True)
                missed.update({f"{cfg.name} {shape} {k}": launches[k]
                               for k in need if not launches[k]})
            names = ", ".join(f"{j['cfg'].name} {j['shape']}" for j in jobs)
            print(f"  wave {w} ({names}) in {time.monotonic() - t_wave:.1f}"
                  " s", flush=True)
    print(f"  phase 13 in {time.monotonic() - t0:.1f} s", flush=True)
    if missed:
        raise AssertionError(f"phase 13: the sharded steps' launches miss a "
                             f"kernel of the path: {missed}")
    return total


def sharded_serving_jobs(run, dev, reduced, timeout_s, prefix):
    """One ``ShardedRun``'s one process (``sharded_serving_reference``,
    its chain saved at ``prefix``, the card freed after) and a rank job
    for each of its meshes: the job file at ``prefix`` and what the
    ranks are held to (the dry run's bytes, the peak's bound)."""
    import dataclasses
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import (serving_param_shapes,
                                          serving_param_shardings)
    from repro_torch.models.transformer import build_model
    from repro_torch.tree import tree_leaves
    batch, prompt, capacity, steps = run.traffic
    drawn_from, cfg = sharded_run_config(run.arch, reduced, run.widths,
                                         run.layers)
    where = f"{dev.type}:0" if dev.type == "cuda" else "cpu"
    chain = f"{prefix}.chain.pt"
    one = sharded_serving_reference(cfg, dev, batch, prompt, capacity,
                                    steps, max(m[0] for m in run.meshes),
                                    chain, drawn_from, run.seed)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shapes = serving_param_shapes(build_model(cfg))
    leaves = tree_leaves(shapes)
    whole = sum(t.numel() * t.element_size() for t in leaves)
    largest = max(t.numel() * t.element_size() for t in leaves)
    # a leaf is drawn in f32 (at most the whole leaf at once)
    draw = max(t.numel() * 4 for t in leaves)
    print(f"  {cfg.name}: {cfg.num_layers} layers"
          + (f" (+ {cfg.encoder_layers} encoder)"
             if cfg.encoder_layers else "")
          + f", d_model {cfg.d_model}, {whole / 2 ** 30:.2f} GiB of "
          f"{cfg.dtype} weights (largest leaf {largest / 2 ** 30:.2f} GiB);"
          f" one process on {where}: drawn in {one['drawn_s']:.1f} s, a "
          f"{batch} x {prompt} prefill {one['prefill_ms']:.1f} ms (host "
          f"clock), {steps} decode steps {one['tokens_per_s']:.1f} tokens/s;"
          f" greedy tokens {one['tokens'].tolist()}", flush=True)
    jobs = []
    for shape in run.meshes:
        mesh = Mesh(("data", "model"), shape, dev.type)
        priced = {k: dryrun.price(
            dataclasses.replace(cfg, use_pallas=False),
            ShapeConfig(k, n, batch, k), mesh)
                  for k, n in (("prefill", prompt), ("decode", capacity))}
        want = {k: v["memory"]["argument_size_in_bytes"]
                for k, v in priced.items()}
        # the bytes a rank sends into a step's all-to-alls (0 where the
        # experts stay whole or the model has none)
        want_a2a = {k: v["collective_terms"].get("moe_all_to_all", {})
                    .get("bytes", 0) for k, v in priced.items()}
        temps = max(v["memory"]["temp_size_in_bytes"]
                    + v["memory"]["output_size_in_bytes"]
                    for v in priced.values())
        shs = tree_leaves(serving_param_shardings(
            build_model(cfg).param_axes(), shapes, mesh))
        shard = sum(math.prod(s.shard_shape(t.shape)) * t.element_size()
                    for t, s in zip(leaves, shs))
        path = f"{prefix}.{shape[0]}x{shape[1]}"
        with open(f"{path}.json", "w") as f:
            json.dump({"arch": run.arch, "reduced": reduced,
                       "widths": list(run.widths), "layers": run.layers,
                       "seed": run.seed,
                       "mesh": list(shape), "device": dev.type,
                       "batch": batch, "prompt": prompt,
                       "capacity": capacity, "steps": steps,
                       "chain": chain, "timeout_s": timeout_s,
                       "out": f"{path}.logits"}, f)
        jobs.append({"cfg": cfg, "shape": shape, "path": f"{path}.json",
                     "out": f"{path}.logits", "one": one, "want": want,
                     "want_a2a": want_a2a,
                     "shard": shard, "whole": whole, "where": where,
                     # the step's arguments (the weights' shards, the batch
                     # and, in decode, the cache), a leaf's draw, and its
                     # temporaries and outputs
                     "bound": max(want.values()) + draw + temps,
                     # below the whole model where the weights outweigh
                     # what a step and a draw hold beside them (not so
                     # for mamba2-130m)
                     "whole_gate": shape[1] > 1 and whole > 2 * (draw
                                                                 + temps)})
    return jobs


def sharded_serving_held(job, done):
    """One mesh's ranks (``run_ranks``'s results) held to their gates and
    printed, a line a rank; raises if a rank failed or a gate. Returns
    the ranks' summed launch counts."""
    cfg, shape, one = job["cfg"], job["shape"], job["one"]
    want, shard, bound = job["want"], job["shard"], job["bound"]
    whole, whole_gate, where = job["whole"], job["whole_gate"], job["where"]
    for r, (code, _, err) in enumerate(done):
        if code != 0:
            raise AssertionError(f"phase 13 {cfg.name} {shape}: rank {r} "
                                 f"exited {code}:\n{err[-6000:]}")
    ranks = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in done]
    steps = len(one["tokens"][0]) - 1
    logit_err = max(rel_err(torch.load(
        f"{job['out']}.{r['rank']}.pt")[
            "first_logits"], one["first_logits"])
        for r in ranks)
    same = sum(r["tokens"] == one["tokens"].tolist()
               for r in ranks)
    failed = []
    for r in ranks:
        e = r["errs"]
        peak_ok = r["peak"] is None or (
            r["peak"] < bound
            and not (whole_gate and r["peak"] >= whole))
        pe = r["plain_errs"]
        a2a, rt = r["a2a"], r["routing"]
        a2a_ok = (a2a["prefill_bytes"] == job["want_a2a"]["prefill"]
                  and a2a["decode_bytes"] == job["want_a2a"]["decode"])
        ok = (max(e.values()) <= PLAIN_TOL
              and max(pe.values()) <= PLAIN_TOL
              and r["passed_through"] and a2a_ok and rt["sets_equal"]
              and r["bytes"] == want and r["shard_bytes"] == shard
              and peak_ok and r["shapes_ok"]
              and r["devices"] == [where])
        peak = ("not measured" if r["peak"] is None else
                f"{r['peak'] / 2 ** 30:.2f} GiB [< the "
                f"arguments {max(want.values()) / 2 ** 30:.2f} "
                f"(shards {shard / 2 ** 30:.2f}) + the largest "
                f"leaf in f32 + the dry run's temporaries and "
                f"outputs = {bound / 2 ** 30:.2f} GiB"
                + (f", < the whole model's "
                   f"{whole / 2 ** 30:.2f} GiB]" if whole_gate
                   else "]"))
        dms = ("not measured" if r["prefill_device_ms"] is None
               else f"{r['prefill_device_ms']:.3f}")
        experts = ""
        if cfg.moe is not None:
            experts = (
                f"the MoE blocks fed one process's FFN input: prefill "
                f"{e['moe']:.2e}, decode {e['moe_decode']:.2e} [<= "
                f"{PLAIN_TOL:g}], top-{cfg.moe.experts_per_token} sets "
                f"equal {rt['sets_equal']}; fed the rank's own, "
                f"{rt['flipped']} of {rt['tokens']} sets flipped "
                f"({rt['flipped'] / max(rt['tokens'], 1):.2%}, not gated); "
                f"all-to-all bytes sent {a2a['prefill_bytes']} (prefill) "
                f"and {a2a['decode_bytes']} (a decode step), dry run "
                f"{job['want_a2a']['prefill']} and "
                f"{job['want_a2a']['decode']}; all-to-all host ms: prefill "
                f"{a2a['prefill_ms']:.1f}, decode {a2a['decode_ms']:.1f} "
                f"(the other collectives {r['prefill_comm_ms'] - a2a['prefill_ms']:.1f}"
                f" and {r['decode_comm_ms'] - a2a['decode_ms']:.1f}); ")
        print(f"  {cfg.name} {shape} rank {r['rank']} "
              f"{r['coords']} on {r['devices']}: layer by layer "
              f"from one input against one process, "
              + (f"encoder {e['encoder']:.2e}, "
                 if "encoder" in e else "")
              + f"prefill {e['prefill']:.2e}, its cache "
              f"{e['prefill_cache']:.2e}, decode {e['decode']:.2e}"
              f", its written cache {e['decode_cache']:.2e} [<= "
              f"{PLAIN_TOL:g}] (worst layers {r['worst_at']}), "
              f"the rest passed through "
              f"{r['passed_through']}; " + experts + "the kernels against their "
              f"plain versions on the shards, {PLAIN_LAYERS} "
              f"layers: " + ", ".join(
                  f"{k} {v:.2e}" for k, v in pe.items())
              + f" [<= {PLAIN_TOL:g}]; "
              f"bytes {r['bytes']}, dry "
              f"run {want}; peak {peak}; launches at shard "
              f"shapes {r['shapes_ok']}; shards drawn in "
              f"{r['init_s']:.1f} s, layers held in "
              f"{r['chain_s']:.1f} s, {steps} decode steps in "
              f"{r['decode_s']:.1f} s; prefill "
              f"{r['prefill_ms']:.1f} ms host ({dms} ms device),"
              f" collectives {r['prefill_comm_ms']:.1f} ms "
              f"({r['prefill_comm_ms'] / r['prefill_ms']:.0%}); "
              f"decode {r['tokens_per_s']:.1f} tokens/s (one "
              f"process {one['tokens_per_s']:.1f}), collectives "
              f"{r['decode_comm_ms']:.1f} ms "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(r["rank"])
    if failed:
        raise AssertionError(
            f"phase 13 {cfg.name} {shape} ranks {failed}: a "
            "layer, a MoE block or its routing, a kernel against its "
            "plain version, the cache, the bytes, the all-to-all bytes, "
            "the peak, the launch shapes or the device disagree")
    if ranks[0]["prefill_device_top"]:
        print(f"  {cfg.name} {shape} rank 0's prefill, top "
              f"device events [name, ms, count]: "
              f"{json.dumps(ranks[0]['prefill_device_top'])}",
              flush=True)
    print(f"  {cfg.name} {shape}: all {cfg.num_layers} layers, "
          f"first-token "
          f"logits against one process {logit_err:.2e} (not "
          f"gated: the random layers amplify the sums' order), "
          f"greedy tokens equal on {same} of {len(ranks)} ranks "
          f"(not gated); launch shapes "
          f"{json.dumps(ranks[0]['shapes'])}", flush=True)
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


GLOO_OPS = ("all_reduce/float32", "all_reduce/int64", "all_reduce/bfloat16",
            "broadcast/float32", "all_gather/float32", "all_gather/bfloat16",
            "all_gather_into_tensor/float32",
            "reduce_scatter_tensor/float32", "all_to_all_single/float32",
            "all_to_all_single/bfloat16", "reduce/float32", "barrier/float32")


def gloo_probe_rank(case: str) -> int:
    """``chip_smoke.py --gloo-probe-rank OP/DTYPE``: one rank of the probe,
    one collective on CUDA tensors."""
    from repro_torch.launch.mesh import init_from_env
    dist = torch.distributed
    world = init_from_env()
    op, dtype = case.split("/")
    dev = torch.device("cuda", 0)
    x = torch.full((8,), dist.get_rank() + 1, dtype=getattr(torch, dtype),
                   device=dev)
    if op == "all_reduce":
        dist.all_reduce(x)
        got = x
    elif op == "broadcast":
        dist.broadcast(x, 0)
        got = x
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        got = torch.cat(parts)
    elif op == "all_gather_into_tensor":
        got = torch.empty(8 * world, dtype=x.dtype, device=dev)
        dist.all_gather_into_tensor(got, x)
    elif op == "reduce_scatter_tensor":
        got = torch.empty(8 // world, dtype=x.dtype, device=dev)
        dist.reduce_scatter_tensor(got, x)
    elif op == "all_to_all_single":
        got = torch.empty_like(x)
        dist.all_to_all_single(got, x)
    elif op == "reduce":
        dist.reduce(x, 0)
        got = x
    else:
        dist.barrier()
        got = x
    torch.cuda.synchronize(dev)
    print(json.dumps(got.float().tolist()))
    return 0


def gloo_probe_main(cases=GLOO_OPS) -> int:
    """``chip_smoke.py --gloo-probe [OP/DTYPE ...]``: which collectives gloo
    carries on CUDA tensors in this torch (``cases``, by default all of
    ``GLOO_OPS``), each in a pair of ranks of its own on ``cuda:0`` (a
    collective that crashes its ranks harms no other)."""
    from repro_torch.launch.mesh import run_ranks
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for case in cases:
        ranks = run_ranks([sys.executable, str(Path(__file__).resolve()),
                           "--gloo-probe-rank", case], 2, 90, env=env)
        codes = [c for c, _, _ in ranks]
        got = [o.strip().splitlines()[-1] if c == 0 and o.strip() else
               (e.strip().splitlines() or [""])[-1][:120]
               for c, o, e in ranks]
        print(f"  gloo {case} on cuda:0 x2: "
              f"{'carried' if codes == [0, 0] else 'NOT carried'} "
              f"(exit {codes}): {got}", flush=True)
    return 0


# phase 13's layer-by-layer gate on other draws (``--phase13-draws``):
# qwen2.5-14b's first 8 layers on (1, 2), drawn as an 8-layer model (seed
# 0's decode read 1.01e-2 > PLAIN_TOL) and as the whole model draws them,
# at seeds 0, 1 and 2 each, and the 8-layer model of seed 0 in f32
QWEN_8 = (("num_layers", 8),)
PHASE13_DRAWS = tuple(
    ShardedRun("qwen2.5-14b", ((1, 2),), STEPS_TRAFFIC, widths, layers, seed)
    for widths, layers in ((QWEN_8, 0), ((), 8)) for seed in (0, 1, 2)) + (
    ShardedRun("qwen2.5-14b", ((1, 2),), STEPS_TRAFFIC,
               QWEN_8 + (("dtype", "float32"),)),)
# ``--reduce-probe``: the model axis's two ways to sum, timed on each side
# of SMALL_REDUCE_BYTES for each of these numbers of ranks on the card
REDUCE_PROBE_RANKS = (2, 3, 16)
REDUCE_PROBE_BYTES = (4 << 10, 64 << 10, 256 << 10, 1 << 20, 4 << 20,
                      16 << 20, 42 << 20)
REDUCE_PROBE_REPS = 7


def phase13_draws_main() -> int:
    """``chip_smoke.py --phase13-draws``: phase 13 on each run of
    ``PHASE13_DRAWS`` in turn, each printed whether or not its gates
    pass; exit 1 if any failed."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    kernels.build_all()
    failed = 0
    for run in PHASE13_DRAWS:
        print(f"[13] {run}", flush=True)
        try:
            sharded_serving_phase(torch.device("cuda"), ((run,),))
        except AssertionError as e:
            failed += 1
            print(f"  FAILED: {str(e)[:600]}", flush=True)
    return 1 if failed else 0


def reduce_probe_rank() -> int:
    """``chip_smoke.py --reduce-probe-rank``: one rank of the probe. A
    ``ModelAxis`` of all the ranks sums f32 tensors of each of
    ``REDUCE_PROBE_BYTES`` on the card, as an all-gather and a local sum
    and as an all_reduce, the two alternating; rank 0 prints each one's
    median host ms (ending in a synchronize) as one JSON line."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import Mesh, init_from_env
    world = init_from_env()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    from repro_torch.device import synchronize
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else \
        torch.device("cpu")
    group = sharding.ShardGroup(Mesh(("data", "model"), (1, world),
                                     dev.type), dev)
    ax = sharding.ModelAxis(group)
    out = {}
    for nbytes in REDUCE_PROBE_BYTES:
        x = torch.full((nbytes // 4,), float(group.rank + 1), device=dev)
        want = world * (world + 1) / 2
        times = {"gather": [], "all_reduce": []}
        for rep in range(REDUCE_PROBE_REPS + 1):
            for way, limit in (("gather", nbytes), ("all_reduce", -1)):
                sharding.SMALL_REDUCE_BYTES = limit
                synchronize(dev)
                t = time.monotonic()
                y = ax.sum(x)
                synchronize(dev)
                if rep:                            # the first is warm-up
                    times[way].append((time.monotonic() - t) * 1e3)
                assert float(y[0]) == float(y[-1]) == want, (way, y[0])
        out[nbytes] = {k: statistics.median(v) for k, v in times.items()}
    if group.rank == 0:
        print(json.dumps(out), flush=True)
    return 0


def reduce_probe_main() -> int:
    """``chip_smoke.py --reduce-probe``: ``reduce_probe_rank`` on each
    number of ranks of ``REDUCE_PROBE_RANKS``, all on ``cuda:0``, sharing
    the host as phase 13's ranks do; a line a size."""
    from repro_torch.launch.mesh import run_ranks
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for n in REDUCE_PROBE_RANKS:
        ranks = run_ranks([sys.executable, str(Path(__file__).resolve()),
                           "--reduce-probe-rank"], n, 300, env=env)
        if any(c for c, _, _ in ranks):
            print(f"  {n} ranks failed: {ranks[0][2][-2000:]}", flush=True)
            return 1
        for nbytes, ms in json.loads(
                ranks[0][1].strip().splitlines()[-1]).items():
            print(f"  {n} ranks, {int(nbytes)} B f32: all-gather + sum "
                  f"{ms['gather']:.3f} ms, all_reduce "
                  f"{ms['all_reduce']:.3f} ms (median of "
                  f"{REDUCE_PROBE_REPS}, host clock)", flush=True)
    return 0


def restart_main(ckpt_dir: str) -> int:
    """``chip_smoke.py --restart-gate DIR``: gate (c) alone, under
    deterministic algorithms (the caller sets CUBLAS_WORKSPACE_CONFIG)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    restart_gate(torch.device("cuda"), Path(ckpt_dir))
    return 0


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
    t0 = t_script = time.monotonic()
    built = kernels.build_all()
    print(f"  built {built} in {time.monotonic() - t0:.1f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")

    dev = torch.device("cuda")
    cfg = get_config("qwen2.5-14b")
    mcfg = get_config("mamba2-130m")
    print("[2] kernel against plain version", flush=True)
    from repro_torch.kernels.launch import CUDA_CORES, TENSOR_CORES
    for label, (desc, args) in small_cases(dev).items():
        before = dict(desc.kernel.launches)
        check_forms(label, desc, args, "small")
        check_route(desc, before, CUDA_CORES)
    for label, (desc, args) in tc_cases(dev).items():
        before = dict(desc.kernel.launches)
        check_forms(label, desc, args, desc.kernel.name)
        check_route(desc, before, TENSOR_CORES)
    cases = {**full_cases(cfg, dev), **ssd_full_cases(mcfg, dev)}
    errs, refs = {}, {}
    for label, (desc, args) in cases.items():
        before = dict(desc.kernel.launches)
        errs[label], refs[label] = check_forms(label, desc, args,
                                               desc.kernel.name)
        check_route(desc, before, desc.kernel.route(desc, args))

    print("[3] times at qwen2.5-14b and mamba2-130m width (bf16)",
          flush=True)
    # the HP prefills of L = 150 and L = 1 in the plain form, as served
    rows = time_cases({k: v for k, v in cases.items()
                       if k not in ("ssd_hp_s100", "ssd_hp_s64")}, REPS,
                      cfg.num_heads, plain_only=("ssd_hp_s300",
                                                 "ssd_hp_s257"))

    print("[4] main path: Tally server, HP inference + BE training",
          flush=True)
    counts = server_phase(cfg, cases, refs, dev)

    print("[5] model path: mamba2-130m behind the ServingEngine", flush=True)
    m_counts = model_phase(mcfg, dev)

    fams = {f.name: f for f in kernels.FAMILIES}
    lines = []
    for fname, label in (("matmul", "mm_be"), ("flash", "flash_be"),
                         ("ssd", "ssd_be")):
        fam = fams[fname]
        desc, args = cases[label]
        lines.append((fam, label, desc.name, fam.route(desc, args)))
    # phase 6 holds 55 GiB of parameters: free what phases 2-5 left
    del cases, refs, desc, args
    gc.collect()
    torch.cuda.empty_cache()

    print("[6] dense model path: qwen2.5-14b behind the ServingEngine",
          flush=True)
    d_counts, d_rows = dense_phase(cfg, dev)
    print("  serving shapes: " + json.dumps(
        {label: r for (label, _), r in d_rows.items()}))
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.launch.serve import serve as serve_driver
    out = serve_driver("qwen2.5-14b", requests=16)
    print(f"  repro_torch.launch.serve.serve('qwen2.5-14b', requests=16) "
          f"(reduced width): {json.dumps(out)}", flush=True)
    if out["requests"] != 16 or out["shed"] or out["device"] != "cuda:0":
        raise AssertionError("the serving driver did not answer every "
                             "request on the card")
    gc.collect()
    torch.cuda.empty_cache()

    print("[7] training on the card: gradients, the full model, restart, "
          "co-location with the served model", flush=True)
    c_counts, grads = training_phase(mcfg, dev)
    # phase 8 holds 21 GiB of parameters: free what phases 6 and 7 left
    gc.collect()
    torch.cuda.empty_cache()

    print("[8] the MoE and audio model paths: qwen3-moe-30b-a3b behind the "
          "ServingEngine, whisper-base encoded and decoded", flush=True)
    t8 = time.monotonic()
    q_counts, q_rows = moe_phase(get_config("qwen3-moe-30b-a3b"), dev)
    print("  MoE serving shapes: " + json.dumps(
        {label: r for (label, _), r in q_rows.items()}))
    gc.collect()
    torch.cuda.empty_cache()
    for arch in ("qwen3-moe-30b-a3b", "jamba-1.5-large-398b"):
        out = serve_driver(arch, requests=16)
        print(f"  repro_torch.launch.serve.serve({arch!r}, requests=16) "
              f"(reduced width): {json.dumps(out)}", flush=True)
        if out["requests"] != 16 or out["shed"] or out["device"] != "cuda:0":
            raise AssertionError(f"the serving driver did not answer every "
                                 f"{arch} request on the card")
    gc.collect()
    torch.cuda.empty_cache()
    w_counts, w_rows = whisper_phase(get_config("whisper-base"), dev)
    print("  whisper shapes: " + json.dumps(
        {label: r for (label, _), r in w_rows.items()}))
    print(f"  phase 8 in {time.monotonic() - t8:.1f} s", flush=True)
    # phase 9 holds 62.1 GiB of bf16 weights: free what phase 8 left
    gc.collect()
    torch.cuda.empty_cache()

    print("[9] the serving steps: deepseek-coder-33b whole in bf16 through "
          "make_prefill_step and make_decode_step; gradient compression",
          flush=True)
    t9 = time.monotonic()
    s_counts, s_rows, s_measured = steps_phase(
        get_config("deepseek-coder-33b"), dev)
    print("  serving-step shapes: " + json.dumps(
        {label: r for (label, _), r in s_rows.items()}))
    gc.collect()
    torch.cuda.empty_cache()
    compression_gate(grads, dev)
    print(f"  phase 9 in {time.monotonic() - t9:.1f} s", flush=True)
    # phase 10 holds 55 GiB of parameters: free what phase 9 left
    gc.collect()
    torch.cuda.empty_cache()

    print("[10] the co-location example at full width: qwen2.5-14b served "
          "beside a mamba2-130m trainer, observed by the telemetry hub, "
          "with chaos and failover", flush=True)
    o_counts, o_rows = colocated_obs_phase(cfg, mcfg, dev)
    print("  example prompt shapes: " + json.dumps(
        {label: r for (label, _), r in o_rows.items()}))
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.colocate_serve_train import colocate_serve_train
    out, _ = colocate_serve_train(chaos=True, failover=True)
    print(f"  python -m repro_torch.colocate_serve_train --chaos --failover "
          f"(reduced width): {json.dumps(out)}", flush=True)
    if (out["requests"] != OBS_REQUESTS or out["shed"]
            or out["retries"] < 1 or out["device"] != "cuda:0"):
        raise AssertionError("the co-location example did not answer every "
                             "request on the card through its retries")

    print("[11] the dry run: every family's cell priced at H100 rates on "
          "the production meshes; phase 9's cells against the card",
          flush=True)
    t11 = time.monotonic()
    dryrun_phase(get_config("deepseek-coder-33b"), s_measured, card, dev)
    print(f"  phase 11 in {time.monotonic() - t11:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    print("[12] the train step sharded over a mesh of processes: "
          "mamba2-130m whole, two ranks of one gloo group on the card, on "
          "(2, 1) and (1, 2)", flush=True)
    sharded_phase("mamba2-130m", dev)
    gc.collect()
    torch.cuda.empty_cache()

    print("[13] the serving steps sharded over a mesh of processes, "
          "tensor-parallel on the model axis, the MoE blocks "
          "expert-parallel over the data axes, the ranks of one gloo group "
          "on the card: qwen2.5-14b in bf16 cut to its first 2 layers on "
          "(1, 2) and 24 on (1, 3), mamba2-130m cut to its first 8 "
          "layers on (1, 2), (2, 1) and (1, 16), whisper-base whole on "
          "(1, 3), qwen3-moe-30b-a3b cut to its first 8 layers on (2, 1) "
          "and (2, 2), jamba-1.5-large-398b's first period (experts' d_ff "
          "6144) on (2, 2)", flush=True)
    p_counts = sharded_serving_phase(dev)

    summary = []
    for fam, label, shape, route in lines:
        for form in ("plain", "sliced", "persistent"):
            r = rows[(label, form)]
            name = fam.symbol(route, form)
            by_path = {"server": counts[name],
                       "mamba2_serving": m_counts[name],
                       "qwen_serving": d_counts[name],
                       "colocated": c_counts[name],
                       "moe_serving": q_counts[name],
                       "whisper": w_counts[name],
                       "deepseek_steps": s_counts[name],
                       "colocated_obs": o_counts[name],
                       "sharded_serving": p_counts.get(name, 0)}
            summary.append({
                "name": name, "route": "cuda", "tile_route": route,
                "source": fam.source, "replaces": fam.replaces,
                "shape": shape, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                **r, "max_abs_err": errs[label][form]})
    print(card)
    print(f"phases 1-13 in {time.monotonic() - t_script:.1f} s", flush=True)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--restart-gate"]:
        sys.exit(restart_main(sys.argv[2]))
    if sys.argv[1:2] == ["--gloo-probe"]:
        sys.exit(gloo_probe_main(sys.argv[2:] or GLOO_OPS))
    if sys.argv[1:2] == ["--gloo-probe-rank"]:
        sys.exit(gloo_probe_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--reduce-probe"]:
        sys.exit(reduce_probe_main())
    if sys.argv[1:2] == ["--reduce-probe-rank"]:
        sys.exit(reduce_probe_rank())
    if sys.argv[1:2] == ["--phase13-draws"]:
        sys.exit(phase13_draws_main())
    if sys.argv[1:2] == ["--sharded-serving-rank"]:
        sys.exit(sharded_serving_rank(sys.argv[2]))
    sys.exit(main())
