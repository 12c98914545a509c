"""Tally kernel transformation passes (paper §4.1), for CUDA kernels.

Slicing
    Partition the blocks of a kernel along its largest parallel grid axis
    into K sub-launches. The paper rewrites ``blockIdx -> blockIdx + offset``
    in PTX. Here every kernel family has a *sliced* CUDA entry point whose
    block index is ``blockIdx + offset`` along that axis; ``make_slice``
    records the offset on the descriptor. Tiles are written in place into
    the caller's buffers (where the JAX version aliased its outputs).

Preemption (persistent-worker form)
    W persistent worker blocks; worker w takes the tasks ``t >= start`` with
    ``t = w (mod W)`` in order (static round robin, as in the reference), at
    most ``budget`` of them per launch, finishes each task's full sequential
    sweep and writes its count to ``done[w]`` (int32). The host resumes at
    ``preempt_watermark`` — the same block-granularity turnaround bound as
    the paper's flag poll. The reference loops every worker over all
    ``total`` tasks; the CUDA form walks only its own residue class, with
    the same outputs and ``done``.

Sequential axes (K accumulation) are never split: a task is one combination
of parallel-axis indices and runs its full sequential sweep.

``run_tasks`` is the plain PyTorch path of all three forms: it walks the
same grid cells tile by tile, calling the descriptor's ``body`` on block
views (what Pallas ``interpret=True`` is to the reference).
"""
from __future__ import annotations

import itertools
from typing import Callable, Iterable, List, Tuple

import torch

from repro_torch.core.descriptor import KernelDescriptor


# ---------------------------------------------------------------------------
# Slicing transformation
# ---------------------------------------------------------------------------


def _slice_axis(desc: KernelDescriptor) -> int:
    """Slice along the largest parallel axis (most scheduling freedom)."""
    if not desc.parallel_axes:
        raise ValueError(f"{desc.name}: no parallel axes — not sliceable "
                         "(cooperative-kernel fallback, paper §6)")
    return max(desc.parallel_axes, key=lambda ax: desc.grid[ax])


def slice_plan(desc: KernelDescriptor, num_slices: int
               ) -> List[Tuple[int, int]]:
    """[(offset, length)] covering the sliced axis in num_slices pieces."""
    ax = _slice_axis(desc)
    n = desc.grid[ax]
    k = max(1, min(num_slices, n))
    bounds = [round(i * n / k) for i in range(k + 1)]
    return [(bounds[i], bounds[i + 1] - bounds[i]) for i in range(k)
            if bounds[i + 1] > bounds[i]]


def make_slice(desc: KernelDescriptor, offset: int, length: int
               ) -> KernelDescriptor:
    """Sub-kernel covering blocks [offset, offset+length) of the slice axis.

    The body still sees *original* block indices (the offset is re-added
    through ``block_offset``); only the launch geometry shrinks.
    """
    ax = _slice_axis(desc)
    grid = tuple(length if i == ax else g for i, g in enumerate(desc.grid))
    offs = tuple(o + offset if i == ax else o
                 for i, o in enumerate(desc.offsets))
    return desc.replace(name=f"{desc.name}@slice[{offset}:{offset + length}]",
                        grid=grid, block_offset=offs)


def build_sliced(desc: KernelDescriptor, offset: int, length: int) -> Callable:
    """Callable(prev_outputs, *args) -> outputs, writing only this slice.

    ``prev_outputs`` are updated in place and returned, so successive slice
    launches accumulate into one buffer (the GPU in-place semantics that the
    JAX version expressed with input/output aliasing).
    """
    sub = make_slice(desc, offset, length)

    def run(prev_outputs, *args):
        outs = (list(prev_outputs) if isinstance(prev_outputs, (list, tuple))
                else [prev_outputs])
        desc.kernel.sliced(sub, args, outs)
        return tuple(outs)

    return run


# ---------------------------------------------------------------------------
# Preemption transformation (persistent-worker form)
# ---------------------------------------------------------------------------


def _parallel_dims(desc: KernelDescriptor) -> Tuple[int, ...]:
    return tuple(desc.grid[ax] for ax in desc.parallel_axes)


def _task_to_pids(desc: KernelDescriptor, task, seq_pids: Tuple):
    """Reconstruct full grid indices from the flat task index (the paper's
    'workers use the task index to reconstruct block indices')."""
    dims = _parallel_dims(desc)
    pids = [None] * len(desc.grid)
    rem = task
    for ax, d in zip(reversed(desc.parallel_axes), reversed(dims)):
        pids[ax] = rem % d
        rem = rem // d
    it = iter(seq_pids)
    for ax in desc.sequential_axes:
        pids[ax] = next(it)
    return tuple(pids)


def preempt_watermark(start: int, budget: int, num_workers: int,
                      total: int) -> int:
    """Progress after a budgeted launch: with static round-robin, worker w
    completes its first min(budget, remaining) tasks >= start of residue
    class w, so tasks [start, start + budget*W) are exactly the completed
    window (capped at total). This is the host-side resume point — the
    deterministic analog of the paper's global task counter."""
    return min(start + budget * num_workers, total)


def worker_tasks(w: int, num_workers: int, start: int, budget: int,
                 total: int) -> List[int]:
    """Tasks worker ``w`` runs in one budgeted launch: its residue class
    from ``start``, at most ``budget`` of them, all below ``total``."""
    first = start + (w - start) % num_workers
    return list(range(first, total, num_workers))[:max(budget, 0)]


def make_preemptible(desc: KernelDescriptor, num_workers: int) -> Callable:
    """Build the persistent-worker form of a kernel.

    Returns ``run(prev_outputs, start_task, budget, *args) ->
    (outputs, per_worker_done)``. ``budget`` = max tasks per worker this
    launch (the cooperative preemption quantum; turnaround bound = one task
    per worker). Resume by relaunching with
    ``start_task = preempt_watermark(start, budget, W, total)``.
    """
    W = max(1, min(num_workers, desc.num_blocks))
    total = desc.num_blocks

    def run(prev_outputs, start_task, budget, *args):
        outs = (list(prev_outputs) if isinstance(prev_outputs, (list, tuple))
                else [prev_outputs])
        done = desc.kernel.persistent(desc, W, int(start_task), int(budget),
                                      args, outs)
        return tuple(outs), done

    run.num_workers = W
    run.total_tasks = total
    run.watermark = lambda start, budget: preempt_watermark(
        start, budget, W, total)
    return run


# ---------------------------------------------------------------------------
# Plain PyTorch path of every launch form: walk the grid cells tile by tile
# ---------------------------------------------------------------------------


def run_tasks(desc: KernelDescriptor, tasks: Iterable[int], args,
              outs) -> None:
    """Run ``desc.body`` for each flat task (numbered over ``desc.grid``'s
    parallel axes, shifted by ``desc.block_offset``), each over its full
    sequential sweep in order, on block views of ``args`` and ``outs``."""
    seq = [range(desc.grid[ax]) for ax in desc.sequential_axes]
    offs = desc.offsets
    with torch.no_grad():
        for task in tasks:
            for sp in itertools.product(*seq):
                pids = tuple(p + o for p, o in
                             zip(_task_to_pids(desc, task, sp), offs))
                desc.body(pids,
                          *(m.view(a, pids) for m, a in zip(desc.in_maps,
                                                            args)),
                          *(m.view(o, pids) for m, o in zip(desc.out_maps,
                                                            outs)))
