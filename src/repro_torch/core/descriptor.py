"""Kernel descriptors — Tally's non-intrusive interception boundary.

On NVIDIA GPUs Tally intercepts device code (PTX) and rewrites it. The JAX
package rewrote Pallas descriptors at trace time instead. Compiled CUDA
cannot be re-wrapped like that, so here a descriptor names its kernel
*family* (``kernel``, which carries one CUDA entry point per launch form:
plain, sliced, persistent) together with the family's static parameters
(``static``: block sizes, causal flag, ...). The transforms
(``core.transforms``) choose the launch form; user model code is never
touched.

Contract (as in the reference, paper §2): grid cells along
``parallel_axes`` are independent and may run in any order; the other axes
are sequential and are never reordered or split. ``body(pids, *views)`` is
the plain PyTorch version of one grid cell, written against block views cut
by the ``BlockMap``s; it is what runs for tensors on the CPU.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch


@dataclass(frozen=True)
class BlockMap:
    """One operand's blocking: block shape + block index map (in units of
    blocks, as in ``pl.BlockSpec``)."""

    block_shape: Tuple[int, ...]
    index_map: Callable[..., Tuple[int, ...]]

    def view(self, t: torch.Tensor, pids: Tuple[int, ...]) -> torch.Tensor:
        """The block of ``t`` that grid cell ``pids`` sees (a view: writes
        land in ``t``)."""
        idx = self.index_map(*pids)
        return t[tuple(slice(b * s, (b + 1) * s)
                       for b, s in zip(idx, self.block_shape))]


@dataclass(frozen=True)
class KernelDescriptor:
    """A Tally-schedulable kernel launch (the PTX analog)."""

    name: str
    body: Callable                      # body(pids, *in_views, *out_views)
    kernel: Any                         # kernels.launch.TileKernel family
    grid: Tuple[int, ...]
    in_maps: Tuple[BlockMap, ...]
    out_maps: Tuple[BlockMap, ...]
    out_shape: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]
    parallel_axes: Tuple[int, ...]      # grid axes with independent blocks
    static: Dict[str, Any] = field(default_factory=dict)
    flops: float = 0.0                  # per full launch
    bytes_accessed: float = 0.0         # each input read once, output once
    revisits_output: bool = False       # sequential axis accumulates into out
    # per-axis block offset of this launch inside the original grid (set by
    # transforms.make_slice: the paper's blockIdx + offset rewrite)
    block_offset: Tuple[int, ...] = ()

    # -- derived -------------------------------------------------------------
    @property
    def sequential_axes(self) -> Tuple[int, ...]:
        return tuple(i for i in range(len(self.grid))
                     if i not in self.parallel_axes)

    @property
    def num_blocks(self) -> int:
        """Schedulable work units = product over parallel axes."""
        n = 1
        for ax in self.parallel_axes:
            n *= self.grid[ax]
        return int(n)

    @property
    def total_grid(self) -> int:
        n = 1
        for g in self.grid:
            n *= g
        return int(n)

    @property
    def offsets(self) -> Tuple[int, ...]:
        return self.block_offset or (0,) * len(self.grid)

    def block_work(self) -> Tuple[float, float]:
        """(flops, bytes) per schedulable block — the turnaround unit."""
        n = max(self.num_blocks, 1)
        return self.flops / n, self.bytes_accessed / n

    def replace(self, **kw) -> "KernelDescriptor":
        return dataclasses.replace(self, **kw)


def new_outputs(desc: KernelDescriptor, device: torch.device,
                zero: bool = False) -> list:
    """Output buffers of ``desc`` on ``device``. Sliced and persistent
    launches fill them in place, tile by tile, so their buffers must start
    zeroed (``zero=True``); a plain launch overwrites every tile."""
    make = torch.zeros if zero else torch.empty
    return [make(shape, dtype=dtype, device=device)
            for shape, dtype in desc.out_shape]


def build_plain(desc: KernelDescriptor) -> Callable:
    """The descriptor as an ordinary launch over its full grid (no
    transform): ``run(*args) -> outputs``."""

    def run(*args):
        outs = new_outputs(desc, args[0].device)
        desc.kernel.plain(desc, args, outs)
        return tuple(outs)

    return run
