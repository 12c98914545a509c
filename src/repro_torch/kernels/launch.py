"""One kernel family's three launch forms, with their launch counts and
their plain PyTorch versions.

A ``TileKernel`` wraps, for each of its routes, the C entry points
``<prefix>_plain``, ``<prefix>_sliced`` and ``<prefix>_persistent`` of
``csrc/<lib>.cu``. ``route(desc, args)`` picks the route of a launch in one
place (the matmul and flash families: ``cuda-wgmma-tma``, tensor cores, for
bf16, and ``cuda-fma``, CUDA cores, for f32); ``check`` refuses a launch
that no route takes. For tensors on the CPU a form runs its plain version,
which walks the same grid cells tile by tile through the descriptor's
``body``; for CUDA tensors it launches the route's kernel, on PyTorch's
current stream, or raises. There is no fallback from one to the other, and
a route never changes on an error.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core import transforms as T
from repro_torch.core.descriptor import KernelDescriptor
from repro_torch.kernels import _build

FORMS = ("plain", "sliced", "persistent")
MAX_GRID_Y = 65535
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TENSOR_CORES, CUDA_CORES = "cuda-wgmma-tma", "cuda-fma"


def tma_ready(*ts: torch.Tensor) -> bool:
    """TMA reads a tensor whose base and row strides are 16-byte aligned:
    contiguous, the innermost extent a multiple of 16 bytes."""
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0
               and (t.shape[-1] * t.element_size()) % 16 == 0 for t in ts)


class TileKernel:
    """Base of a kernel family. Subclasses set ``name``, ``lib``,
    ``source``, ``replaces`` and ``routes`` and implement ``check`` and
    ``shape_args``, and ``route`` where they have more than one route."""

    name = ""          # the family
    lib = ""           # csrc/<lib>.cu
    source = ""        # CUDA source, path in the repository
    replaces = ""      # the TPU kernel it replaces, file:line
    routes: Dict[str, str] = {}   # route -> prefix of its C entry points

    def __init__(self) -> None:
        # launches of each C entry point; a wrapper adds one exactly where
        # it launches its kernel
        self.launches: Dict[str, int] = {self.symbol(r, f): 0
                                         for r in self.routes for f in FORMS}

    def symbol(self, route: str, form: str) -> str:
        """The C entry point of ``form`` on ``route``."""
        return f"{self.routes[route]}_{form}"

    # -- per family ------------------------------------------------------------
    def route(self, desc: KernelDescriptor, args) -> Optional[str]:
        """The route that takes this launch, or None if none does. A
        family with one route sends there every launch ``check`` passes."""
        (only,) = self.routes
        return only

    def check(self, desc: KernelDescriptor, args, outs) -> None:
        """Raise on what the kernel does not take."""
        raise NotImplementedError

    def shape_args(self, desc: KernelDescriptor, args, outs) -> List:
        """The C entry points' arguments after the pointers (ctypes)."""
        raise NotImplementedError

    # -- the three launch forms ----------------------------------------------
    def plain(self, desc: KernelDescriptor, args, outs) -> None:
        if self._on_cpu(args, outs):
            return self.plain_version(desc, args, outs)
        self._grid(desc)
        self._launch("plain", desc, args, outs, [])

    def sliced(self, sub: KernelDescriptor, args, outs) -> None:
        """``sub`` comes from ``transforms.make_slice``: its grid is the
        slice, its ``block_offset`` where the slice starts."""
        if self._on_cpu(args, outs):
            return self.sliced_version(sub, args, outs)
        g0, g1 = self._grid(sub)
        off0, off1 = self._pair(sub, sub.offsets, 0)
        self._launch("sliced", sub, args, outs,
                     [ctypes.c_int(g0), ctypes.c_int(g1),
                      ctypes.c_int(off0), ctypes.c_int(off1)])

    def persistent(self, desc: KernelDescriptor, W: int, start: int,
                   budget: int, args, outs) -> torch.Tensor:
        """One budgeted launch of ``W`` persistent workers; returns the
        per-worker task counts ``done`` (int32, ``(W,)``)."""
        if self._on_cpu(args, outs):
            return self.persistent_version(desc, W, start, budget, args, outs)
        done = torch.zeros(W, dtype=torch.int32, device=outs[0].device)
        self._launch("persistent", desc, args, outs,
                     [ctypes.c_int(W), ctypes.c_int(start),
                      ctypes.c_int(budget), ctypes.c_void_p(done.data_ptr())])
        return done

    # -- plain PyTorch versions (any device) -----------------------------------
    def plain_version(self, desc, args, outs) -> None:
        T.run_tasks(desc, range(desc.num_blocks), args, outs)

    def sliced_version(self, sub, args, outs) -> None:
        T.run_tasks(sub, range(sub.num_blocks), args, outs)

    def persistent_version(self, desc, W, start, budget, args, outs
                           ) -> torch.Tensor:
        done = []
        for w in range(W):
            tasks = T.worker_tasks(w, W, start, budget, desc.num_blocks)
            T.run_tasks(desc, tasks, args, outs)
            done.append(len(tasks))
        return torch.tensor(done, dtype=torch.int32, device=outs[0].device)

    # -- CUDA ------------------------------------------------------------------
    def library(self) -> ctypes.CDLL:
        """Build (first use) and load this family's library."""
        return _build.load(self.lib)

    def reset_counts(self) -> None:
        for k in self.launches:
            self.launches[k] = 0

    @staticmethod
    def _on_cpu(args: Sequence[torch.Tensor],
                outs: Sequence[torch.Tensor]) -> bool:
        devs = {t.device for t in (*args, *outs)}
        if devs == {torch.device("cpu")}:
            return True
        if len(devs) != 1 or next(iter(devs)).type != "cuda":
            raise RuntimeError(f"tensors on {sorted(map(str, devs))}: a "
                               "kernel takes all its tensors on one CUDA "
                               "device, or all on the CPU for its plain "
                               "version")
        return False

    @staticmethod
    def _pair(desc: KernelDescriptor, values, missing: int):
        """``values`` along the one or two parallel axes as (v0, v1); a
        missing second axis gives ``missing`` (``csrc/tile_sched.cuh``
        runs a one-axis grid as G1 = 1, off1 = 0)."""
        got = [values[ax] for ax in desc.parallel_axes]
        if not 1 <= len(got) <= 2:
            raise ValueError(f"{desc.name}: {len(got)} parallel axes; the "
                             "CUDA launch forms take one or two")
        return (got[0], got[1] if len(got) == 2 else missing)

    @classmethod
    def _grid(cls, desc: KernelDescriptor):
        g0, g1 = cls._pair(desc, desc.grid, 1)
        if g1 > MAX_GRID_Y:
            raise ValueError(f"{desc.name}: grid axis 1 has {g1} blocks, "
                             f"more than CUDA's {MAX_GRID_Y}")
        return g0, g1

    def _launch(self, form: str, desc, args, outs, extra: List) -> None:
        self.check(desc, args, outs)
        sym = self.symbol(self.route(desc, args), form)
        fn = getattr(self.library(), sym)
        cargs = ([ctypes.c_void_p(t.data_ptr()) for t in (*args, *outs)]
                 + self.shape_args(desc, args, outs) + extra
                 + [ctypes.c_void_p(
                     torch.cuda.current_stream(outs[0].device).cuda_stream)])
        fn.argtypes = [type(a) for a in cargs]
        fn.restype = ctypes.c_int
        rc = fn(*cargs)
        self.launches[sym] += 1
        if rc != 0:
            raise RuntimeError(f"{sym} failed to launch: CUDA error {rc} "
                               f"({desc.name})")
