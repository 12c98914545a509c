"""The two workload types the scheduler needs (``SimKernel``, ``Workload``).

Copied from ``repro.core.workloads`` (lines 34-62) without
``SimKernel.duration``, which prices a kernel on the simulator's device
model; the simulator and the trace synthesis are not part of the real-mode
path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List


@dataclass(frozen=True)
class SimKernel:
    """One schedulable kernel launch (the simulator's KernelDescriptor)."""

    name: str
    flops: float
    bytes: float
    blocks: int                  # schedulable tasks (parallel grid cells)
    sliceable: bool = True       # False => cooperative-kernel fallback (§6)


@dataclass
class Workload:
    """A client of the Tally server."""

    name: str
    kind: str                            # "train" | "infer"
    priority: int                        # 0 = high, 1+ = best-effort
    iteration: Callable[[int], List[SimKernel]]   # idx -> kernels
    samples_per_iteration: float = 1.0
    n_kernels: int = 1                   # kernels per iteration/request
    host_gap: float = 0.0                # host-side gap after each kernel
    iteration_time: float = 0.0          # isolated wall time per iteration
    ingest_skipped: int = 0              # malformed source rows dropped by
                                         # strict=False trace ingestion
    _iso_cache: Dict[str, float] = field(default_factory=dict, repr=False,
                                         compare=False)

    @property
    def is_high_priority(self) -> bool:
        return self.priority == 0

    @property
    def samples_per_kernel(self) -> float:
        """Fractional throughput credit per completed kernel."""
        return self.samples_per_iteration / max(self.n_kernels, 1)
