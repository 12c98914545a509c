"""Tiled matmul: ``C(M,N) f32 = A(M,K) @ B(K,N)``, A and B f32 or bf16.

Grid (nm, nn, nk): (m, n) parallel — the Tally-schedulable blocks — and k
sequential. The CUDA kernel (``csrc/matmul.cu``) runs one block per (m, n)
task and sweeps K inside it, on the tensor cores (wgmma + TMA) for bf16 and
on the CUDA cores for f32; ``matmul_body`` is the plain PyTorch version of
one grid cell, exactly the reference's body.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.descriptor import BlockMap, KernelDescriptor
from repro_torch.kernels.launch import (CUDA_CORES, DTYPE_CODES,
                                        TENSOR_CORES, TileKernel, tma_ready)


# the tensor cores' TMA loads start each column tile on a 16-byte boundary
# of B's rows: a column tile of bf16 is a multiple of 8 columns (bn = 86,
# of N = 688, traps the card with an illegal instruction)
TC_COLUMNS = 8


def _pick_block(dim: int, target: int, multiple: int = 1) -> int:
    """Largest divisor of dim <= target that is a multiple of ``multiple``
    (the largest divisor at all where there is none)."""
    fits = [b for b in range(min(dim, target), 0, -1) if dim % b == 0]
    return next((b for b in fits if b % multiple == 0), fits[0])


def matmul_body(pids, a, b, o):
    """One grid cell: zero the output tile at k == 0, then add a @ b in f32
    (callers on the card keep TF32 off)."""
    if pids[2] == 0:
        o.zero_()
    o += a.float() @ b.float()


class MatmulKernel(TileKernel):
    name = "matmul"
    lib = "matmul"
    source = "src/repro_torch/kernels/csrc/matmul.cu"
    replaces = "src/repro/kernels/matmul.py:26"
    routes = {TENSOR_CORES: "matmul", CUDA_CORES: "matmul_fma"}

    def route(self, desc, args):
        """Tensor cores for bf16 A and B that TMA can read (K and N
        multiples of 8) in column tiles of a multiple of 8; CUDA cores for
        f32, whose parity gate (1e-4) TF32 would break, at any block
        shape."""
        a, b = args
        if a.dtype == b.dtype == torch.float32:
            return CUDA_CORES
        if (a.dtype == b.dtype == torch.bfloat16 and tma_ready(a, b)
                and desc.static["bn"] % TC_COLUMNS == 0):
            return TENSOR_CORES
        return None

    def check(self, desc, args, outs) -> None:
        a, b = args
        (c,) = outs
        M, K = a.shape
        N = b.shape[1]
        if a.dtype != b.dtype or a.dtype not in DTYPE_CODES:
            raise TypeError(f"matmul kernel takes f32 or bf16 A and B of one "
                            f"type, got {a.dtype} and {b.dtype}")
        if (b.shape[0] != K or tuple(c.shape) != (M, N)
                or c.dtype != torch.float32):
            raise ValueError(f"matmul kernel: bad shapes {tuple(a.shape)} @ "
                             f"{tuple(b.shape)} -> {tuple(c.shape)} {c.dtype}")
        if not all(t.is_contiguous() for t in (a, b, c)):
            raise ValueError("matmul kernel takes contiguous tensors")
        if self.route(desc, args) is None:
            raise ValueError(f"no matmul route takes bf16 {M}x{K} @ {K}x{N}: "
                             f"in column tiles of {desc.static['bn']}: the "
                             "tensor cores need K, N and the column tile "
                             "multiples of 8 and 16-byte aligned bases")

    def shape_args(self, desc, args, outs):
        a, b = args
        M, K = a.shape
        s = desc.static
        return [ctypes.c_int(v) for v in (M, K, b.shape[1], s["bm"], s["bn"])]


MATMUL = MatmulKernel()


def matmul_desc(M: int, K: int, N: int, dtype=torch.float32, *,
                bm: int = 128, bk: int = 512, bn: int = 128
                ) -> KernelDescriptor:
    bm = _pick_block(M, bm)
    bk = _pick_block(K, bk)
    bn = _pick_block(N, bn, TC_COLUMNS)
    grid = (M // bm, N // bn, K // bk)
    itemsize = dtype.itemsize
    return KernelDescriptor(
        name=f"matmul_{M}x{K}x{N}",
        body=matmul_body,
        kernel=MATMUL,
        static={"bm": bm, "bk": bk, "bn": bn},
        grid=grid,
        in_maps=(BlockMap((bm, bk), lambda i, j, k: (i, k)),
                 BlockMap((bk, bn), lambda i, j, k: (k, j))),
        out_maps=(BlockMap((bm, bn), lambda i, j, k: (i, j)),),
        out_shape=(((M, N), torch.float32),),
        parallel_axes=(0, 1),
        flops=2.0 * M * N * K,
        bytes_accessed=float((M * K + K * N) * itemsize + M * N * 4),
        revisits_output=True,
    )
