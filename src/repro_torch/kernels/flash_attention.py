"""Flash attention (online softmax, causal-capable, grouped KV heads).

Layout: q (BH, S, D); k, v (BH // group, T, D). Grid (BH, S/bq) — both axes
parallel; the KV sweep runs inside the tile with running (m, l, acc). The
CUDA kernel (``csrc/flash_attention.cu``) runs one block per task, on the
tensor cores (wgmma + TMA) for bf16 and on the CUDA cores for f32; the body
below is the plain PyTorch version of one grid cell, the reference's body.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.descriptor import BlockMap, KernelDescriptor
from repro_torch.kernels.launch import (CUDA_CORES, DTYPE_CODES,
                                        TENSOR_CORES, TileKernel, tma_ready)

MAX_HEAD_DIM = 128       # the f32 kernel keeps D/4 f32 values per thread
TC_HEAD_DIMS = (64, 128)   # the bf16 kernel: one or two 128-byte TMA boxes


def _pick_block(dim: int, target: int) -> int:
    b = min(dim, target)
    while dim % b:
        b -= 1
    return b


def make_flash_body(bq: int, bk: int, T: int, D: int, causal: bool,
                    q_offset: int = 0):
    nkb = T // bk
    scale = 1.0 / math.sqrt(D)

    def body(pids, q_ref, k_ref, v_ref, o_ref):
        j = pids[1]
        dev = q_ref.device
        q = q_ref[0].float() * scale                           # (bq, D)
        qpos = q_offset + j * bq + torch.arange(bq, device=dev)[:, None]
        m = torch.full((bq,), -math.inf, device=dev)
        l = torch.zeros(bq, device=dev)
        acc = torch.zeros(bq, D, device=dev)
        for t in range(nkb):
            kb = k_ref[0, t * bk:(t + 1) * bk].float()
            vb = v_ref[0, t * bk:(t + 1) * bk].float()
            s = q @ kb.T                                       # (bq, bk)
            if causal:
                kpos = t * bk + torch.arange(bk, device=dev)[None, :]
                s = torch.where(qpos >= kpos, s, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[:, None]),
                            0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[:, None] + p @ vb
            m = m_new
        o_ref[0] = (acc / torch.clamp_min(l, 1e-30)[:, None]).to(o_ref.dtype)

    return body


class FlashKernel(TileKernel):
    name = "flash"
    lib = "flash_attention"
    source = "src/repro_torch/kernels/csrc/flash_attention.cu"
    replaces = "src/repro/kernels/flash_attention.py:29"
    routes = {TENSOR_CORES: "flash", CUDA_CORES: "flash_fma"}

    def route(self, desc, args):
        """Tensor cores for bf16 q, k, v with D = 64 or 128 that TMA can
        read; CUDA cores for f32 (D <= 128)."""
        q, k, v = args
        if not q.dtype == k.dtype == v.dtype:
            return None
        D = q.shape[-1]
        if q.dtype == torch.float32 and D <= MAX_HEAD_DIM:
            return CUDA_CORES
        if (q.dtype == torch.bfloat16 and D in TC_HEAD_DIMS
                and tma_ready(q, k, v)):
            return TENSOR_CORES
        return None

    def check(self, desc, args, outs) -> None:
        q, k, v = args
        (o,) = outs
        s = desc.static
        BH, S, D = q.shape
        want_kv = (BH // s["group"], s["T"], D)
        if q.dtype not in DTYPE_CODES or not all(
                t.dtype == q.dtype for t in (k, v, o)):
            raise TypeError("flash kernel takes q, k, v, o of one type, f32 "
                            "or bf16")
        if (tuple(k.shape) != want_kv or tuple(v.shape) != want_kv
                or tuple(o.shape) != (BH, S, D) or D != s["D"]):
            raise ValueError(f"flash kernel: bad shapes q {tuple(q.shape)}, "
                             f"k {tuple(k.shape)}, v {tuple(v.shape)}")
        if not all(t.is_contiguous() for t in (q, k, v, o)):
            raise ValueError("flash kernel takes contiguous tensors")
        if self.route(desc, args) is None:
            raise ValueError(f"no flash route takes {q.dtype} with D={D}: "
                             f"f32 takes D <= {MAX_HEAD_DIM}, bf16 D in "
                             f"{TC_HEAD_DIMS} with 16-byte aligned bases")

    def shape_args(self, desc, args, outs):
        q = args[0]
        BH, S, D = q.shape
        s = desc.static
        ints = (BH, S, s["T"], D, s["group"], s["bq"], int(s["causal"]),
                s["q_offset"])
        return ([ctypes.c_int(v) for v in ints]
                + [ctypes.c_float(1.0 / math.sqrt(D))])


FLASH = FlashKernel()


def flash_attention_desc(BH: int, S: int, T: int, D: int, group: int,
                         dtype=torch.float32, *, causal: bool = True,
                         q_offset: int = 0, bq: int = 256, bk: int = 512
                         ) -> KernelDescriptor:
    bq = _pick_block(S, bq)
    bk = _pick_block(T, bk)
    grid = (BH, S // bq)
    itemsize = dtype.itemsize
    BKV = BH // group
    return KernelDescriptor(
        name=f"flash_{BH}x{S}x{T}x{D}{'_c' if causal else ''}",
        body=make_flash_body(bq, bk, T, D, causal, q_offset),
        kernel=FLASH,
        static={"bq": bq, "bk": bk, "T": T, "D": D, "group": group,
                "causal": causal, "q_offset": q_offset},
        grid=grid,
        in_maps=(BlockMap((1, bq, D), lambda i, j: (i, j, 0)),
                 BlockMap((1, T, D), lambda i, j: (i // group, 0, 0)),
                 BlockMap((1, T, D), lambda i, j: (i // group, 0, 0))),
        out_maps=(BlockMap((1, bq, D), lambda i, j: (i, j, 0)),),
        out_shape=(((BH, S, D), dtype),),
        parallel_axes=(0, 1),
        flops=4.0 * BH * S * T * D * (0.5 if causal else 1.0),
        bytes_accessed=float((BH * S * D * 2 + 2 * BKV * T * D) * itemsize),
    )
