"""Mamba2 SSD chunk scan.

Grid (B, nc): batch parallel, chunk axis sequential (the SSD inter-chunk
recurrence). Tally slices and preempts only the batch axis: the
cluster-level fallback of paper §6 for kernels with inter-block
dependencies. The reference keeps the running state h (NH, HD, DS) in VMEM
scratch across the chunk steps and writes it out every chunk (last wins).
The port's descriptor has no scratch: the plain version carries the state
in the f32 ``hout`` block itself. The CUDA kernel (``csrc/mamba2_scan.cu``)
runs one head of one batch element a block, in two routes: bf16 on the
tensor cores (``ssd_*``: TMA loads, ``wgmma`` products, the state in f32
registers), f32 on the CUDA cores (``ssd_fma_*``: the state in shared
memory).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.descriptor import BlockMap, KernelDescriptor
from repro_torch.kernels.launch import (CUDA_CORES, DTYPE_CODES,
                                       TENSOR_CORES, TileKernel, tma_ready)

# the CUDA-core routine's limits: of 256 threads, each owns at most 8
# head-dim columns of a row of y and an 8 x 4 patch of one head's state,
# and the chunk's cumsum lives in shared memory
MAX_HEAD_DIM = 64
MAX_STATE_DIM = 128
MAX_CHUNK = 4096
# the tensor-core routine's: a row of x is one 128-byte TMA box (64 bf16),
# the state one or two 64-column wgmma tiles; any chunk length
TC_HEAD_DIM = 64
TC_STATE_DIMS = (64, 128)


def chunk_len(S: int, chunk: int) -> int:
    """The largest divisor of S that is <= chunk (a prime S gives 1)."""
    L = min(chunk, S)
    while S % L:
        L -= 1
    return L


def make_ssd_body(L: int, NH: int, HD: int, DS: int):
    def body(pids, x_ref, dt_ref, a_ref, b_ref, c_ref, dD_ref,
             y_ref, hout_ref):
        c_idx = pids[1]
        dev = x_ref.device
        tri = torch.ones(L, L, dtype=torch.bool, device=dev).tril()
        xk = x_ref[0].float()                               # (L, NH, HD)
        dtk = dt_ref[0].float()                             # (L, NH)
        A = a_ref.float()                                   # (NH,)
        bk = b_ref[0].float()                               # (L, DS)
        ck = c_ref[0].float()                               # (L, DS)
        D = dD_ref.float()                                  # (NH,)
        # the carried state: zero at the first chunk, else the last write
        h = (torch.zeros(NH, HD, DS, device=dev) if c_idx == 0
             else hout_ref[0].clone())

        la = dtk * A[None]                                  # (L, NH)  (<0)
        cum = torch.cumsum(la, dim=0)
        tot = cum[-1]                                       # (NH,)

        cb = ck @ bk.T                                      # (L, L)
        delta = cum[:, None] - cum[None]                    # (t, s, NH)
        delta = torch.where(tri[..., None], delta, -torch.inf)
        g = cb[..., None] * torch.exp(delta) * dtk[None]    # (t, s, NH)
        y = torch.einsum("tsh,shd->thd", g, xk)             # (L, NH, HD)
        # incoming-state contribution
        y = y + torch.einsum("th,td,hed->the", torch.exp(cum), ck, h)
        y = y + xk * D[None, :, None]
        y_ref[0] = y.to(y_ref.dtype)

        # state update
        w = torch.exp(tot[None] - cum) * dtk                # (L, NH)
        hc = torch.einsum("th,thd,te->hde", w, xk, bk)      # (NH, HD, DS)
        hout_ref[0] = torch.exp(tot)[:, None, None] * h + hc

    return body


class SsdKernel(TileKernel):
    name = "ssd"
    lib = "mamba2_scan"
    source = "src/repro_torch/kernels/csrc/mamba2_scan.cu"
    replaces = "src/repro/kernels/mamba2_scan.py:21"
    routes = {TENSOR_CORES: "ssd", CUDA_CORES: "ssd_fma"}

    def route(self, desc, args):
        """Tensor cores for bf16 x, Bm, Cm with HD = 64 and DS = 64 or 128
        that TMA can read; CUDA cores for f32 (HD <= 64, DS <= 128, chunks
        of at most 4096 tokens). The dtypes of dt, A, D and the outputs are
        ``check``'s."""
        x, Bm, Cm = args[0], args[3], args[4]
        if not x.dtype == Bm.dtype == Cm.dtype:
            return None
        HD, DS = x.shape[-1], Bm.shape[-1]
        if x.dtype == torch.bfloat16:
            return (TENSOR_CORES if HD == TC_HEAD_DIM
                    and DS in TC_STATE_DIMS and tma_ready(x, Bm, Cm)
                    else None)
        if (x.dtype == torch.float32 and HD <= MAX_HEAD_DIM
                and DS <= MAX_STATE_DIM and desc.static["L"] <= MAX_CHUNK):
            return CUDA_CORES
        return None

    def check(self, desc, args, outs) -> None:
        x, dt, A, Bm, Cm, D = args
        y, h = outs
        B, S, NH, HD = x.shape
        DS = Bm.shape[-1]
        if x.dtype not in DTYPE_CODES or not all(
                t.dtype == x.dtype for t in (Bm, Cm, y)):
            raise TypeError("ssd kernel takes x, Bm, Cm and y of one type, "
                            "f32 or bf16")
        if not all(t.dtype == torch.float32 for t in (dt, A, D, h)):
            raise TypeError("ssd kernel takes dt, A, D and h in f32")
        want = {"dt": (B, S, NH), "A": (NH,), "Bm": (B, S, DS),
                "Cm": (B, S, DS), "D": (NH,), "y": (B, S, NH, HD),
                "h": (B, NH, HD, DS)}
        got = {"dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "D": D, "y": y, "h": h}
        bad = [k for k, v in want.items() if tuple(got[k].shape) != v]
        # a sliced launch covers batch rows [offset, offset + grid[0])
        if (bad or desc.offsets[0] + desc.grid[0] > B
                or desc.static["L"] * desc.grid[1] != S):
            raise ValueError(f"ssd kernel: bad shapes {bad} for x "
                             f"{tuple(x.shape)} ({desc.name})")
        if not all(t.is_contiguous() for t in (*args, *outs)):
            raise ValueError("ssd kernel takes contiguous tensors")
        if self.route(desc, args) is None:
            raise ValueError(
                f"no ssd route takes {x.dtype} with HD={HD} DS={DS} "
                f"L={desc.static['L']}: f32 takes HD <= {MAX_HEAD_DIM}, "
                f"DS <= {MAX_STATE_DIM} and L <= {MAX_CHUNK}; bf16 takes "
                f"HD = {TC_HEAD_DIM}, DS in {TC_STATE_DIMS} with 16-byte "
                "aligned x, Bm and Cm")

    def shape_args(self, desc, args, outs):
        x, Bm = args[0], args[3]
        B, S, NH, HD = x.shape
        ints = (B, S, NH, HD, Bm.shape[-1], desc.static["L"],
                DTYPE_CODES[x.dtype])
        return [ctypes.c_int(v) for v in ints]


SSD = SsdKernel()


def mamba2_scan_desc(B: int, S: int, NH: int, HD: int, DS: int,
                     chunk: int, dtype=torch.float32) -> KernelDescriptor:
    L = chunk_len(S, chunk)
    nc = S // L
    itemsize = dtype.itemsize
    return KernelDescriptor(
        name=f"ssd_{B}x{S}x{NH}x{HD}x{DS}",
        body=make_ssd_body(L, NH, HD, DS),
        kernel=SSD,
        static={"L": L},
        grid=(B, nc),
        in_maps=(BlockMap((1, L, NH, HD), lambda b, c: (b, c, 0, 0)),
                 BlockMap((1, L, NH), lambda b, c: (b, c, 0)),
                 BlockMap((NH,), lambda b, c: (0,)),
                 BlockMap((1, L, DS), lambda b, c: (b, c, 0)),
                 BlockMap((1, L, DS), lambda b, c: (b, c, 0)),
                 BlockMap((NH,), lambda b, c: (0,))),
        out_maps=(BlockMap((1, L, NH, HD), lambda b, c: (b, c, 0, 0)),
                  BlockMap((1, NH, HD, DS), lambda b, c: (b, 0, 0, 0))),
        out_shape=(((B, S, NH, HD), dtype),
                   ((B, NH, HD, DS), torch.float32)),
        parallel_axes=(0,),
        # the reference's counts: C·Bᵀ once per chunk, h's output left out
        # of the bytes
        flops=float(B * nc * (2 * L * L * DS + 2 * L * L * NH * HD
                              + 4 * L * NH * HD * DS)),
        bytes_accessed=float(B * S * (NH * HD * 2 + NH + 2 * DS) * itemsize),
        revisits_output=True,   # hout written every chunk (last wins)
    )
