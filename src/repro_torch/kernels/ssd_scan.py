"""ssd_scan — the Mamba2 SSD intra-chunk kernel for Hopper (CUDA C++,
sm_90a, ``csrc/ssd_scan.cu``).

Replaces ``repro.kernels.ssd_scan.ssd_intra_chunk`` (TPU Pallas): the
quadratic in-chunk term of the chunked SSD scan, the FLOPs hot-spot of
``models.layers.ssd_chunked``; the recurrence between chunks stays in
plain PyTorch, as the reference keeps it outside Pallas. The source
says what bounds it and how its design follows. The wrapper runs the
plain PyTorch version (``repro_torch.kernels.ref.ssd_intra_chunk_plain``)
for CPU tensors only; for a CUDA tensor it launches the kernel or
raises, and counts the launch in ``ssd_intra_chunk.launches`` (one per
call: the call launches two CUDA kernels, C Bᵀ and then the per-head
term). Its products run on the tensor cores, each split into three TF32
products to hold the reference's 1e-4.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_intra_chunk_plain

HEAD_DIMS = (32, 64, 128)


def _bind(lib):
    fn = lib.ssd_intra_chunk_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ssd_intra_chunk_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.ssd_intra_chunk_smem_bytes.restype = ctypes.c_longlong


def smem_bytes(cl: int, p: int, n: int) -> tuple:
    """Dynamic shared memory per block, in bytes, of the two kernels (the
    C Bᵀ tiles, then the per-head term) at chunk length cl, head_dim p
    and state size n (builds them on first use)."""
    fn = build.load("ssd_scan", _bind).ssd_intra_chunk_smem_bytes
    return fn(0, p, n, cl), fn(1, p, n, cl)


def _rows(t):
    """``t`` with a contiguous last dimension. The kernel reads the other
    dimensions through their strides, so B and C expanded from one group
    to every head (a head stride of 0) are read in place; only a strided
    last dimension is copied."""
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def ssd_intra_chunk(xc, dAc, Bc, Cc):
    """xc (b, nc, cl, h, p); dAc (b, nc, cl, h); Bc, Cc (b, nc, cl, h, n)
    -> Y_diag (b, nc, cl, h, p) float32, the ``ssd_kernel`` hook of
    ``models.layers.ssd_chunked``. The inputs are read through their
    strides (B and C may be one group expanded over the heads). The
    kernel takes float32 and head_dim p of 32, 64 or 128; raises on
    anything else."""
    if xc.device.type == "cpu":
        return ssd_intra_chunk_plain(xc, dAc, Bc, Cc)
    b, nc, cl, h, p = xc.shape
    n = Bc.shape[-1]
    if any(t.dtype != torch.float32 for t in (xc, dAc, Bc, Cc)):
        raise TypeError(f"ssd_intra_chunk: dtypes {xc.dtype}/{dAc.dtype}/"
                        f"{Bc.dtype}/{Cc.dtype}; the kernel takes float32")
    if (dAc.shape != (b, nc, cl, h) or Bc.shape != (b, nc, cl, h, n)
            or Cc.shape != Bc.shape):
        raise ValueError(f"ssd_intra_chunk: xc {tuple(xc.shape)}, dAc "
                         f"{tuple(dAc.shape)}, Bc {tuple(Bc.shape)}, Cc "
                         f"{tuple(Cc.shape)}")
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd_intra_chunk: head_dim {p}; the kernel takes "
                         f"{HEAD_DIMS}")
    build.on_cuda("ssd_intra_chunk", xc, dAc, Bc, Cc)
    xc, Bc, Cc = _rows(xc), _rows(Bc), _rows(Cc)
    y = torch.empty((b, nc, cl, h, p), dtype=torch.float32,
                    device=xc.device)
    if y.numel() == 0:
        return y
    # C Bᵀ once per group when every head reads the same B and C
    gh = 1 if Bc.stride(3) == 0 and Cc.stride(3) == 0 else h
    clt = -(-cl // 64) * 64
    gram = torch.empty((b, nc, gh, clt, clt), dtype=torch.float32,
                       device=xc.device)
    strides = (ctypes.c_longlong * 20)(*(
        s for t in (xc, dAc, Bc, Cc, y) for s in t.stride()[:4]))
    lib = build.load("ssd_scan", _bind)
    with torch.cuda.device(xc.device):
        rc = lib.ssd_intra_chunk_launch(
            xc.data_ptr(), dAc.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            y.data_ptr(), gram.data_ptr(), strides, b, nc, cl, h, p, n, gh,
            build.stream_of(xc))
    if rc != 0:
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed: cudaError "
                           f"{rc} (b, nc, cl, h, p, n = {b, nc, cl, h, p, n}: "
                           f"a grid or shared-memory size the kernel does "
                           f"not take gives 1, invalid value)")
    ssd_intra_chunk.launches += 1
    return y


ssd_intra_chunk.launches = 0
