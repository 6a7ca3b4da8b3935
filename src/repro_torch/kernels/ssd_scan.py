"""ssd_scan — the Mamba2 SSD intra-chunk kernel for Hopper (CUDA C++,
sm_90a, ``csrc/ssd_scan.cu``).

Replaces ``repro.kernels.ssd_scan.ssd_intra_chunk`` (TPU Pallas): the
quadratic in-chunk term of the chunked SSD scan, the FLOPs hot-spot of
``models.layers.ssd_chunked``; the recurrence between chunks stays in
plain PyTorch, as the reference keeps it outside Pallas. The source
says what bounds it and how its design follows. The wrapper runs the
plain PyTorch version (``repro_torch.kernels.ref.ssd_intra_chunk_plain``)
for CPU tensors only; for a CUDA tensor it launches the kernel or
raises, and counts the launch in ``ssd_intra_chunk.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_intra_chunk_plain

HEAD_DIMS = (32, 64, 128)


def _bind(lib):
    fn = lib.ssd_intra_chunk_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def ssd_intra_chunk(xc, dAc, Bc, Cc):
    """xc (b, nc, cl, h, p); dAc (b, nc, cl, h); Bc, Cc (b, nc, cl, h, n)
    -> Y_diag (b, nc, cl, h, p) float32, the ``ssd_kernel`` hook of
    ``models.layers.ssd_chunked``. The kernel takes float32 and head_dim
    p of 32, 64 or 128; raises on anything else."""
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
    xc, dAc, Bc, Cc = (t.contiguous() for t in (xc, dAc, Bc, Cc))
    y = torch.empty_like(xc)
    if y.numel() == 0:
        return y
    lib = build.load("ssd_scan", _bind)
    with torch.cuda.device(xc.device):
        rc = lib.ssd_intra_chunk_launch(
            xc.data_ptr(), dAc.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            y.data_ptr(), b, nc, cl, h, p, n, build.stream_of(xc))
    if rc != 0:
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed: cudaError "
                           f"{rc} (b, nc, cl, h, p, n = {b, nc, cl, h, p, n}: "
                           f"a grid or shared-memory size the kernel does "
                           f"not take gives 1, invalid value)")
    ssd_intra_chunk.launches += 1
    return y


ssd_intra_chunk.launches = 0
