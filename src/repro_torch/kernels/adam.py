"""adam — the fused mixed-precision Adam update for Hopper (CUDA C++,
sm_90a, ``csrc/adam.cu``).

A port kernel with no TPU counterpart (the reference leaves its update to
XLA's fusion). One launch per leaf reads the gradient, the f32 master, m
and v once and writes the master, m, v and the bf16 weight once: 30 B a
parameter with an f32 gradient (28 B with a bf16 one), where the plain
PyTorch version makes about 17 passes. It is bit-equal on the card to
the plain version, ``repro_torch.kernels.ref.adam_plain``, given the same
scalars; the source says how.

The wrapper runs the plain version for tensors off the card (the CPU,
and the meta tensors of the dry run); for CUDA tensors it launches the
kernel or raises, and counts each launch in ``adam_update_.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import adam_plain

_GRAD_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib):
    fn = lib.adam_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong] + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _check_leaf(i, g, p, mw, m, v):
    if g.dtype not in _GRAD_CODES or p.dtype != torch.bfloat16 or any(
            t.dtype != torch.float32 for t in (mw, m, v)):
        raise TypeError(f"adam: leaf {i} has grad {g.dtype}, param "
                        f"{p.dtype}, master/m/v {mw.dtype}/{m.dtype}/"
                        f"{v.dtype}; the kernel takes a float32 or bfloat16 "
                        f"grad, a bfloat16 param and float32 state")
    shape = p.shape
    if any(t.shape != shape for t in (g, mw, m, v)):
        raise ValueError(f"adam: leaf {i} shapes differ: grad "
                         f"{tuple(g.shape)}, param {tuple(shape)}, master "
                         f"{tuple(mw.shape)}, m {tuple(m.shape)}, v "
                         f"{tuple(v.shape)}")
    if not all(t.is_contiguous() for t in (g, p, mw, m, v)):
        raise ValueError(f"adam: leaf {i} is not contiguous (shape "
                         f"{tuple(shape)})")


@torch.no_grad()
def adam_update_(cfg, grads, params, master, m, v, scale, lr, b1c, b2c):
    """One Adam update of every leaf, IN PLACE (``master``, ``m``, ``v``
    and the bf16 ``params``, lists of leaves in one order, ``grads``
    beside them). ``scale`` (the gradient's multiplier), ``lr``, ``b1c``
    (1 - b1^t) and ``b2c`` are 0-d f32 tensors on the leaves' device;
    ``cfg`` gives b1, b2, eps and weight_decay. Every tensor lies on one
    device, or this raises."""
    scalars = (scale, lr, b1c, b2c)
    tensors = [*grads, *params, *master, *m, *v, *scalars]
    dev = tensors[0].device
    if dev.type != "cuda" and all(t.device == dev for t in tensors):
        return adam_plain(cfg, grads, params, master, m, v, *scalars)
    build.on_cuda("adam", *tensors)
    n_leaves = len(params)
    if not len(grads) == len(master) == len(m) == len(v) == n_leaves:
        raise ValueError(f"adam: {len(grads)} grads, {n_leaves} params, "
                         f"{len(master)}/{len(m)}/{len(v)} master/m/v")
    if any(s.dtype != torch.float32 or s.numel() != 1 for s in scalars):
        raise TypeError("adam: scale, lr, b1c and b2c must be one float32 "
                        "each")
    leaf_args = list(zip(grads, params, master, m, v))
    for i, leaf in enumerate(leaf_args):
        _check_leaf(i, *leaf)
    consts = (cfg.b1, 1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps,
              cfg.weight_decay)
    ptrs = [s.data_ptr() for s in scalars]
    lib = build.load("adam", _bind)
    stream = build.stream_of(scale)
    with torch.cuda.device(dev):
        for g, p, mw, mm, vv in leaf_args:
            n = p.numel()
            if n == 0:
                continue
            rc = lib.adam_launch(g.data_ptr(), _GRAD_CODES[g.dtype],
                                 mw.data_ptr(), mm.data_ptr(), vv.data_ptr(),
                                 p.data_ptr(), n, *ptrs, *consts, stream)
            if rc != 0:
                raise RuntimeError(f"adam kernel launch failed on a leaf of "
                                   f"{tuple(p.shape)}: cudaError {rc}")
            adam_update_.launches += 1


adam_update_.launches = 0
