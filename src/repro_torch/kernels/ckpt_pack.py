"""ckpt_pack — checkpoint pack kernels for Hopper (CUDA C++, sm_90a).

Replaces ``repro.kernels.ckpt_pack`` (TPU Pallas): ``ckpt_pack_blocks``
and ``ckpt_pack_dirty_blocks`` both launch the one template in
``csrc/ckpt_pack.cu``. The work is bound by bytes (the dirty pack moves
x, prev and packed once each); the source says how the design follows.

The library is built with ``nvcc`` from the package's own source into
``build/kernels/`` at the repository root on first use and loaded with
``ctypes``. Each wrapper runs its plain PyTorch version
(``repro_torch.kernels.ref``) for CPU tensors only; for a CUDA tensor it
launches the kernel or raises. Each wrapper counts its launches in a
plain integer attribute, ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from repro_torch.kernels.ref import ckpt_pack_dirty_plain, ckpt_pack_plain

DEFAULT_BLOCK = 8 * 1024

SOURCE = Path(__file__).resolve().parent / "csrc" / "ckpt_pack.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIBRARY = BUILD_DIR / "libckpt_pack.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lock = threading.Lock()
_lib = None
#: nvcc's output of the last build (ptxas register / spill report)
build_log = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the ckpt_pack CUDA kernels are "
                           "built on first use and need the CUDA toolkit")
    return path


def build(force: bool = False) -> float:
    """Compile ``csrc/ckpt_pack.cu`` into ``LIBRARY`` (skipped when the
    library is newer than the source, unless ``force``). Returns the
    build's wall seconds (0.0 when skipped). Raises on a failed build."""
    global build_log
    if not force and LIBRARY.exists() \
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f".{LIBRARY.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{build_log}")
    os.replace(tmp, LIBRARY)
    return time.perf_counter() - t0


def _library():
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIBRARY))
            fn = lib.ckpt_pack_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _operand(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dtype not in _CODES:
        raise TypeError(f"ckpt_pack: {what} dtype {t.dtype} not supported "
                        f"(float32, bfloat16, float16)")
    t = t.contiguous()
    if t.data_ptr() % 16:           # 16-byte vector loads
        t = t.clone()
    return t


def _launch(x2d, prev2d, out_dtype, scale, identity: bool):
    """Allocate the outputs and launch the kernel on the current stream
    (no synchronisation). Returns (packed, amax, mask-or-None)."""
    if x2d.device.type != "cuda":
        raise RuntimeError(f"ckpt_pack: tensor on {x2d.device}, expected "
                           f"cuda (plain version runs only on the CPU)")
    n, block = x2d.shape
    if block % 8:
        raise ValueError(f"ckpt_pack: block {block} is not a multiple of 8 "
                         f"elements (16-byte vectors)")
    if out_dtype not in _CODES:
        raise TypeError(f"ckpt_pack: out dtype {out_dtype} not supported")
    x2d = _operand(x2d, "input")
    dev = x2d.device
    y = torch.empty((n, block), dtype=out_dtype, device=dev)
    amax = torch.empty((n,), dtype=torch.float32, device=dev)
    mask = None
    if prev2d is not None:
        prev2d = _operand(prev2d, "prev")
        if prev2d.dtype != out_dtype or prev2d.device != dev:
            raise ValueError(f"ckpt_pack: prev2d is {prev2d.dtype} on "
                             f"{prev2d.device}, expected {out_dtype} on "
                             f"{dev}")
        mask = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return y, amax, mask
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.ckpt_pack_launch(
            x2d.data_ptr(), prev2d.data_ptr() if mask is not None else None,
            y.data_ptr(), amax.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            n, block, _CODES[x2d.dtype], _CODES[out_dtype], int(identity),
            int(mask is not None), float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ckpt_pack kernel launch failed: cudaError {rc}")
    return y, amax, mask


def ckpt_pack_blocks(x2d, *, out_dtype=torch.bfloat16, scale=1.0):
    """x2d (n_blocks, BLOCK) -> (packed (n_blocks, BLOCK) out_dtype,
    amax (n_blocks,) f32) of ``f32(x) * scale``."""
    if x2d.device.type == "cpu":
        return ckpt_pack_plain(x2d, out_dtype=out_dtype, scale=scale)
    packed, amax, _ = _launch(x2d, None, out_dtype, scale, identity=False)
    ckpt_pack_blocks.launches += int(x2d.shape[0] > 0)
    return packed, amax


def ckpt_pack_dirty_blocks(x2d, prev2d, *, out_dtype=torch.bfloat16,
                           scale=1.0):
    """Pack + per-block change mask against a device-resident image.

    prev2d (n_blocks, BLOCK) in ``out_dtype`` is the packed image of the
    previous snapshot. Returns (packed, amax (n_blocks,) f32, mask
    (n_blocks,) int32) with mask[i] = 1 iff block i's packed bits differ
    from prev2d's. ``packed`` is always new storage."""
    if prev2d.shape != x2d.shape:
        raise ValueError(f"prev2d shape {tuple(prev2d.shape)} != "
                         f"{tuple(x2d.shape)}")
    if x2d.device.type == "cpu":
        return ckpt_pack_dirty_plain(x2d, prev2d, out_dtype=out_dtype,
                                     scale=scale)
    identity = out_dtype == x2d.dtype and float(scale) == 1.0
    out = _launch(x2d, prev2d, out_dtype, scale, identity)
    ckpt_pack_dirty_blocks.launches += int(x2d.shape[0] > 0)
    return out


ckpt_pack_blocks.launches = 0
ckpt_pack_dirty_blocks.launches = 0
