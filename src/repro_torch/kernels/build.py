"""Build and load the port's CUDA kernels (``csrc/<name>.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, ``build/kernels/lib<name>.so`` at the
repository root, on first use, and loaded with ``ctypes``. ``build``
starts one ``nvcc`` per source, all at once, and waits for them all.
Nothing here runs at import: this module imports on a machine without
the CUDA toolkit (the CPU tests), and only a launch on a CUDA tensor
builds.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: every CUDA source of the port, by library name
NAMES = ("adam", "ckpt_pack", "flash_attention", "ssd_scan")
#: ``-split-compile=0``: the optimizer's passes on all cores; the same SASS
#: (flash_attention.cu on an H100 machine with CUDA 12.9: 25.7 s -> 13.6 s)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-split-compile=0",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
#: nvcc's output of the last build of each library (ptxas register /
#: shared-memory / spill report)
build_log: dict = {}


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on first use and need the CUDA toolkit")
    return path


def _fresh(name: str) -> bool:
    lib = library_path(name)
    return lib.exists() and lib.stat().st_mtime >= source(name).stat().st_mtime


def build(names=NAMES, force: bool = False) -> dict:
    """Compile each named source whose library is missing or older than
    the source (every one with ``force``), one ``nvcc`` per source, in
    parallel. Returns {name: wall seconds} of the builds run. Raises on
    any failed build, with nvcc's output."""
    todo = [n for n in names if force or not _fresh(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_name(f".lib{n}.so.{os.getpid()}.tmp")
        procs[n] = (tmp, time.perf_counter(), subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(n))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    secs, failed = {}, []
    for n, (tmp, t0, proc) in procs.items():
        build_log[n] = proc.communicate()[0]
        secs[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(n)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(
            f"{source(n)}:\n{build_log[n]}" for n in failed))
    return secs


def load(name: str, bind) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so`` (built first if needed);
    ``bind(lib)`` declares its functions' argtypes/restype once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            bind(lib)
            _libs[name] = lib
        return lib


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def on_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor lies on the same CUDA device: a wrapper
    runs its plain version for CPU tensors only, and anything else must
    launch the kernel or raise."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: tensor on {dev}, expected cuda (plain "
                           f"version runs only on the CPU)")
    for t in tensors[1:]:
        if t.device != dev:
            raise RuntimeError(f"{name}: tensors on {dev} and {t.device}")
