"""Shared benchmark utilities (the counterpart of ``benchmarks.common``).
Every benchmark prints CSV rows ``name,us_per_call,derived`` (derived =
the paper-figure quantity).

State that a checkpoint saves lives on ``device`` (``cuda`` unless the
caller asks for ``cpu``) and is drawn there from a seed
(:func:`synth_state`); raw byte streams for the disk-side figures come
from :func:`synth_bytes` on the host, as in the reference."""
from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from repro_torch.core.serializer import ByteStreamView
from repro_torch.core.writer import WriterConfig, write_stream
from repro_torch.train.trainer import resolve_device

#: scratch root of the figures; ``FASTPERSIST_BENCH_DIR`` overrides it
#: (read at each call, so a caller may set it after import)
BENCH_DIR = os.path.join(os.getcwd(), ".bench_tmp")
#: where the figures persist their rows (the reference writes
#: ``experiments/<figure>.json``; the port's rows never overwrite those)
EXPERIMENTS = os.path.join("experiments", "torch")

__all__ = ["BENCH_DIR", "EXPERIMENTS", "bench_dir", "cleanup",
           "drop_file", "emit", "measure_peak_write_gbps",
           "resolve_device", "save_json", "sync", "synth_bytes",
           "synth_state", "timeit"]


def _root() -> str:
    return os.environ.get("FASTPERSIST_BENCH_DIR", BENCH_DIR)


def bench_dir():
    os.makedirs(_root(), exist_ok=True)
    return _root()


def cleanup():
    shutil.rmtree(_root(), ignore_errors=True)


def synth_bytes(mb: float, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, size=int(mb * 2**20), dtype=np.uint8)


def synth_state(mb: float, device, seed: int = 0,
                n: int | None = None) -> dict:
    """A training state of ``mb`` MiB (14 bytes a parameter) drawn on
    ``device`` from ``seed``, with the reference's leaf names and dtypes
    (benchmarks/fig9_dense_models.py): ``p`` bf16 params, ``mw`` f32
    master weights, ``m`` zero and ``v`` one Adam moments. ``n`` gives
    the element count exactly (``mb`` is then ignored)."""
    device = torch.device(device)
    if n is None:
        n = max(int(mb * 2**20) // 14, 1)
    g = torch.Generator(device=device).manual_seed(seed)
    return {"p": torch.randn(n, generator=g, device=device,
                             dtype=torch.bfloat16),
            "mw": torch.randn(n, generator=g, device=device),
            "m": torch.zeros(n, device=device),
            "v": torch.ones(n, device=device)}


def sync(device):
    """Wait for the work queued on ``device`` (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def drop_file(path):
    try:
        os.remove(path)
    except OSError:
        pass


def measure_peak_write_gbps(mb: int = 256) -> float:
    """This machine's peak sequential write bandwidth (the '24.8 GB/s'
    analogue): one big aligned direct write."""
    data = synth_bytes(mb)
    view = ByteStreamView([data])
    path = os.path.join(bench_dir(), "peak.bin")
    best = 0.0
    for _ in range(3):
        stats = write_stream(path, view.slices(0, view.total), view.total,
                             WriterConfig(io_buffer_size=64 * 2**20,
                                          double_buffer=True))
        best = max(best, stats.gbps)
        drop_file(path)
    return best


def emit(name: str, seconds: float, derived: str):
    print(f"{name},{seconds*1e6:.1f},{derived}", flush=True)


def save_json(name: str, obj) -> str:
    """Write ``obj`` to ``experiments/torch/<name>.json`` (relative to
    the working directory, as the reference's figures do)."""
    import json
    os.makedirs(EXPERIMENTS, exist_ok=True)
    path = os.path.join(EXPERIMENTS, f"{name}.json")
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
    return path


def timeit(fn, warmup=1, iters=3):
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))
