"""Paper Fig. 7/13/14: single-rank FastPersist vs baseline across IO
buffer sizes (2–128 MB), single vs double buffering, 16 MB and 512 MB
checkpoints. Reports speedup over the baseline writer (the counterpart
of ``benchmarks/fig7_buffer_sweep.py``).

Extended sweeps: submission queue depth (deep NVMe queues through the
async backend, §4.1) and serialize-arena reuse (first vs steady-state
save staging cost). The buffer and queue sweeps write a host byte
stream (the disk side of a save); the arena sweep snapshots a state
that lives on ``device`` — on the card, the first save lays out and
pins the staging arena, the steady ones copy over PCIe into it."""
import os
import time

import torch

from repro_torch.benchmarks.common import (bench_dir, cleanup, drop_file,
                                           emit, resolve_device, sync,
                                           synth_bytes)
from repro_torch.core import aio
from repro_torch.core.arena import SerializeArena
from repro_torch.core.serializer import ByteStreamView, serialize
from repro_torch.core.writer import WriterConfig, write_stream


def baseline_write(path, data) -> float:
    t0 = time.perf_counter()
    with open(path, "wb", buffering=64 * 1024) as f:
        # torch.save-style: many small buffered writes
        mv = memoryview(data)
        for off in range(0, len(data), 64 * 1024):
            f.write(mv[off:off + 64 * 1024])
        f.flush()
        os.fsync(f.fileno())
    return time.perf_counter() - t0


def _best_write(view, cfg, name) -> float:
    path = os.path.join(bench_dir(), name)
    ts = []
    for _ in range(3):
        stats = write_stream(path, view.slices(0, view.total), view.total,
                             cfg)
        ts.append(stats.seconds)
        drop_file(path)
    return min(ts)


def run(quick=True, device="cuda"):
    device = resolve_device(device)
    results = {}
    ckpt_sizes = [16, 512] if not quick else [16, 128]
    buf_sizes = [2, 8, 32, 128] if quick else [2, 4, 8, 16, 32, 64, 128]
    for ck_mb in ckpt_sizes:
        data = synth_bytes(ck_mb, seed=ck_mb)
        view = ByteStreamView([data])
        bpath = os.path.join(bench_dir(), "f7_base.bin")
        tb = min(baseline_write(bpath, data) for _ in range(3))
        drop_file(bpath)
        base_gbps = len(data) / tb / 1e9
        emit(f"fig7/base_{ck_mb}MB", tb, f"{base_gbps:.2f}GBps")
        for double in (False, True):
            mode = "double" if double else "single"
            for buf_mb in buf_sizes:
                t = _best_write(view, WriterConfig(
                    io_buffer_size=buf_mb * 2**20, double_buffer=double),
                    "f7.bin")
                sp = tb / t
                results[(ck_mb, mode, buf_mb)] = sp
                emit(f"fig7/{mode}_{ck_mb}MB_buf{buf_mb}MB", t,
                     f"{sp:.2f}x_vs_baseline")

    # --- queue-depth sweep: in-flight writes via the async backend ----
    ck_mb = ckpt_sizes[-1]
    data = synth_bytes(ck_mb, seed=ck_mb)
    view = ByteStreamView([data])
    backend = aio.resolve_backend("auto")
    for qd in ([1, 2, 8] if quick else [1, 2, 4, 8, 16]):
        t = _best_write(view, WriterConfig(io_buffer_size=8 * 2**20,
                                           queue_depth=qd), "f7qd.bin")
        results[(ck_mb, f"qd{qd}", backend)] = view.total / t / 1e9
        emit(f"fig7/qd{qd}_{backend}_{ck_mb}MB", t,
             f"{view.total/t/1e9:.2f}GBps")

    # --- arena-reuse sweep: first save allocates, steady state fills --
    n = ck_mb * 2**20 // 8
    state = {"w": torch.arange(n, dtype=torch.float32, device=device),
             "m": torch.ones(n, device=device)}
    sync(device)
    arena = SerializeArena()
    t0 = time.perf_counter()
    serialize(state, arena=arena)
    t_first = time.perf_counter() - t0
    t_steady = []
    for _ in range(3):
        state["w"] = state["w"] + 1.0
        sync(device)
        t0 = time.perf_counter()
        serialize(state, arena=arena)
        t_steady.append(time.perf_counter() - t0)
    t_s = min(t_steady)
    results[(ck_mb, "arena", "reuse")] = t_first / max(t_s, 1e-12)
    emit(f"fig7/arena_first_{ck_mb}MB", t_first,
         f"alloc+copy_{arena.n_alloc}allocs")
    emit(f"fig7/arena_steady_{ck_mb}MB", t_s,
         f"{t_first/max(t_s,1e-12):.2f}x_vs_first_{arena.n_reuse}reuses")
    return results


if __name__ == "__main__":
    run()
    cleanup()
