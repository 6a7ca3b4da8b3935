"""Parallel restore sweep (the restore-side twin of fig8; the
counterpart of ``benchmarks/fig10_parallel_restore.py``): readers ×
io-backend × queue-depth against one sharded checkpoint, vs the legacy
single-reader ``engine.load()``, every restore placed on ``device``.

The paper's §4.2 restore is load-then-allgather: every DP rank reads
only its owned spans, in parallel, through the async read backends.
Recovery latency bounds fault-tolerance MTTR, so this figure answers
the question the write-side figures leave open: once checkpoints are
cheap to WRITE every iteration, how fast can training come BACK from
one? Rows are persisted to ``experiments/torch/fig10.json``."""
import os
import shutil
import time

import torch

from repro_torch.benchmarks.common import (bench_dir, cleanup, emit,
                                           resolve_device, save_json, sync,
                                           synth_bytes)
from repro_torch.core import aio
from repro_torch.core.checkpointer import FastPersistConfig
from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
from repro_torch.core.partition import Topology
from repro_torch.core.writer import WriterConfig

#: the small record that crosses shard boundaries (f32 elements)
HEAD = 977


def make_state(mb, device) -> dict:
    """The figure's state on ``device``: the reference's ``blob`` bytes
    (``synth_bytes(mb, seed=10)``) and a 977-element f32 ``head``."""
    return {"blob": torch.from_numpy(synth_bytes(mb, seed=10)).to(device),
            "head": torch.arange(HEAD, dtype=torch.float32, device=device)}


def make_spec(d, writers) -> CheckpointSpec:
    """One (writers × 2 volumes) sharded checkpoint layout under ``d``."""
    return CheckpointSpec(
        directory=os.path.join(d, "prim"), backend="fastpersist",
        volumes=[os.path.join(d, "vol0"), os.path.join(d, "vol1")],
        fp=FastPersistConfig(strategy="replica",
                             topology=Topology(dp_degree=writers)))


def same(restored, state) -> bool:
    return all(torch.equal(restored[k], state[k]) for k in state)


def run(quick=True, mb=256, smoke=False, device="cuda"):
    """Build one (writers × volumes) checkpoint, then sweep restore
    configurations over it. ``smoke=True`` shrinks the sweep to a
    2-reader round-trip check (the CI leg)."""
    device = resolve_device(device)
    writers = 4 if quick else 8
    d = os.path.join(bench_dir(), "f10")
    state = make_state(mb, device)
    sync(device)
    total = int(mb * 2**20) + HEAD * 4
    out = {}
    spec = make_spec(d, writers)
    with CheckpointEngine(spec) as eng:
        eng.save(state, 0).result()

        def timed_load(iters=2, **kw):
            best = float("inf")
            for _ in range(iters):
                t0 = time.perf_counter()
                restored, _ = eng.load(0, device=device, **kw)
                sync(device)
                best = min(best, time.perf_counter() - t0)
            return best, restored

        if smoke:
            _, restored = timed_load(iters=1, parallel=2)
            ok = same(restored, state)
            out["roundtrip_ok"] = bool(ok)
            emit("fig10/smoke_2readers", 0.0, "ok" if ok else "MISMATCH")
            shutil.rmtree(d, ignore_errors=True)
            return out

        t_single, _ = timed_load()
        out["single_reader"] = round(total / t_single / 1e9, 3)
        emit("fig10/single_reader", t_single,
             f"{out['single_reader']:.2f}GBps")

        readers = [1, 2, 4] if quick else [1, 2, 4, 8]
        qds = [2, 8] if quick else [1, 4, 16]
        backends = [b for b in aio.BACKENDS if aio.backend_available(b)]
        base_writer = spec.fp.writer
        try:
            for backend in backends:
                for qd in qds:
                    # the reader reuses the WriterConfig tuning surface
                    spec.fp.writer = WriterConfig(backend=backend,
                                                  queue_depth=qd,
                                                  io_buffer_size=8 * 2**20)
                    for r in readers:
                        t, restored = timed_load(parallel=r)
                        key = f"r{r}_{backend}_qd{qd}"
                        out[key] = round(total / t / 1e9, 3)
                        emit(f"fig10/{key}", t, f"{out[key]:.2f}GBps")
        finally:
            spec.fp.writer = base_writer

        # the acceptance check: ≥4 parallel readers beat the legacy
        # single-reader load on the same checkpoint
        best4 = max((v for k, v in out.items()
                     if k.startswith("r4_") or k.startswith("r8_")),
                    default=0.0)
        out["speedup_4readers_vs_single"] = round(
            best4 / max(out["single_reader"], 1e-9), 2)
        emit("fig10/speedup_4readers_vs_single", 0.0,
             f"{out['speedup_4readers_vs_single']:.2f}x")

        # the fastest config round-trips bit-identically
        _, restored = timed_load(iters=1, parallel=4)
        out["roundtrip_ok"] = bool(same(restored, state))
    shutil.rmtree(d, ignore_errors=True)
    save_json("fig10", out)
    return out


if __name__ == "__main__":
    run()
    cleanup()
