"""§Perf hillclimb 3 — the FastPersist write path on THIS machine's disk
(the counterpart of ``benchmarks/perf_writer.py``).

Hypothesis → change → measure → confirm/refute, recorded to
``experiments/torch/perf_writer.json``. Durability-honest: every config
is measured with fsync included (page-cache-only writes are not
persisted checkpoints — the exact failure mode the paper's §3.2
criticises in snapshot-based systems). The raw-writer legs write a host
byte stream; the engine and arena legs save a state that lives on
``device`` (on the card: device → pinned arena → disk). Quick runs on
the card write ``CARD_QUICK_MB`` (the reference's 384 MiB took 42 s on
an H100 host's disk, too long for the smoke run)."""
import dataclasses
import os
import shutil
import tempfile
import time

import torch

from repro_torch.benchmarks.common import (bench_dir, cleanup,
                                           resolve_device, save_json, sync,
                                           synth_bytes)
from repro_torch.core import aio
from repro_torch.core.serializer import ByteStreamView
from repro_torch.core.writer import WriterConfig, write_stream

#: the stream size of a quick run on the card, MiB (384 elsewhere)
CARD_QUICK_MB = 128


def stripe_roots():
    """The volume roots on the most DISTINCT backing stores available —
    the whole point of striping is aggregating devices, so prefer
    genuinely separate mounts: $FASTPERSIST_VOLUME_DIRS (comma-separated,
    one per real SSD) > bench dir + /dev/shm > the bench dir alone
    (striping degenerates to directory spreading on one device)."""
    env = os.environ.get("FASTPERSIST_VOLUME_DIRS")
    if env:
        return env.split(",")
    if os.access("/dev/shm", os.W_OK):
        return [bench_dir(), "/dev/shm"]
    return [bench_dir()]


def stripe_volumes(n):
    """n volume directories spread over :func:`stripe_roots`, each a new
    directory of its own (``mkdtemp``), so runs at the same time never
    share or delete one another's volume. The caller removes them."""
    roots = stripe_roots()
    return [tempfile.mkdtemp(prefix=f"fp_vol{i}_",
                             dir=roots[i % len(roots)]) for i in range(n)]


def device_blob(mb, seed, device) -> torch.Tensor:
    """``synth_bytes(mb, seed)`` as a uint8 tensor on ``device``."""
    return torch.from_numpy(synth_bytes(mb, seed=seed)).to(device)


def timed_engine_save(mb, writer_cfg, device, iters=3, dp=1, n_volumes=1):
    """Full-stack save through CheckpointEngine ("fastpersist" backend):
    snapshot + staged write + fsynced COMMIT + atomic rename — with
    ``dp`` parallel writers striped across ``n_volumes`` volume roots.
    Returns (gbps, commit_seconds) — quantifies what crash-atomicity
    costs on top of the raw write path, and what striping buys."""
    from repro_torch.core.checkpointer import FastPersistConfig
    from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
    from repro_torch.core.partition import Topology

    d = os.path.join(bench_dir(), "perf_engine")
    vols = stripe_volumes(n_volumes) if n_volumes > 1 else None
    state = {"blob": device_blob(mb, 3, device)}
    sync(device)
    best, commit_s = float("inf"), 0.0
    fp = FastPersistConfig(
        strategy="replica", topology=Topology(dp_degree=dp),
        writer=dataclasses.replace(writer_cfg, checksum=False))
    try:
        with CheckpointEngine(CheckpointSpec(
                directory=d, backend="fastpersist", volumes=vols,
                fp=fp)) as eng:
            for i in range(iters):
                t0 = time.perf_counter()
                stats = eng.save(state, i).result()
                dt = time.perf_counter() - t0
                if dt < best:
                    best, commit_s = dt, stats.commit_seconds
    finally:
        shutil.rmtree(d, ignore_errors=True)
        for v in vols or []:
            shutil.rmtree(v, ignore_errors=True)
    total = int(mb * 2**20)
    return total / best / 1e9, commit_s


def timed_write(view, cfg, fsync=True, iters=3):
    path = os.path.join(bench_dir(), "perf_writer.bin")
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        write_stream(path, view.slices(0, view.total), view.total, cfg)
        if fsync:
            fd = os.open(path, os.O_WRONLY)
            os.fsync(fd)
            os.close(fd)
        best = min(best, time.perf_counter() - t0)
        os.remove(path)
    return view.total / best / 1e9


def run(quick=True, mb=None, device="cuda"):
    device = resolve_device(device)
    if mb is None:
        mb = CARD_QUICK_MB if quick and device.type == "cuda" else 384
    data = synth_bytes(mb, seed=3)
    view = ByteStreamView([data])
    log = []

    def record(name, hypothesis, gbps, verdict):
        log.append({"iteration": name, "hypothesis": hypothesis,
                    "gbps": round(gbps, 3), "verdict": verdict})
        print(f"perf_writer/{name},{view.total/max(gbps, 1e-9)/1e9*1e6:.1f},"
              f"{gbps:.2f}GBps_{verdict}", flush=True)

    # iteration 0: paper-faithful defaults (32MB buffer, double, direct)
    base = timed_write(view, WriterConfig())
    record("it0_baseline_32MB_double_direct", "paper defaults", base,
           "baseline")

    # H1: on a 1-core host, double buffering cannot overlap the fill
    #     memcpy with pwrite — single buffer should be ~equal.
    single = timed_write(view, WriterConfig(double_buffer=False))
    v = "confirmed" if abs(single - base) / base < 0.15 else "refuted"
    record("it1_single_buffer", "1 core ⇒ no overlap benefit", single, v)

    # H2: small (4MB) staging buffers stay in LLC ⇒ cheaper fill phase.
    small = timed_write(view, WriterConfig(io_buffer_size=4 * 2**20))
    v = "confirmed" if small > base * 1.05 else "refuted"
    record("it2_buffer_4MB", "LLC-resident staging buffer", small, v)

    big = timed_write(view, WriterConfig(io_buffer_size=128 * 2**20))
    record("it2b_buffer_128MB", "large buffers amortize syscalls", big,
           "confirmed" if big > base * 1.05 else "refuted")

    # H3: with durability (fsync) included, O_DIRECT ≥ buffered I/O
    #     (buffered pays a page-cache copy then flushes the same bytes).
    buffered = timed_write(view, WriterConfig(use_direct=False))
    direct = timed_write(view, WriterConfig(use_direct=True))
    v = "confirmed" if direct >= buffered * 0.95 else "refuted"
    record("it3_direct_vs_buffered",
           "durable writes: direct avoids page-cache copy",
           direct / max(buffered, 1e-9), v)

    # H4: the engine's crash-atomic commit (COMMIT marker + fsync +
    #     rename) is metadata-only ⇒ <10% overhead on a ~384MB save.
    eng_gbps, commit_s = timed_engine_save(mb, WriterConfig(), device)
    v = "confirmed" if eng_gbps > base * 0.9 else "refuted"
    record("it4_engine_atomic_commit",
           f"commit protocol is cheap (commit={commit_s*1e3:.1f}ms)",
           eng_gbps, v)

    # H5: sharded multi-volume layout — the SAME 4 writers, striped over
    #     2 volume roots, beat the single-volume save. os.sync()
    #     quiesces dirty pages so neither config pays for the other's
    #     writeback.
    os.sync()
    single_vol, _ = timed_engine_save(mb, WriterConfig(), device, dp=4,
                                      n_volumes=1)
    os.sync()
    multi_vol, _ = timed_engine_save(mb, WriterConfig(), device, dp=4,
                                     n_volumes=2)
    v = "confirmed" if multi_vol > single_vol else "refuted"
    mounts = ",".join(sorted(set(stripe_roots()[:2])))
    record("it5_multi_volume_stripe",
           f"4 writers x 2 volumes [{mounts}] aggregate distinct stores "
           f"> 4 x 1 ({single_vol:.2f} GBps base)", multi_vol, v)

    # H6: async-submission backends (io_uring > libaio > pwrite) with
    #     queue depth > 1 exercise deep NVMe queues. Every available
    #     backend is swept so the fastest is measured, not assumed.
    for backend in aio.BACKENDS:
        if not aio.backend_available(backend):
            record(f"it6_{backend}", "backend unavailable on this kernel",
                   0.0, "skipped")
            continue
        for qd in (1, 4, 16):
            g = timed_write(view, WriterConfig(backend=backend,
                                               queue_depth=qd,
                                               io_buffer_size=8 * 2**20))
            v = "confirmed" if g > base * 0.9 else "refuted"
            record(f"it6_{backend}_qd{qd}",
                   f"{backend} qd={qd} sustains the §4.1 path", g, v)

    # H7: the staging arena makes steady-state serialization cheaper
    #     than the first save (no host-buffer allocation or pinning) —
    #     the DataStates-LLM lazy-pinned-buffer effect. Measured through
    #     the REAL save path of a state on ``device``; also proves
    #     (load+verify) that the fill-phase crc round-trips.
    from repro_torch.core.checkpointer import (FastPersistCheckpointer,
                                               FastPersistConfig)
    d7 = os.path.join(bench_dir(), "perf_arena")
    ck = FastPersistCheckpointer(d7, FastPersistConfig(
        strategy="replica", writer=WriterConfig()))
    n = int(mb * 2**20 // 8)
    state = {"w": torch.arange(n, dtype=torch.float32, device=device),
             "m": torch.ones(n, device=device)}
    sync(device)
    s_first = ck.save(state, 0)
    state["w"] = state["w"] * 1.5          # param update, same shapes
    sync(device)
    s_steady = ck.save(state, 1)
    restored, _ = ck.load(1, verify=True)  # crc-verified round-trip
    ok = (s_steady.arena_reused and not s_first.arena_reused
          and s_steady.serialize_seconds < s_first.serialize_seconds
          and torch.equal(restored["w"].to(device), state["w"]))
    speedup = s_first.serialize_seconds / max(s_steady.serialize_seconds,
                                              1e-12)
    record("it7_arena_steady_state",
           f"arena reuse: serialize {s_first.serialize_seconds*1e3:.1f}ms"
           f"->{s_steady.serialize_seconds*1e3:.1f}ms "
           f"({speedup:.2f}x), crc-verified load ok",
           view.total / max(s_steady.serialize_seconds, 1e-12) / 1e9,
           "confirmed" if ok else "refuted")
    del restored, state
    shutil.rmtree(d7, ignore_errors=True)

    # H8: folding CRC into the fill phase (accumulated over LLC-resident
    #     4MB staging buffers, hot from the copy) costs less than a
    #     second full sweep over the cold stream after the write.
    crc_cfg = WriterConfig(checksum=True, io_buffer_size=4 * 2**20)
    t_fold, t_sweep = float("inf"), float("inf")
    for _ in range(3):
        st_crc = write_stream(os.path.join(bench_dir(), "crc.bin"),
                              view.slices(0, view.total), view.total,
                              crc_cfg)
        t_fold = min(t_fold, st_crc.crc_seconds)
        os.remove(os.path.join(bench_dir(), "crc.bin"))
        t0 = time.perf_counter()
        sweep_crc = view.crc32()
        t_sweep = min(t_sweep, time.perf_counter() - t0)
        if st_crc.crc32 != sweep_crc:
            raise AssertionError("fill-phase crc != sweep crc")
    v = "confirmed" if t_fold < t_sweep else "refuted"
    record("it8_single_pass_crc",
           f"fill-phase crc {t_fold*1e3:.1f}ms < "
           f"post-write sweep {t_sweep*1e3:.1f}ms",
           view.total / max(t_fold, 1e-12) / 1e9, v)

    # pick the best config found
    configs = {
        "32MB_double": base, "32MB_single": single, "4MB_double": small,
        "128MB_double": big,
    }
    best = max(configs, key=configs.get)
    record("final_best", f"best={best}", configs[best], "selected")

    save_json("perf_writer", log)
    return log


if __name__ == "__main__":
    run()
    cleanup()
