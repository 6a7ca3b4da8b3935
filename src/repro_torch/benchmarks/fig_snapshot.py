"""Chunked device→arena snapshots + device-side dirty masks
(DESIGN.md §10): step-boundary stall and device→host traffic (the
counterpart of ``benchmarks/fig_snapshot.py``).

Two sweeps, one per §10 leg:

  * **chunk-size sweep** — the §4.3 training cadence (submit after the
    optimizer, compute the next iteration, sync before the next
    optimizer) against an async engine, monolithic snapshot vs chunked.
    The measured quantity is the *step-boundary stall*: main-thread time
    blocked in ``save()`` (the commit throttle) plus ``wait_snapshot()``
    (the donation gate). ``stall_x`` (monolithic over chunked, at the
    default 8 MiB chunk) is the headline; >= 2x is the bar. On
    ``cuda`` the blob is a tensor on the card and the device→host leg is
    the real PCIe copy into the pinned arena. On ``cpu`` there is no
    link to overlap, so the leg runs behind an emulated one
    (:func:`_emu_device_blob`) calibrated to the measured disk rate, as
    in the reference.
  * **dirty-fraction sweep** — delta chains over a float32 blob on
    ``device`` with the change-mask kernel (``device_dirty``: the
    ckpt_pack_dirty_blocks kernel on the card) vs the host byte
    compare. ``pcie_x`` = device→host bytes of the delta saves over the
    bytes actually dirtied; the masks ride along, so <= 1.2x at 1% dirty
    is the bar (the host compare moves the WHOLE stream every save).
    Bit-exact restores are checked per cell.

Rows are persisted to ``experiments/torch/fig_snapshot.json``."""
import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import (bench_dir, cleanup, emit,
                                           resolve_device, save_json, sync)
from repro_torch.core.checkpointer import FastPersistConfig
from repro_torch.core.engine import CheckpointEngine, CheckpointSpec

PAGE = 4096
#: the dirty sweep's blob in a quick run, MiB
QUICK_DIRTY_MB = 8


def _spec(d, chunk_mb, **fp_kw):
    return CheckpointSpec(
        directory=d, backend="fastpersist-pipelined",
        fp=FastPersistConfig(strategy="replica",
                             snapshot_chunk_mb=chunk_mb, **fp_kw))


class _EmuLink(torch.Tensor):
    """A CPU tensor behind an emulated device→host link (``device="cpu"``
    only). A "D2H copy" on a CPU host is a plain memcpy at memory-bus
    speed while the disk writes far slower — a copy:write ratio the
    paper's hardware never sees — so there would be nothing for the
    chunk pipeline to overlap. Every slice of this tensor (the arena
    reads a record piece by piece through slices) charges its transfer
    time at ``rate`` bytes/s as a GIL-released sleep, the CPU as free as
    behind a DMA engine. Views and copies made from it stay metered."""

    rate = 1e9

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        out = super().__torch_function__(func, types, args, kwargs)
        if func is torch.Tensor.__getitem__ and isinstance(out,
                                                           torch.Tensor):
            time.sleep(out.numel() * out.element_size() / cls.rate)
        return out


def _emu_device_blob(host: torch.Tensor, rate: float) -> torch.Tensor:
    """``host`` (same storage) as an :class:`_EmuLink` of ``rate``."""
    link = type("_EmuDeviceBlob", (_EmuLink,), {"rate": float(rate)})
    return host.as_subclass(link)


def _raw(t: torch.Tensor) -> torch.Tensor:
    """The plain tensor behind an emulated blob (mutations and compares
    go through it: the link meters only the engine's reads)."""
    return t.as_subclass(torch.Tensor)


def _stall_loop(d, chunk_mb, state, steps, compute_s, device):
    """§4.3 cadence; returns median per-step stall seconds (submit
    throttle + snapshot gate) and the final-restore check."""
    shutil.rmtree(d, ignore_errors=True)
    raw = _raw(state["blob"])
    stalls = []
    with CheckpointEngine(_spec(d, chunk_mb)) as eng:
        eng.save(state, 0).wait()           # prime arena + plan cache
        for step in range(1, steps + 1):
            # mutate first (the optimizer step) — the previous
            # iteration's wait_snapshot made this safe
            raw[step % raw.numel()] ^= 0x5A
            sync(device)
            t0 = time.perf_counter()
            eng.save(state, step)           # blocks on previous commit
            t1 = time.perf_counter()
            time.sleep(compute_s)           # next iteration's fwd+bwd
            t2 = time.perf_counter()
            eng.wait_snapshot()             # donation gate (§10)
            t3 = time.perf_counter()
            stalls.append((t1 - t0) + (t3 - t2))
        eng.wait()
        restored, _ = eng.load(steps, like=state, device=device)
        ok = all(torch.equal(restored[k], _raw(state[k])) for k in state)
    shutil.rmtree(d, ignore_errors=True)
    return float(np.median(stalls)), ok


def _stall_sweep(d, chunks, state, steps, compute_s, reps, device):
    """Round-robin the chunk cells ``reps`` times and take per-cell
    medians: writeback debt accumulates over a run on a real disk, so
    every cell must sample every phase of the drift. ``os.sync()``
    before each loop drains the debt the previous loop left behind."""
    stalls = {c: [] for c in chunks}
    oks = {c: True for c in chunks}
    for _rep in range(reps):
        for chunk_mb in chunks:
            os.sync()
            s, ok = _stall_loop(os.path.join(d, f"c{chunk_mb}"), chunk_mb,
                                state, steps, compute_s, device)
            stalls[chunk_mb].append(s)
            oks[chunk_mb] = oks[chunk_mb] and ok
    return ({c: float(np.median(v)) for c, v in stalls.items()}, oks)


def _touch_pages(w, rng, dirty_frac):
    """Add 1.0 to ``dirty_frac`` of the blob's 4 KiB pages in place (the
    reference's draw from ``rng``); returns the bytes dirtied."""
    pages = w.numel() * 4 // PAGE
    n = max(1, int(pages * dirty_frac))
    idx = rng.choice(pages, size=n, replace=False)
    rows = w.view(pages, PAGE // 4)
    rows[torch.from_numpy(idx).to(w.device)] += 1.0
    return n * PAGE


def _pcie_loop(d, device_dirty, mb, steps, dirty_frac, device):
    """Delta chain over a float32 blob on ``device``; returns (delta d2h
    bytes, dirtied bytes, keyframe d2h bytes, bit-exact)."""
    shutil.rmtree(d, ignore_errors=True)
    rng = np.random.default_rng(23)
    w = torch.from_numpy(
        rng.standard_normal(mb * (1 << 20) // 4).astype(np.float32)
    ).to(device)
    state = {"w": w, "ctr": torch.zeros(1, dtype=torch.int32,
                                        device=device)}
    d2h_delta, dirty_bytes = 0, 0
    with CheckpointEngine(_spec(d, 8, keyframe_every=steps + 2,
                                device_dirty=device_dirty)) as eng:
        kf = eng.save(state, 0).wait()      # keyframe: full D2H
        for step in range(1, steps + 1):
            dirty_bytes += _touch_pages(w, rng, dirty_frac)
            state["ctr"] += 1
            dirty_bytes += state["ctr"].numel() * 4
            sync(device)
            st = eng.save(state, step).wait()
            if st.delta is None:
                raise AssertionError("delta chain broke")
            d2h_delta += st.d2h_bytes
        restored, _ = eng.load(steps, like=state, device=device)
        ok = all(torch.equal(restored[k], state[k]) for k in state)
    shutil.rmtree(d, ignore_errors=True)
    return d2h_delta, dirty_bytes, kf.d2h_bytes, ok


def _calibrate(d, blob, ctr, device):
    """Steady-state prime saves of the stall state: (copy s, write s,
    emulated link rate or None). On ``cpu`` the link is rated so copy ≈
    write and the prime repeated behind it; on ``cuda`` the copy is the
    real device→host snapshot."""
    state = {"blob": blob, "step_ctr": ctr}
    os.sync()
    memcpys, writes = [], []
    with CheckpointEngine(_spec(os.path.join(d, "prime"), 0)) as eng:
        eng.save(state, 0).wait()           # cold: layout + allocation
        for i in range(1, 4):               # warm arena = steady state
            blob[i] ^= 1
            sync(device)
            pst = eng.save(state, i).wait()
            memcpys.append(pst.serialize_seconds)
            writes.append(pst.seconds)
    shutil.rmtree(os.path.join(d, "prime"), ignore_errors=True)
    memcpy_s, write_s = float(np.median(memcpys)), float(np.median(writes))
    if device.type == "cuda":
        return memcpy_s, write_s, None, state
    rate = blob.numel() / max(write_s - memcpy_s, 1e-3)
    state = {"blob": _emu_device_blob(blob, rate), "step_ctr": ctr}
    copies = []
    with CheckpointEngine(_spec(os.path.join(d, "prime"), 0)) as eng:
        eng.save(state, 0).wait()
        for i in range(1, 3):               # measured copy incl. link
            blob[i] ^= 1
            copies.append(eng.save(state, i).wait().serialize_seconds)
    shutil.rmtree(os.path.join(d, "prime"), ignore_errors=True)
    return float(np.median(copies)), write_s, rate, state


def run(quick=True, mb=32, smoke=False, device="cuda"):
    device = resolve_device(device)
    steps = 3 if smoke else (6 if quick else 10)
    if smoke:
        mb = min(mb, 8)
    # quick runs cap the dirty sweep's blob (the pcie_x ratio is
    # size-independent: mask overhead over dirty bytes); the stall
    # sweep keeps the full size
    dirty_mb = min(mb, QUICK_DIRTY_MB) if quick else mb
    # the stall sweep runs bigger: millisecond-scale per-save times for
    # a small state collapse into scheduler noise
    stall_mb = mb if smoke else mb * 4
    d = os.path.join(bench_dir(), "fsnap")
    out = {"mb": mb, "stall_mb": stall_mb, "dirty_mb": dirty_mb,
           "steps": steps, "chunk_cells": [], "dirty_cells": []}

    # ---- chunk-size sweep: step-boundary stall vs monolithic --------
    g = torch.Generator(device=device).manual_seed(0)
    blob = torch.randint(0, 256, (stall_mb << 20,), generator=g,
                         dtype=torch.uint8, device=device)
    ctr = torch.zeros(1, dtype=torch.int64, device=device)
    # the compute window sits at Eq. 1's boundary: the OVERLAPPED save
    # (max(copy, write)) fits inside fwd+bwd, the serial one
    # (copy + write) does not
    copy_s, write_s, rate, state = _calibrate(d, blob, ctr, device)
    compute_s = max(copy_s, write_s) + 0.25 * min(copy_s, write_s)
    out["compute_window_ms"] = round(compute_s * 1e3, 3)
    out["prime_copy_ms"] = round(copy_s * 1e3, 3)
    out["prime_write_ms"] = round(write_s * 1e3, 3)
    out["emu_link_gbps"] = None if rate is None else round(rate / 1e9, 3)

    chunks = [0, 2] if smoke else ([0, 2, 8] if quick else [0, 1, 2, 4, 8,
                                                            16])
    reps = 1 if smoke else (3 if quick else 5)
    medians, oks = _stall_sweep(os.path.join(d, "stall"), chunks, state,
                                steps, compute_s, reps, device)
    del state, blob
    stall_mono = medians[0]
    for chunk_mb in chunks:
        stall, ok = medians[chunk_mb], oks[chunk_mb]
        cell = {"chunk_mb": chunk_mb, "stall_ms": round(stall * 1e3, 3),
                "ok": bool(ok)}
        if chunk_mb != 0:
            cell["stall_x"] = round(stall_mono / max(stall, 1e-6), 2)
        emit(f"fig_snapshot/chunk{chunk_mb}", stall,
             f"{cell.get('stall_x', 1.0)}x_stall,ok={ok}")
        out["chunk_cells"].append(cell)

    # ---- dirty-fraction sweep: PCIe bytes, device masks vs host -----
    fracs = [0.01] if smoke else [0.01, 0.1]
    for frac in fracs:
        dd, dirty, kf_d2h, ok_dev = _pcie_loop(
            os.path.join(d, f"dev{frac}"), True, dirty_mb, steps, frac,
            device)
        hd, _, _, ok_host = _pcie_loop(
            os.path.join(d, f"host{frac}"), False, dirty_mb, steps, frac,
            device)
        cell = {"dirty_frac": frac,
                "d2h_device": dd, "d2h_host": hd,
                "dirty_bytes": dirty,
                "pcie_x": round(dd / max(dirty, 1), 3),
                "host_x": round(hd / max(dirty, 1), 2),
                "ok": bool(ok_dev and ok_host)}
        emit(f"fig_snapshot/dirty{frac}", 0.0,
             f"{cell['pcie_x']}x_dirty_bytes,host={cell['host_x']}x")
        out["dirty_cells"].append(cell)

    # the default chunk size (8 MiB) is the headline cell; smoke runs
    # sweep smaller sizes, so fall back to the largest chunked cell
    default_x = next(
        (c.get("stall_x", 0.0) for c in out["chunk_cells"]
         if c["chunk_mb"] == 8),
        max((c.get("stall_x", 0.0) for c in out["chunk_cells"]), default=0.0))
    sparse = next((c for c in out["dirty_cells"]
                   if c["dirty_frac"] <= 0.01), {})
    all_ok = all(c["ok"] for c in out["chunk_cells"] + out["dirty_cells"])
    out["default_chunk_stall_x"] = default_x
    out["sparse_pcie_x"] = sparse.get("pcie_x", float("inf"))
    out["verdict"] = ("supported" if default_x >= 2.0
                      and out["sparse_pcie_x"] <= 1.2 and all_ok
                      else "refuted")
    emit("fig_snapshot/verdict", 0.0, out["verdict"])
    shutil.rmtree(d, ignore_errors=True)
    if not smoke:
        save_json("fig_snapshot", out)
    return out


if __name__ == "__main__":
    print(json.dumps(run(), indent=2))
    cleanup()
