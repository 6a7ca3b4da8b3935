#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each of which exits non-zero on failure:

1. the card: name and power limit (``nvidia-smi``);
2. build: compile the ckpt_pack CUDA kernels from ``src/repro_torch``;
3. kernels: every kernel held bit-exact against its plain PyTorch version
   on the card, at the shapes of the main path plus ragged, NaN, ±0.0,
   all-clean and one-dirty cases; CUDA-event times beside the bytes bound;
4. main path: ``repro_torch`` Trainer on ``stablelm_1_6b`` at full width
   on ``cuda``, checkpointing every step (fastpersist-pipelined,
   keyframe_every=2, device-dirty), with the kernels' launch counts
   read around it;
5. restore: a fresh Trainer restores the latest step bit-equal to the
   live state and data position.

The last two lines of standard output are one JSON object of per-kernel
numbers and one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM device-memory rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/ckpt_pack.cu"
#: layers/mlp/wi of stablelm_1_6b: the largest bf16 record of the main path
BIG = (24, 2048, 5632)
#: main path: steps (1 keyframe + 1 delta save), global batch, sequence
STEPS, BATCH, SEQ = 2, 4, 512


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------- phase 1
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------- phase 3
def _ints(t):
    import torch
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _compare(name, got, want, *, bits: bool):
    """Hold kernel outputs against the plain version's. ``bits``: the
    packed tensor must be bit-identical (identity packs); otherwise equal
    bits where the plain value is a number and NaN where it is NaN (a
    non-identity cast of a NaN may give another NaN payload). amax must
    be equal with NaN where the plain one is NaN, masks equal. Returns
    the largest absolute difference seen (0.0 when exact)."""
    import torch
    pk, ak = got[0], got[1]
    pp, ap = want[0], want[1]
    if pk.dtype != pp.dtype or pk.shape != pp.shape:
        fail(f"{name}: packed {pk.dtype}{tuple(pk.shape)} vs plain "
             f"{pp.dtype}{tuple(pp.shape)}")
    if bits:
        ok = torch.equal(_ints(pk), _ints(pp))
    else:
        nan = pp.isnan()
        ok = torch.equal(nan, pk.isnan()) and torch.equal(
            _ints(pk)[~nan], _ints(pp)[~nan])
    if not ok:
        fail(f"{name}: packed bits differ from the plain version")
    if not (torch.equal(ak.isnan(), ap.isnan())
            and torch.equal(ak.nan_to_num(0.0), ap.nan_to_num(0.0))):
        fail(f"{name}: amax differs from the plain version")
    if len(got) > 2 and not torch.equal(got[2], want[2]):
        fail(f"{name}: mask differs from the plain version "
             f"({int(got[2].sum())} vs {int(want[2].sum())} dirty)")
    err = 0.0
    for k, p in ((pk.float(), pp.float()), (ak, ap)):
        fin = k.isfinite() & p.isfinite()
        if fin.any():
            err = max(err, float((k[fin] - p[fin]).abs().max()))
    return err


def _cuda_ms(fn, iters: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def _touch_rows(flat, block: int, every: int, gen):
    """Add 1 to one element in every ``every``-th block (random rows)."""
    import torch
    n_rows = -(-flat.numel() // block)
    rows = torch.randint(0, n_rows, (max(1, n_rows // every),),
                         device=flat.device, generator=gen)
    idx = (rows * block).clamp(max=flat.numel() - 1)
    flat[idx] += 1


def _specials(dtype, block: int, device):
    """(old, new, expected mask) over 8 blocks: NaN payloads kept,
    +0.0 -> -0.0, a NaN payload changed, a signalling NaN kept, inf kept,
    an all-zero block, an untouched block, one changed value."""
    import torch
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    nan_a, nan_b, snan = ((0x7FC00001, 0x7FC00002, 0x7F800001)
                          if dtype == torch.float32
                          else (0x7FC1, 0x7FC2, 0x7F81))
    old = torch.linspace(-3, 3, 8 * block, device=device).to(dtype)
    old = old.reshape(8, block)
    old_i = _ints(old)
    old_i[0, 5] = nan_a
    old_i[0, 9] = -1                         # all-ones NaN, sign set
    old[1, 3] = 0.0
    old_i[2, 7] = nan_a
    old_i[3, 11] = snan
    old[4, 0] = float("inf")
    old[5].zero_()
    new = old.clone()
    new[1, 3] = -0.0
    _ints(new)[2, 7] = nan_b
    new[7, block - 1] += 1
    want = torch.tensor([0, 1, 1, 0, 0, 0, 0, 1], dtype=torch.int32,
                        device=device)
    assert old_i.dtype == ints
    return old.reshape(-1), new.reshape(-1), want


def check_kernels(device) -> list:
    """Phase 3. Returns the per-kernel entries of the ``kernels`` line
    (launches filled in after the main path)."""
    import torch
    from repro_torch.kernels import ckpt_pack as cp
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ckpt_pack_dirty_plain, ckpt_pack_plain
    gen = torch.Generator(device=device).manual_seed(0)
    big = BIG
    errs = {"ckpt_pack_dirty_blocks": 0.0, "ckpt_pack_blocks": 0.0}

    def dirty(name, old, new, block, out_dtype=None, want_mask=None):
        od = new.dtype if out_dtype is None else out_dtype
        prev2d = (ops.pack_blocks(old, block=block) if out_dtype is None
                  else ops._to_blocks(old.reshape(-1), block).to(od))
        x2d = ops._to_blocks(new.reshape(-1), block)
        got = cp.ckpt_pack_dirty_blocks(x2d, prev2d, out_dtype=od)
        want = ckpt_pack_dirty_plain(x2d, prev2d, out_dtype=od)
        torch.cuda.synchronize()
        err = _compare(name, got, want, bits=out_dtype is None)
        if want_mask is not None and not torch.equal(got[2], want_mask):
            fail(f"{name}: mask {got[2].tolist()} != expected "
                 f"{want_mask.tolist()}")
        errs["ckpt_pack_dirty_blocks"] = max(errs["ckpt_pack_dirty_blocks"],
                                             err)
        n_dirty = int(got[2].sum())
        print(f"  ok {name}: {x2d.shape[0]} blocks, {n_dirty} dirty, "
              f"max_abs_err {err}", flush=True)
        return x2d, prev2d

    def packed(name, x, block, out_dtype=torch.bfloat16, scale=1.0):
        x2d = ops._to_blocks(x.reshape(-1), block)
        got = cp.ckpt_pack_blocks(x2d, out_dtype=out_dtype, scale=scale)
        want = ckpt_pack_plain(x2d, out_dtype=out_dtype, scale=scale)
        torch.cuda.synchronize()
        err = _compare(name, got, want, bits=False)
        errs["ckpt_pack_blocks"] = max(errs["ckpt_pack_blocks"], err)
        print(f"  ok {name}: {x2d.shape[0]} blocks, max_abs_err {err}",
              flush=True)
        return x2d

    print("phase 3: kernels against their plain versions", flush=True)
    # ---- B1 at the main path's shapes: a bf16 param and its f32 master
    old = torch.randn(big, device=device, generator=gen).to(torch.bfloat16)
    new = old.clone()
    _touch_rows(new.view(-1), 2048, 7, gen)
    x2d_b, prev_b = dirty("dirty bf16 (24,2048,5632) block 2048", old, new,
                          2048)
    dirty("dirty bf16 all-clean", old, old, 2048,
          want_mask=torch.zeros(x2d_b.shape[0], dtype=torch.int32,
                                device=device))
    one = old.clone()
    one.view(-1)[one.numel() // 2 + 7] += 1
    x1 = dirty("dirty bf16 one dirty block", old, one, 2048)
    if int(cp.ckpt_pack_dirty_blocks(x1[0], x1[1])[2].sum()) != 1:
        fail("one-dirty-block case does not mark exactly one block")
    del one, x1
    oldf = torch.randn(big, device=device, generator=gen)
    newf = oldf.clone()
    _touch_rows(newf.view(-1), 1024, 7, gen)
    dirty("dirty f32 (24,2048,5632) block 1024", oldf, newf, 1024)
    rag = torch.randn(1_000_003, device=device, generator=gen)
    rag2 = rag.clone()
    rag2[-1] += 1
    dirty("dirty f32 ragged 1000003 block 1024", rag, rag2, 1024)
    for dt, blk in ((torch.float32, 1024), (torch.bfloat16, 2048)):
        o, n, want = _specials(dt, blk, device)
        dirty(f"dirty {dt} NaN payloads / +-0.0 / inf", o, n, blk,
              want_mask=want)
    dirty("dirty f32->bf16 cast (24,2048,5632) block 2048", oldf, newf,
          2048, out_dtype=torch.bfloat16)
    # ---- B2: f32 master -> bf16 at the quantizer's 4096 block, ragged
    x2d_p = packed("pack f32->bf16 (24,2048,5632) block 4096", oldf, 4096)
    packed("pack f32->bf16 ragged block 8192 scale 0.5", rag, 8192,
           scale=0.5)
    packed("pack bf16->bf16 (24,2048,5632) block 8192", old, 8192)
    o, _, _ = _specials(torch.float32, 1024, device)
    packed("pack f32->bf16 NaN payloads / +-0.0 / inf", o, 1024)

    # ---- times at the main path's shape, with the bytes bound
    rows_b = x2d_b.shape[0]
    b1_bytes = 3 * x2d_b.numel() * 2 + 8 * rows_b
    b1_ms = _cuda_ms(lambda: cp.ckpt_pack_dirty_blocks(x2d_b, prev_b))
    b1_plain = _cuda_ms(lambda: ckpt_pack_dirty_plain(x2d_b, prev_b))
    rows_p = x2d_p.shape[0]
    b2_bytes = x2d_p.numel() * (4 + 2) + 4 * rows_p
    b2_ms = _cuda_ms(lambda: cp.ckpt_pack_blocks(x2d_p))
    b2_plain = _cuda_ms(lambda: ckpt_pack_plain(x2d_p))
    entries = [
        {"name": "ckpt_pack_dirty_blocks", "route": "cuda",
         "source": KERNEL_SOURCE,
         "replaces": "src/repro/kernels/ckpt_pack.py:76",
         "launches": 0, "max_abs_err": errs["ckpt_pack_dirty_blocks"],
         "ms": b1_ms, "plain_ms": b1_plain,
         "bound_ms": b1_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None,
         "shape": f"bf16 {tuple(x2d_b.shape)}", "bytes": b1_bytes},
        {"name": "ckpt_pack_blocks", "route": "cuda",
         "source": KERNEL_SOURCE,
         "replaces": "src/repro/kernels/ckpt_pack.py:56",
         "launches": 0, "max_abs_err": errs["ckpt_pack_blocks"],
         "ms": b2_ms, "plain_ms": b2_plain,
         "bound_ms": b2_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None,
         "shape": f"f32->bf16 {tuple(x2d_p.shape)}", "bytes": b2_bytes},
    ]
    for e in entries:
        print(f"  time {e['name']} {e['shape']}: {e['ms']:.3f} ms "
              f"(plain {e['plain_ms']:.3f} ms, bytes bound "
              f"{e['bound_ms']:.3f} ms, {e['bytes'] / e['ms'] / 1e6:.0f} "
              f"GB/s)", flush=True)
    return entries


# ------------------------------------------------------------ phase 4-5
def _kernel_records(trainer, dirty_block: int) -> int:
    """Records the device-dirty snapshot sends through the kernel: float
    records of at least one dirty block (every float record of the full
    model)."""
    from repro_torch.tree import flatten
    return sum(1 for _, t in flatten(trainer.state)
               if t.is_floating_point()
               and t.numel() * t.element_size() >= dirty_block)


def main_path(device, steps: int, batch: int, seq: int):
    """Phases 4 and 5. Returns the B1 launch count of the main path."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.checkpointer import FastPersistConfig
    from repro_torch.core.partition import Topology
    from repro_torch.kernels import ckpt_pack as cp
    from repro_torch.train.trainer import (CheckpointPolicy, Trainer,
                                           TrainerConfig)
    from repro_torch.tree import flatten

    cfg = get_config("stablelm_1_6b")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        state_bytes = cfg.param_count() * 14
        free = shutil.disk_usage(tmp).free
        print(f"phase 4: main path, checkpoint dir on a disk with "
              f"{free / 1e9:.1f} GB free; full state {state_bytes / 1e9:.2f} "
              f"GB", flush=True)
        need = 2.2 * state_bytes          # keyframe + delta + slack
        if free < need:
            per_layer = cfg._layer_params(0) * 14
            fixed = state_bytes - cfg.n_layers * per_layer
            n = int((free / 2.2 - fixed) // per_layer)
            if n < 1:
                fail(f"disk holds {free / 1e9:.1f} GB: not two generations "
                     f"of even one layer")
            print(f"  CUT: n_layers {cfg.n_layers} -> {n} so two "
                  f"generations fit the disk (widths unchanged)")
            cfg = dataclasses.replace(cfg, n_layers=n)
        pol = CheckpointPolicy(
            directory=tmp, every=1, backend="fastpersist-pipelined",
            keyframe_every=2, restore_readers="auto",
            fp=FastPersistConfig(device_dirty=True, topology=Topology(
                dp_degree=4, ranks_per_node=4)))
        tcfg = TrainerConfig(model=cfg, steps=steps, global_batch=batch,
                             seq_len=seq, checkpoint=pol, log_every=1)
        tr = Trainer(tcfg, device="cuda")
        tr.init_state()
        n_kernel = _kernel_records(tr, pol.fp.dirty_block)
        print(f"  model {cfg.name}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab_size}; "
              f"{len(flatten(tr.state))} records, {n_kernel} through the "
              f"kernel; batch "
              f"{batch} x seq {seq}, {steps} steps", flush=True)
        torch.cuda.reset_peak_memory_stats()
        # every count to 0 just before the main path
        cp.ckpt_pack_dirty_blocks.launches = 0
        cp.ckpt_pack_blocks.launches = 0
        t0 = time.perf_counter()
        _, metrics = tr.run()
        wall = time.perf_counter() - t0
        launches = {"ckpt_pack_dirty_blocks": cp.ckpt_pack_dirty_blocks.launches,
                    "ckpt_pack_blocks": cp.ckpt_pack_blocks.launches}
        loss = float(metrics["loss"])
        print(f"  done: loss={loss:.4f} wall={wall:.2f} s "
              f"iter_times_s={[round(t, 3) for t in tr.iter_times]} "
              f"ckpt_stall_s={tr.ckpt_stall:.3f} (snapshot waits "
              f"{tr.engine.stats.snapshot_stall_seconds:.3f}) "
              f"engine_stall_s={tr.engine.stats.stall_seconds:.3f} "
              f"peak_device_GB={torch.cuda.max_memory_allocated() / 1e9:.1f}",
              flush=True)
        for h in tr.saves:
            st = h.result()
            print(f"  save step {st.step}: "
                  f"{'delta' if st.delta else 'keyframe'} "
                  f"bytes_written={st.total_bytes} d2h_bytes={st.d2h_bytes} "
                  f"snapshot_seconds={st.snapshot_seconds:.3f} "
                  f"persist_seconds={st.seconds:.3f} "
                  f"commit_seconds={st.commit_seconds:.3f} "
                  f"writers={st.n_writers} "
                  f"o_direct={all(w.direct for w in st.per_writer)} "
                  f"io={st.per_writer[0].backend}", flush=True)
        print(f"  launches on the main path: {launches}", flush=True)
        if not math.isfinite(loss):
            fail(f"loss is not finite: {loss}")
        first, second = (h.result() for h in tr.saves[:2])
        # the keyframe had no device baseline: every byte crossed on the
        # host path, so no kernel launch can belong to it — all of B1's
        # launches are the delta save's
        if first.delta is not None or first.d2h_bytes != first.total_bytes:
            fail("the first save is not a full host-path keyframe")
        if second.delta is None:
            fail("the second save is not a delta generation")
        if launches["ckpt_pack_dirty_blocks"] != n_kernel:
            fail(f"ckpt_pack_dirty_blocks launched "
                 f"{launches['ckpt_pack_dirty_blocks']} times on the delta "
                 f"save; expected {n_kernel}")

        # ---- phase 5: a fresh trainer restores the latest step
        live, position = tr.state, tr.data.position
        tr.engine.close()
        del tr, metrics
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tr2 = Trainer(tcfg, device="cuda")
        step = tr2.restore()
        torch.cuda.synchronize()
        print(f"phase 5: restored step {step} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        if step != steps or tr2.data.position != position:
            fail(f"restore gave step {step} at data position "
                 f"{tr2.data.position}; expected {steps} at {position}")
        got, want = flatten(tr2.state), flatten(live)
        if [n for n, _ in got] != [n for n, _ in want]:
            fail("restored state has other records than the live state")
        for (name, a), (_, b) in zip(got, want):
            if a.dtype != b.dtype or a.shape != b.shape \
                    or not torch.equal(_ints(a.detach()),
                                       _ints(b.detach())):
                fail(f"restored {name} is not bit-equal to the live state")
        print(f"  all {len(got)} records bit-equal to the live state; data "
              f"position {position}", flush=True)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        epilog="Takes no arguments: every phase runs.").parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"phase 1: card {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    from repro_torch.kernels import ckpt_pack as cp
    secs = cp.build(force=True)
    print(f"phase 2: built {KERNEL_SOURCE} in {secs:.2f} s", flush=True)
    for line in cp.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # float32 products in full precision (cuDNN is not used)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entries = check_kernels(device)
    torch.cuda.empty_cache()
    launches = main_path(device, STEPS, BATCH, SEQ)
    for e in entries:
        e["launches"] = launches[e["name"]]
    print(json.dumps({"kernels": [
        {k: v for k, v in e.items() if k not in ("shape", "bytes")}
        for e in entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
