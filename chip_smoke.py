#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each of which exits non-zero on failure:

1. the card: name and power limit (``nvidia-smi``);
2. build: compile the three CUDA sources of ``src/repro_torch`` (one
   ``nvcc`` each, in parallel);
3. kernels: every kernel held against its plain PyTorch version on the
   card — ckpt_pack bit-exact at the shapes of the main path plus ragged,
   NaN, ±0.0, all-clean and one-dirty cases; flash_attention and
   ssd_intra_chunk within the reference's tolerances at the paths'
   shapes and the reference's sweep — with CUDA-event times beside the
   bound, the plain version and the library call where there is one;
4. main path: ``repro_torch`` Trainer on ``stablelm_1_6b`` at full width
   on ``cuda``, checkpointing every step (fastpersist-pipelined,
   keyframe_every=2, device-dirty), with the kernels' launch counts
   read around it;
5. restore: a fresh Trainer restores the latest step bit-equal to the
   live state and data position;
6. scoring: each layer's bf16 attention output held against the plain
   version on the q, k, v of the restored model's forward; then the
   restored state scored with ``build_model(use_kernels=True)`` on the
   trainer's next batch, bf16 on the bf16 params and f32 on the master
   weights, against the same forward through the plain attention;
   flash_attention launch counts read around it;
7. quantized save: the restored state saved with ``quantize=True``
   (int8 per block of 4096, scales from ckpt_pack_blocks on the card;
   its launch count read around the save), each record's kernel amax
   held bit for bit against the host amax of the same values, the int8
   and scale bytes on disk against host-amax quantization, a restore
   onto the card within the quantizer's per-block bound, then a
   ``delta_quantize`` chain (2 layers at published widths, device-dirty)
   restored within the same bound on its q8 spans;
8. mamba2_370m at full width: init from a seed, a checkpoint round trip
   through the engine, the kernel forward at batch 4 x 2048 against the
   plain hook (ssd_intra_chunk launch counts read around it), and a
   batch-4 x 512 prefill + 16 greedy decode steps against the forward.

The last three lines of standard output are one JSON object of
per-kernel numbers, the card's name and power limit, and one JSON
object naming the device.
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

#: H100 SXM peaks (NVIDIA data sheet), for the bounds: device-memory
#: rate, dense bf16 tensor-core rate, f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
#: the fastest route to products of f32 accuracy: each f32 product split
#: into three bf16 tensor-core products (hi·hi + hi·lo + lo·hi)
F32_SPLIT_FLOPS = BF16_FLOPS / 3
CSRC = "src/repro_torch/kernels/csrc"
#: layers/mlp/wi of stablelm_1_6b: the largest bf16 record of the main path
BIG = (24, 2048, 5632)
#: main path: steps (1 keyframe + 1 delta save), global batch, sequence
STEPS, BATCH, SEQ = 2, 4, 512
#: attention of stablelm_1_6b on the main path's batch: (B, H, L, hd)
ATTN = (BATCH, 32, SEQ, 64)
#: mamba2_370m: batch x sequence of the forward, prompt and new tokens
#: of the decode check, and ssd_intra_chunk's (b, nc, cl, h, p, n) there
M_BATCH, M_SEQ, M_PROMPT, M_NEW = 4, 2048, 512, 16
SSD = (M_BATCH, M_SEQ // 256, 256, 32, 64, 128)
#: tolerances (with their reasons at the checks): the reference's kernel
#: tolerances (tests/test_kernels.py), its model-level one
#: (tests/test_use_pallas.py) and its decode one (tests/test_archs.py)
TOL_ATTN_F32, TOL_ATTN_VARIANT, TOL_ATTN_BF16 = 2e-5, 3e-5, 2e-2
TOL_SSD, TOL_MODEL, TOL_DECODE = 1e-4, 1e-3, 2e-3
#: bf16 scoring: each layer's attention output at the kernel tolerance,
#: the loss within 1e-3 relative (see score_restored)
TOL_LOSS_BF16 = 1e-3


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


def _bound(n_bytes: float, ops_seconds: float):
    """(bound ms, what bounds it): the larger of the bytes over the
    memory rate and the operations' seconds at the peak rates for their
    types."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_seconds * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _zero_counts():
    """Every kernel's launch count to 0, just before a path is driven."""
    from repro_torch.kernels import ckpt_pack as cp
    from repro_torch.kernels import ops
    for w in (cp.ckpt_pack_blocks, cp.ckpt_pack_dirty_blocks,
              ops.flash_attention, ops.ssd_intra_chunk):
        w.launches = 0


def _close(name, got, want, tol, rtol=None, quiet=False):
    """Fail unless |got - want| <= tol + rtol·|want| everywhere (rtol
    defaults to tol) and both are finite; returns the largest absolute
    difference (printed unless ``quiet``)."""
    import torch
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{name}: non-finite values")
    rtol = tol if rtol is None else rtol
    err = (got - want).abs()
    bad = int((err > tol + rtol * want.abs()).sum())
    worst = float(err.max())
    if bad:
        fail(f"{name}: {bad} elements beyond tolerance {tol} (rtol {rtol};"
             f" max abs err {worst})")
    if not quiet:
        print(f"  ok {name}: tol {tol} (rtol {rtol}), max_abs_err {worst}",
              flush=True)
    return worst


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
         "source": f"{CSRC}/ckpt_pack.cu",
         "replaces": "src/repro/kernels/ckpt_pack.py:76",
         "launches": 0, "max_abs_err": errs["ckpt_pack_dirty_blocks"],
         "ms": b1_ms, "plain_ms": b1_plain,
         "bound_ms": b1_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None,
         "shape": f"bf16 {tuple(x2d_b.shape)}", "bytes": b1_bytes},
        {"name": "ckpt_pack_blocks", "route": "cuda",
         "source": f"{CSRC}/ckpt_pack.cu",
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


def check_attention(device) -> dict:
    """Phase 3, B3: flash_attention against its plain version at the main
    path's shape (bf16 and f32, the model's strided views) and at the
    reference's sweep and variants (tests/test_kernels.py:126-166, at its
    tolerances). Returns the ``kernels`` entry (launches filled in by
    phase 6)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_plain
    gen = torch.Generator(device=device).manual_seed(1)

    def qkv(B, H, KV, Lq, Lk, hd, dtype):
        # (B, L, H, hd) swapped to (B, H, L, hd), as the model calls it
        q = torch.randn((B, Lq, H, hd), generator=gen, device=device)
        k, v = (torch.randn((B, Lk, KV, hd), generator=gen, device=device)
                for _ in range(2))
        return [t.to(dtype).transpose(1, 2) for t in (q, k, v)]

    err = 0.0
    cases = [("path", ATTN[:2] + (ATTN[1], ATTN[2], ATTN[2], ATTN[3]), {})]
    cases += [("sweep", (B, H, KV, L, L, hd), {}) for B, H, KV, L, hd in (
        (1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 1, 384, 128),
        (1, 2, 2, 100, 64))]
    cases += [("variant", (1, 4, 2, 256, 256, 64), kw) for kw in (
        {"window": 64}, {"cap": 50.0}, {"causal": False},
        {"window": 32, "cap": 30.0})]
    cases += [("variant", (1, 4, 4, 128, 512, 64), {"causal": False}),
              ("variant", (1, 2, 2, 256, 128, 64), {"window": 32})]
    print("  flash_attention (B3) against flash_attention_plain:", flush=True)
    for kind, shape, kw in cases:
        for dtype in (torch.bfloat16, torch.float32):
            if kind == "variant" and dtype == torch.bfloat16:
                continue
            q, k, v = qkv(*shape, dtype)
            got = ops.flash_attention(q, k, v, **kw)
            want = flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            tol = (TOL_ATTN_BF16 if dtype == torch.bfloat16 else
                   TOL_ATTN_VARIANT if kind == "variant" else TOL_ATTN_F32)
            err = max(err, _close(f"{kind} {str(dtype)[6:]} {shape} {kw}",
                                  got, want, tol))

    # times at the main path's shape: bf16, causal, the model's views
    B, H, L, hd = ATTN
    q, k, v = qkv(B, H, H, L, L, hd, torch.bfloat16)
    ms = _cuda_ms(lambda: ops.flash_attention(q, k, v))
    plain_ms = _cuda_ms(lambda: flash_attention_plain(q, k, v))
    # the yardstick only: the port never calls it
    library_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    n_bytes = 4 * B * H * L * hd * q.element_size()
    flops = 4 * hd * B * H * L * (L + 1) // 2        # causal pairs only
    bound_ms, bound_by = _bound(n_bytes, flops / BF16_FLOPS)
    entry = {"name": "flash_attention", "route": "cuda",
             "source": f"{CSRC}/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:66",
             "launches": 0, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms,
             "shape": f"bf16 causal {ATTN}", "bytes": n_bytes,
             "flops": flops}
    return entry


def check_ssd(device) -> dict:
    """Phase 3, B4: ssd_intra_chunk against its plain version at
    mamba2_370m's shape (batch 4 x 2048) and the reference's sweep
    (tests/test_kernels.py:170-174), at the reference's 1e-4. Returns the
    ``kernels`` entry (launches filled in by phase 8)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_intra_chunk_plain
    gen = torch.Generator(device=device).manual_seed(2)

    def inputs(b, nc, cl, h, p, n):
        xc = torch.randn((b, nc, cl, h, p), generator=gen, device=device)
        dAc = -torch.randn((b, nc, cl, h), generator=gen,
                           device=device).abs() * 0.1
        Bc, Cc = (torch.randn((b, nc, cl, h, n), generator=gen,
                              device=device) for _ in range(2))
        return xc, dAc, Bc, Cc

    err = 0.0
    print("  ssd_intra_chunk (B4) against ssd_intra_chunk_plain:",
          flush=True)
    for shape in (SSD, (1, 2, 64, 2, 32, 16), (2, 4, 128, 4, 64, 32),
                  (1, 1, 256, 8, 64, 64)):
        args = inputs(*shape)
        got = ops.ssd_intra_chunk(*args)
        want = ssd_intra_chunk_plain(*args)
        torch.cuda.synchronize()
        err = max(err, _close(f"f32 (b, nc, cl, h, p, n) = {shape}", got,
                              want, TOL_SSD))
    args = inputs(*SSD)
    ms = _cuda_ms(lambda: ops.ssd_intra_chunk(*args))
    plain_ms = _cuda_ms(lambda: ssd_intra_chunk_plain(*args))
    b, nc, cl, h, p, n = SSD
    n_bytes = 4 * (b * nc * cl * h * (2 * p + 2 * n + 1))
    pairs = b * nc * h * cl * (cl + 1) // 2          # s <= l only
    products = pairs * (2 * n + 2 * p)   # C·Bᵀ, then with X
    flops = products + pairs             # and the decay's multiply
    # the bound takes the products at the split-bf16 tensor-core rate,
    # the fastest route that could hold the 1e-4 of f32; the kernel's
    # own design, every FLOP an f32 FMA, has the looser "fma bound"
    bound_ms, bound_by = _bound(
        n_bytes, products / F32_SPLIT_FLOPS + pairs / F32_FLOPS)
    fma_ms = _bound(n_bytes, flops / F32_FLOPS)[0]
    return {"name": "ssd_intra_chunk", "route": "cuda",
            "source": f"{CSRC}/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:40",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "shape": f"f32 (b, nc, cl, h, p, n) = {SSD}", "bytes": n_bytes,
            "flops": flops, "fma_bound_ms": fma_ms}


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
    """Phases 4 and 5. Returns the ckpt_pack launch counts of the main
    path, the model config, the restored state with the trainer's next
    batch (for phase 6) and the extras a save of it carries (phase 7)."""
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
        _zero_counts()             # just before the main path
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
        tr2.engine.close()
        return (launches, cfg, tr2.state, tr2.data.peek(tr2.data.position),
                {"step": step, "data": tr2.data.state()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- phase 6
def score_restored(cfg, state, batch):
    """Phase 6: score the restored state with the kernel forward path
    (``build_model(use_kernels=True)``) on the trainer's next batch, in
    bf16 on the bf16 params and in f32 on the master weights, against the
    same forward through ``flash_attention_plain``. Returns the
    flash_attention launch count of the phase.

    Tolerances: f32 logits within 1e-3 (the reference's model-level
    tolerance, tests/test_use_pallas.py: the same f32 math, summed in
    another order). bf16: the attention output is rounded to bf16, so
    where the kernel's and the plain version's f32 results differ in the
    last bits a bf16 rounding can flip by one ulp (2^-8 relative); the
    flips spread through the later bf16 layers, so bf16 logits are not
    held elementwise. Instead the kernel's output in every layer of the
    bf16 forward is held against the plain version on the same q, k, v
    at the kernel's bf16 tolerance (2e-2): a loss near log V, as after
    two steps of training, hardly moves when attention is wrong, so the
    loss alone proves little. The loss is held within 1e-3 relative too
    (as tests/test_torch_model.py holds two bf16 computations of one
    model), and the logits' largest difference is printed."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_plain
    from repro_torch.models import transformer
    from repro_torch.models.registry import build_model, cross_entropy

    def plain_hook(q, k, v, cap=None):
        return flash_attention_plain(q, k, v, causal=True, cap=cap)

    def plain_forward(params, dtype):
        return transformer.forward(params, cfg, batch, dtype=dtype,
                                   attn_kernel=plain_hook)[0]

    layer_errs = []

    def checked_hook(q, k, v, cap=None):
        got = ops.flash_attention(q, k, v, causal=True, cap=cap)
        want = flash_attention_plain(q, k, v, causal=True, cap=cap)
        layer_errs.append(_close(
            f"bf16 attention of layer {len(layer_errs)}", got, want,
            TOL_ATTN_BF16, quiet=True))
        return got

    print(f"phase 6: score the restored {cfg.name} with use_kernels=True "
          f"on the trainer's next batch {tuple(batch['tokens'].shape)}",
          flush=True)
    with torch.inference_mode():
        # every layer's kernel output against the plain version on the
        # q, k, v of the bf16 forward (comparison launches, not counted)
        transformer.forward(state.params, cfg, batch, dtype=torch.bfloat16,
                            attn_kernel=checked_hook)
        if len(layer_errs) != cfg.n_layers:
            fail(f"the checked bf16 forward ran attention "
                 f"{len(layer_errs)} times; expected {cfg.n_layers}")
        print(f"  ok bf16 attention output of each of the {cfg.n_layers} "
              f"layers vs the plain version: tol {TOL_ATTN_BF16} (rtol "
              f"{TOL_ATTN_BF16}), max_abs_err {max(layer_errs)}", flush=True)
    _zero_counts()             # just before the scoring path
    with torch.inference_mode():
        # bf16 compute on the bf16 params: the restored model, scored
        model = build_model(cfg, use_kernels=True)
        t0 = time.perf_counter()
        loss = float(model.loss(state.params, batch))
        wall = time.perf_counter() - t0
        n = ops.flash_attention.launches
        logits, _ = model.forward(state.params, batch)
        n2 = ops.flash_attention.launches - n
        plain_logits = plain_forward(state.params, torch.bfloat16)
        plain_loss = float(cross_entropy(plain_logits, batch["labels"]))
        diff = float((logits.float() - plain_logits.float()).abs().max())
        print(f"  bf16: loss {loss:.6f} (plain {plain_loss:.6f}) in "
              f"{wall:.3f} s; flash_attention launches {n} (loss) + {n2} "
              f"(forward); logits max_abs_diff {diff}", flush=True)
        if n != cfg.n_layers or n2 != cfg.n_layers:
            fail(f"a bf16 forward launched flash_attention {n} / {n2} "
                 f"times; expected {cfg.n_layers}")
        if not (math.isfinite(loss) and abs(loss - plain_loss)
                <= TOL_LOSS_BF16 * abs(plain_loss)):
            fail(f"bf16 loss {loss} vs plain {plain_loss} beyond "
                 f"{TOL_LOSS_BF16} relative")
        del logits, plain_logits
        # f32 compute on the f32 master weights
        model32 = build_model(cfg, dtype=torch.float32, use_kernels=True)
        n = ops.flash_attention.launches
        logits, _ = model32.forward(state.opt.master, batch)
        n = ops.flash_attention.launches - n
        if n != cfg.n_layers:
            fail(f"the f32 forward launched flash_attention {n} times; "
                 f"expected {cfg.n_layers}")
        if logits.shape != (*batch["tokens"].shape, cfg.vocab_size):
            fail(f"f32 logits of shape {tuple(logits.shape)}")
        want = plain_forward(state.opt.master, torch.float32)
        _close(f"f32 logits {tuple(logits.shape)} ({n} launches)", logits,
               want, TOL_MODEL, rtol=0.0)
    torch.cuda.synchronize()
    return ops.flash_attention.launches


# ---------------------------------------------------------------- phase 7
def _stream_offsets(leaves):
    """(name, stream offset) of each leaf, in stream order."""
    out, off = [], 0
    for name, t in leaves:
        out.append((name, off))
        off += t.numel() * t.element_size()
    return out


def _q8_bound(x, xh):
    """Fail-free check of restored ``xh`` against ``x`` inside q8 data:
    per 4096-element block (zero-padded), |x - x̂| ≤ amax/254 — half a
    quantization step — plus 2^-22·amax for the f32 roundings of the
    division and the product, plus half an ulp of x̂ in its own dtype
    for bf16 (2^-8) and f16 (2^-11) records. Returns (elements beyond
    the bound, largest error)."""
    import torch
    from repro_torch.core.quant import BLOCK
    rel = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
           torch.float16: 2.0 ** -11}[xh.dtype]
    x, xh = x.reshape(-1).float(), xh.reshape(-1).float()
    n = x.numel()
    pad = (-n) % BLOCK
    amax = torch.cat([x.abs(), x.new_zeros(pad)]).view(-1, BLOCK) \
        .amax(dim=1).repeat_interleave(BLOCK)[:n]
    err = (x - xh).abs()
    bad = int((err > amax / 254 + amax * 2.0 ** -22 + rel * xh.abs()).sum())
    return bad, float(err.max()) if n else 0.0


def _same_bits(a, b) -> bool:
    import torch
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(_ints(a.detach()), _ints(b.detach()))


def quantized_save(cfg, state, extras, device) -> int:
    """Phase 7 (a)-(f): save the restored ``cfg`` state through an engine
    with ``FastPersistConfig(quantize=True)``, B2's launches read around
    the save, and hold the result against host quantization and the live
    state. Returns the ckpt_pack_blocks launch count of the save."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core import quant
    from repro_torch.core.checkpointer import FastPersistConfig
    from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
    from repro_torch.core.partition import Topology
    from repro_torch.core.serializer import dtype_name
    from repro_torch.kernels import ckpt_pack as cp
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import init_train_state
    from repro_torch.tree import flatten

    leaves = flatten(state)
    qnames = [n for n, t in leaves
              if quant.quantizable(dtype_name(t), t.numel())]
    full = sum(t.numel() * t.element_size() for _, t in leaves)
    want_bytes = sum(t.numel() + 4 * -(-t.numel() // quant.BLOCK)
                     if n in qnames else t.numel() * t.element_size()
                     for n, t in leaves)
    print(f"phase 7: quantized save of the restored {cfg.name} "
          f"({len(leaves)} records, {len(qnames)} quantizable; "
          f"{full} B full)", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_q8_")
    try:
        spec = CheckpointSpec(
            directory=tmp, backend="fastpersist-pipelined",
            fp=FastPersistConfig(quantize=True, topology=Topology(
                dp_degree=4, ranks_per_node=4)))
        eng = CheckpointEngine(spec)
        _zero_counts()             # just before the quantized save
        t0 = time.perf_counter()
        st = eng.save(state, extras["step"], extras).wait()
        wall = time.perf_counter() - t0
        launches = cp.ckpt_pack_blocks.launches
        eng.close()
        del eng                    # frees the save's 23 GB staging arena
        gc.collect()
        snap_s = st.serialize_seconds - st.quantize_seconds
        print(f"  (a) save: {launches} ckpt_pack_blocks launches; "
              f"{st.total_bytes} B on disk vs {full} B full "
              f"({full / st.total_bytes:.3f}x smaller); snapshot "
              f"{snap_s:.3f} s, quantize {st.quantize_seconds:.3f} s, "
              f"persist {st.seconds:.3f} s, commit "
              f"{st.commit_seconds:.3f} s, wall {wall:.3f} s; writers "
              f"{st.n_writers}, o_direct "
              f"{all(w.direct for w in st.per_writer)}", flush=True)
        if launches != len(qnames):
            fail(f"ckpt_pack_blocks launched {launches} times on the "
                 f"quantized save; expected {len(qnames)}")
        if sorted(st.device_amax) != sorted(qnames):
            fail("the save's device amax does not cover exactly the "
                 "quantizable records")
        if st.total_bytes != want_bytes:
            fail(f"{st.total_bytes} B on disk; the layout gives "
                 f"{want_bytes}")

        # (b), (c): kernel amax vs host amax, disk bytes vs host quantize
        rd = CheckpointEngine(CheckpointSpec(directory=tmp))
        t0 = time.perf_counter()
        for name, t in leaves:
            if name not in qnames:
                continue
            host = t.detach().cpu()
            amax = quant.block_amax(host)
            dev = st.device_amax[name]
            nan = np.isnan(amax)
            if not (np.array_equal(np.isnan(dev), nan) and np.array_equal(
                    dev[~nan].view(np.uint32), amax[~nan].view(np.uint32))):
                fail(f"{name}: the kernel's amax differs from the host "
                     f"amax of the same values")
            q, scale = quant._blockwise(host, amax=amax)
            q_disk = rd.load_tensor(name + "#q8").reshape(-1).numpy()
            s_disk = rd.load_tensor(name + "#scale").numpy()
            ok = s_disk.tobytes() == scale.tobytes()
            finite = ~np.isnan(host.float().reshape(-1).numpy())
            ok = ok and np.array_equal(q_disk[finite], q[finite])
            if not ok:
                fail(f"{name}: int8/scale bytes on disk differ from "
                     f"host-amax quantization")
        print(f"  (b) kernel amax bit-equal to the host amax on all "
              f"{len(qnames)} records; (c) their #q8 and #scale bytes on "
              f"disk equal host-amax quantization "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

        # (d) restore onto the card, within the per-block bound
        like = init_train_state(build_model(cfg), 0, "meta")
        t0 = time.perf_counter()
        got, man = rd.load(like=like, device=device, parallel="auto")
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        t_deq = rd._backend._inner.last_dequantize_seconds
        worst = {}
        for (name, a), (_, b) in zip(flatten(got), leaves):
            if a.dtype != b.dtype or a.shape != b.shape:
                fail(f"restored {name} is {a.dtype}{tuple(a.shape)}")
            if name in qnames:
                bad, err = _q8_bound(b, a)
                if bad:
                    fail(f"restored {name}: {bad} elements beyond the "
                         f"per-block bound (max err {err})")
                worst[str(a.dtype)] = max(worst.get(str(a.dtype), 0.0), err)
            elif not _same_bits(a, b):
                fail(f"restored {name} (not quantized) is not bit-equal")
        if man.extras.get("step") != extras["step"] \
                or man.extras.get("data") != extras["data"]:
            fail(f"restored extras {man.extras}; expected {extras}")
        print(f"  (d) restored onto {device} in {t_restore:.3f} s "
              f"(dequantize {t_deq:.3f} s): {len(qnames)} records within "
              f"the per-block bound (max abs err {worst}), the rest "
              f"bit-equal; step {man.extras['step']}, data "
              f"{man.extras['data']}", flush=True)
        print(f"  (e) bytes on disk {st.total_bytes} vs keyframe {full}; "
              f"(f) seconds: quantize {st.quantize_seconds:.3f} persist "
              f"{st.seconds:.3f} commit {st.commit_seconds:.3f} restore "
              f"{t_restore:.3f} dequantize {t_deq:.3f}", flush=True)
        del got
        rd.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # B2's time inside the save (its 44 launches; comparison launches,
    # after the count was read), and bf16 against f32 packed output on
    # the largest f32 record
    torch.cuda.synchronize()
    ms = _cuda_ms(lambda: quant.launch_amax(leaves), iters=3)
    n_bytes = sum(t.numel() * (t.element_size() + 2)
                  + 4 * -(-t.numel() // quant.BLOCK)
                  for n, t in leaves if n in qnames)
    big = max((t for n, t in leaves
               if n in qnames and t.dtype == torch.float32),
              key=lambda t: t.numel())
    # in turns: bf16, f32, f32, bf16 packed output
    outs = [(str(od)[6:], _cuda_ms(lambda od=od: ops.ckpt_pack(
        big, out_dtype=od, block=quant.BLOCK))) for od in
        (torch.bfloat16, torch.float32, torch.float32, torch.bfloat16)]
    print(f"  B2 in the save: {launches} launches in {ms:.3f} ms "
          f"({n_bytes} B, bytes bound "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms); on the "
          f"{tuple(big.shape)} f32 record, by packed dtype: "
          + ", ".join(f"{od} {t:.3f} ms" for od, t in outs), flush=True)
    return launches


def quantized_chain(cfg, device):
    """Phase 7, the chain: a Trainer with ``delta_quantize`` on ``cfg`` at
    its published widths and 2 layers (its kernel, B1, runs at full width
    in phase 4; the q8 encoding is host code), keyframe_every=2,
    device-dirty, 2 steps; a fresh Trainer restores it, bit-equal outside
    the q8 spans and within the per-block bound inside them."""
    import dataclasses
    import gc

    import torch
    from repro_torch.core.checkpointer import FastPersistConfig
    from repro_torch.core.delta import DeltaSpan
    from repro_torch.core.partition import Topology
    from repro_torch.train.trainer import (CheckpointPolicy, Trainer,
                                           TrainerConfig)
    from repro_torch.tree import flatten

    cfg = dataclasses.replace(cfg, n_layers=2)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_q8_chain_")
    try:
        pol = CheckpointPolicy(
            directory=tmp, every=1, backend="fastpersist-pipelined",
            keyframe_every=2, restore_readers="auto",
            fp=FastPersistConfig(device_dirty=True, delta_quantize=True,
                                 topology=Topology(dp_degree=4,
                                                   ranks_per_node=4)))
        tcfg = TrainerConfig(model=cfg, steps=STEPS, global_batch=BATCH,
                             seq_len=SEQ, checkpoint=pol, log_every=100)
        tr = Trainer(tcfg, device=device)
        t0 = time.perf_counter()
        tr.run()
        wall = time.perf_counter() - t0
        first, second = (h.result() for h in tr.saves)
        if first.delta is not None or second.delta is None:
            fail("the delta_quantize chain is not keyframe + delta")
        spans = [DeltaSpan.from_list(r) for r in second.delta["spans"]]
        n_q8 = sum(s.enc == "q8" for s in spans)
        print(f"  chain: {cfg.name} with {cfg.n_layers} layers, {STEPS} "
              f"steps in {wall:.2f} s; delta {second.delta['dirty_bytes']} "
              f"dirty B packed to {second.total_bytes} B, {n_q8} of "
              f"{len(spans)} spans q8", flush=True)
        if not n_q8:
            fail("no q8 span in the delta_quantize generation")
        live, position = tr.state, tr.data.position
        tr.engine.close()
        del tr
        gc.collect()
        tr2 = Trainer(tcfg, device=device)
        t0 = time.perf_counter()
        step = tr2.restore()
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        if step != STEPS or tr2.data.position != position:
            fail(f"chain restore gave step {step} at {tr2.data.position}")
        q8 = {}
        recs = _stream_offsets(flatten(live))
        for s in spans:
            if s.enc == "q8":
                name, off = next(r for r in reversed(recs)
                                 if r[1] <= s.offset)
                q8.setdefault(name, []).append((s.offset - off, s.length))
        worst = 0.0
        for (name, a), (_, b) in zip(flatten(tr2.state), flatten(live)):
            a, b = a.detach().reshape(-1), b.detach().reshape(-1)
            inside = torch.zeros(a.numel(), dtype=torch.bool,
                                 device=a.device)
            for off, length in q8.get(name, ()):
                lo, n = off // a.element_size(), length // a.element_size()
                bad, err = _q8_bound(b[lo:lo + n], a[lo:lo + n])
                if bad:
                    fail(f"chain restore {name}: {bad} elements beyond the "
                         f"per-block bound (max err {err})")
                worst = max(worst, err)
                inside[lo:lo + n] = True
            if not _same_bits(a[~inside], b[~inside]):
                fail(f"chain restore {name}: bytes outside the q8 spans "
                     f"differ")
        print(f"  chain restored step {step} in {t_restore:.2f} s: q8 spans "
              f"of {len(q8)} records within the per-block bound (max abs "
              f"err {worst}), every other byte bit-equal", flush=True)
        tr2.engine.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- phase 8
def run_mamba2(device):
    """Phase 8: mamba2_370m at full width. Returns the ssd_intra_chunk
    launch count of its kernel forward."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_intra_chunk_plain
    from repro_torch.models import mamba2
    from repro_torch.models.registry import build_model, cross_entropy
    from repro_torch.tree import flatten

    cfg = get_config("mamba2_370m")
    model = build_model(cfg, dtype=torch.float32, use_kernels=True)
    params = model.init(0, device)
    n_params = sum(t.numel() for _, t in flatten(params))
    print(f"phase 8: {cfg.name} at full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, d_state {cfg.ssm.d_state}, head_dim "
          f"{cfg.ssm.head_dim}, chunk {cfg.ssm.chunk}; {n_params} f32 "
          f"params from seed 0)", flush=True)

    # checkpoint round trip through the engine (fastpersist backend)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mamba2_")
    try:
        eng = CheckpointEngine(CheckpointSpec(directory=tmp,
                                              backend="fastpersist"))
        t0 = time.perf_counter()
        st = eng.save(params, 1, {"step": 1}).wait()
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, _ = eng.load(like=model.init(0, "meta"), device=device)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        eng.close()
        for (name, a), (_, b) in zip(flatten(got), flatten(params)):
            if a.shape != b.shape or not torch.equal(_ints(a), _ints(b)):
                fail(f"mamba2 checkpoint: {name} is not bit-equal")
        print(f"  checkpoint: {st.total_bytes} bytes saved in {t_save:.2f} s"
              f", loaded in {t_load:.2f} s; all {len(flatten(got))} records"
              f" bit-equal", flush=True)
        del got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    batch = TokenStream(DataConfig(cfg.vocab_size, M_SEQ, M_BATCH, seed=0),
                        device=device).peek(0)
    with torch.inference_mode():
        _zero_counts()             # just before the kernel forward
        t0 = time.perf_counter()
        logits, _ = model.forward(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.ssd_intra_chunk.launches
        loss = float(cross_entropy(logits, batch["labels"]))
        print(f"  forward batch {M_BATCH} x seq {M_SEQ}: {wall:.3f} s, "
              f"{launches} ssd_intra_chunk launches, loss {loss:.6f}",
              flush=True)
        if launches != cfg.n_layers:
            fail(f"ssd_intra_chunk launched {launches} times; expected "
                 f"{cfg.n_layers}")
        if logits.shape != (M_BATCH, M_SEQ, cfg.vocab_size) \
                or not math.isfinite(loss):
            fail(f"mamba2 logits {tuple(logits.shape)}, loss {loss}")
        want, _ = mamba2.forward(params, cfg, batch, dtype=torch.float32,
                                 ssd_kernel=ssd_intra_chunk_plain)
        _close(f"f32 logits {tuple(logits.shape)} vs the plain hook",
               logits, want, TOL_MODEL, rtol=0.0)
        del logits, want

        # serving: prefill a prompt, greedy-decode, hold against forward
        plain = build_model(cfg, dtype=torch.float32)
        prompt = batch["tokens"][:, :M_PROMPT]
        cache = plain.init_cache(M_BATCH, M_PROMPT + M_NEW, device)
        t0 = time.perf_counter()
        last, cache = plain.prefill(params, {"tokens": prompt}, cache)
        tok = last[:, -1:].argmax(dim=-1).to(torch.int32)
        toks, dec = [tok], []
        for i in range(M_NEW):
            lg, cache = plain.decode(params, tok, cache, M_PROMPT + i)
            dec.append(lg[:, 0])
            tok = lg[:, -1:].argmax(dim=-1).to(torch.int32)
            toks.append(tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seq = torch.cat([prompt] + toks[:M_NEW], dim=1)
        full, _ = model.forward(params, {"tokens": seq})
        print(f"  prefill {M_BATCH} x {M_PROMPT} + {M_NEW} greedy decode "
              f"steps: {wall:.3f} s", flush=True)
        _close("prefill logits vs forward", last[:, 0],
               full[:, M_PROMPT - 1], TOL_DECODE, rtol=0.0)
        _close(f"{M_NEW} decode steps' logits vs forward",
               torch.stack(dec, dim=1), full[:, M_PROMPT:], TOL_DECODE,
               rtol=0.0)
    return launches


def main():
    argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        epilog="Takes no arguments: every phase runs.").parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    print(f"phase 1: card {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    secs = build.build(force=True)
    built = ", ".join(f"{build.source(n).name} in {t:.2f} s"
                      for n, t in secs.items())
    print(f"phase 2: built {built} ({time.perf_counter() - t0:.2f} s wall, "
          f"in parallel)", flush=True)
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # float32 products in full precision (cuDNN is not used)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entries = check_kernels(device)
    entries += [check_attention(device), check_ssd(device)]
    for e in entries[2:]:
        lib = ("none" if e["library_ms"] is None
               else f"{e['library_ms']:.4f} ms")
        fma = ("" if "fma_bound_ms" not in e else
               f"; f32-FMA design bound {e['fma_bound_ms']:.4f} ms")
        print(f"  time {e['name']} {e['shape']}: {e['ms']:.4f} ms (plain "
              f"{e['plain_ms']:.4f} ms, library {lib}, bound "
              f"{e['bound_ms']:.4f} ms by {e['bound_by']}: {e['bytes']} B, "
              f"{e['flops']} FLOP{fma})", flush=True)
    torch.cuda.empty_cache()
    launches, cfg, state, batch, extras = main_path(device, STEPS, BATCH,
                                                    SEQ)
    launches["flash_attention"] = score_restored(cfg, state, batch)
    del batch
    torch.cuda.empty_cache()
    launches["ckpt_pack_blocks"] = quantized_save(cfg, state, extras, device)
    del state
    torch.cuda.empty_cache()
    quantized_chain(cfg, device)
    torch.cuda.empty_cache()
    launches["ssd_intra_chunk"] = run_mamba2(device)
    for e in entries:
        e["launches"] = launches[e["name"]]
    print(f"every phase passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [
        {k: v for k, v in e.items()
         if k not in ("shape", "bytes", "flops", "fma_bound_ms")}
        for e in entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
