#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each of which exits non-zero on failure:

1. the card: name and power limit (``nvidia-smi``);
2. build: compile the three CUDA sources of ``src/repro_torch`` (one
   ``nvcc`` each, in parallel), with each kernel's registers and spills
   (``ptxas -v``), dynamic shared memory per block, and the tensor-core
   (HMMA) and FFMA instructions of each flash_attention body in its SASS
   (``cuobjdump``);
3. kernels: every kernel held against its plain PyTorch version on the
   card — ckpt_pack bit-exact at the shapes of the main path plus ragged,
   NaN, ±0.0, all-clean and one-dirty cases; flash_attention (bf16 on
   its bf16 tensor-core body, f32 on its 3xTF32 tensor-core body, at
   head dims 64, 80, 96 and 128 — the path's, gpt3_2_7b's and
   gpt3_0_7b's widths among them — and every variant in both; SDPA
   timed on the path's bf16 and f32 inputs, the f32 body and SDPA f32
   also at the two GPT-3 widths)
   and ssd_intra_chunk (B and C per head, from one group expanded over
   the heads as the path passes them, two groups repeated, ragged
   chunks) within the reference's tolerances at the paths' shapes and
   the reference's sweep, each check with its largest share of the
   allowance — with CUDA-event times (and times replayed from a CUDA
   graph, for the kernel and its library call alike) beside the bound,
   the plain version and the library call where there is one;
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
   flash_attention launch counts read around it; then a second, warm
   bf16 loss and f32 forward timed beside the first, with B3's share of
   each;
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
   plain hook (ssd_intra_chunk launch counts read around it), a second,
   warm forward timed beside the first with B4's share of it, and a
   batch-4 x 512 prefill + 16 greedy decode steps against the forward;
9. the durability tiers: ``stablelm_1_6b`` at its published widths and
   the deepest depth (at least 2 layers) at which keyframe + delta fit
   twice on the disk (local, object store; within 75 % of the free disk
   and 90 % of phase 4's peak) and twice in memory (two peers holding
   their replicas in a tmpfs directory; within 40 % of the available
   memory),
   trained 2 steps through ``fastpersist-tiered-pipelined`` with
   device-dirty deltas (ckpt_pack_dirty_blocks launches counted on the
   delta), two peers in distinct failure domains and retention
   ``keep_last=1``; the local directory lost, a restore from a peer onto
   the card, then (local lost again, peers gone) one from the store,
   each bit-equal to the state saved at that step; the embedding served
   from the store through the read cache, cold and warm; and the
   keyframe read as 4 ranks' owned spans, allgathered onto the card,
   bit-equal to ``load``.

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
#: rate, dense bf16 and TF32 tensor-core rates, f32 rate outside the
#: tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
#: the fastest route to products of the reference's f32 accuracy (1e-4
#: on ssd_intra_chunk): each f32 product split into three TF32 products
#: (hi·hi + hi·lo + lo·hi), as the kernel does. Three bf16 products miss
#: 1e-4 (tests/test_torch_mamba2.py), and six (a three-way bf16 split)
#: run at the same 989/6 = 495/3 TFLOP/s.
F32_SPLIT_FLOPS = TF32_FLOPS / 3
CSRC = "src/repro_torch/kernels/csrc"
#: layers/mlp/wi of stablelm_1_6b: the largest bf16 record of the main path
BIG = (24, 2048, 5632)
#: main path: steps (1 keyframe + 1 delta save), global batch, sequence
STEPS, BATCH, SEQ = 2, 4, 512
#: attention of stablelm_1_6b on the main path's batch: (B, H, L, hd)
ATTN = (BATCH, 32, SEQ, 64)
#: the same batch at the published widths of the two configs whose head
#: dims are neither 64 nor 128: gpt3_2_7b (2560 / 32) and gpt3_0_7b (1536
#: / 16)
ATTN_GPT3 = {"gpt3_2_7b": (BATCH, 32, SEQ, 80),
             "gpt3_0_7b": (BATCH, 16, SEQ, 96)}
#: mamba2_370m: batch x sequence of the forward, prompt and new tokens
#: of the decode check, and ssd_intra_chunk's (b, nc, cl, h, p, n) there
#: (B and C from its one group, expanded over the 32 heads)
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


def _close(name, got, want, tol, rtol=None, quiet=False, shares=None):
    """Fail unless |got - want| <= tol + rtol·|want| everywhere (rtol
    defaults to tol) and both are finite; returns the largest absolute
    difference (printed unless ``quiet``) and appends the largest share
    of the allowance to ``shares`` if given."""
    import torch
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{name}: non-finite values")
    rtol = tol if rtol is None else rtol
    err = (got - want).abs()
    allowed = tol + rtol * want.abs()
    bad = int((err > allowed).sum())
    worst = float(err.max())
    share = float((err / allowed).max())
    if bad:
        fail(f"{name}: {bad} elements beyond tolerance {tol} (rtol {rtol};"
             f" max abs err {worst})")
    if shares is not None:
        shares.append(share)
    if not quiet:
        print(f"  ok {name}: tol {tol} (rtol {rtol}), max_abs_err {worst}, "
              f"largest share of the allowance {share:.3f}", flush=True)
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


def _graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph
    and replayed, so the host's issue time of each call is left out (a
    wrapper's Python work can take longer than a short kernel)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                           # warm, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _cuda_ms(graph.replay, 5) / iters


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
    path's shape and at gpt3_2_7b's and gpt3_0_7b's widths (bf16 and f32,
    the model's strided views) and at the reference's sweep and variants
    (tests/test_kernels.py:126-166, at its tolerances), at head dims 64,
    80, 96 and 128. Times the f32 body beside SDPA f32 at the three
    widths. Returns the ``kernels`` entry (launches filled in by phase
    6)."""
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
    shares = {torch.bfloat16: [], torch.float32: []}
    widths = {"path": ATTN, **ATTN_GPT3}
    cases = [(name, (B, H, H, L, L, hd), {})
             for name, (B, H, L, hd) in widths.items()]
    cases += [("sweep", (B, H, KV, L, L, hd), {}) for B, H, KV, L, hd in (
        (1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 1, 384, 128),
        (1, 2, 2, 100, 64), (1, 4, 2, 200, 128))]
    cases += [("variant", (1, 4, 2, 256, 256, 64), kw) for kw in (
        {"window": 64}, {"cap": 50.0}, {"causal": False},
        {"window": 32, "cap": 30.0})]
    cases += [("variant", (1, 4, 4, 128, 512, 64), {"causal": False}),
              ("variant", (1, 2, 2, 256, 128, 64), {"window": 32}),
              ("variant", (2, 2, 2, 77, 300, 128), {"causal": False})]
    for hd in (80, 96):
        cases += [("variant", (1, 4, 2, 200, 200, hd),
                   {"window": 48, "cap": 30.0}),
                  ("variant", (2, 2, 2, 77, 300, hd), {"causal": False})]
    print("  flash_attention (B3) against flash_attention_plain (bf16: "
          "bf16 tensor-core body; f32: 3xTF32 tensor-core body):",
          flush=True)
    for kind, shape, kw in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = qkv(*shape, dtype)
            got = ops.flash_attention(q, k, v, **kw)
            want = flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            tol = (TOL_ATTN_BF16 if dtype == torch.bfloat16 else
                   TOL_ATTN_VARIANT if kind == "variant" else TOL_ATTN_F32)
            err = max(err, _close(f"{kind} {str(dtype)[6:]} {shape} {kw}",
                                  got, want, tol, shares=shares[dtype]))
    print(f"  largest share of the allowance over the {len(cases)} cases: "
          f"bf16 {max(shares[torch.bfloat16]):.3f}, f32 "
          f"{max(shares[torch.float32]):.3f}", flush=True)

    def timed(B, H, L, hd, dtype, plain=False):
        """Kernel and SDPA (the yardstick only: the port never calls it)
        on the same causal inputs, events and in a CUDA graph, the plain
        version too if ``plain``, and the kernel's bound: f32 products
        at three TF32 products each."""
        q, k, v = qkv(B, H, H, L, L, hd, dtype)
        n_bytes = 4 * B * H * L * hd * q.element_size()
        flops = 4 * hd * B * H * L * (L + 1) // 2    # causal pairs only
        rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_SPLIT_FLOPS
        bound_ms, bound_by = _bound(n_bytes, flops / rate)

        def kernel():
            return ops.flash_attention(q, k, v)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)
        t = {"ms": _cuda_ms(kernel), "graph_ms": _graph_ms(kernel),
             "library_ms": _cuda_ms(sdpa), "library_graph_ms": _graph_ms(sdpa),
             "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes,
             "flops": flops}
        if plain:
            t["plain_ms"] = _cuda_ms(lambda: flash_attention_plain(q, k, v))
        print(f"  time flash_attention {str(dtype)[6:]} causal "
              f"{(B, H, L, hd)}: {t['ms']:.4f} ms (in a CUDA graph "
              f"{t['graph_ms']:.4f} ms); SDPA {t['library_ms']:.4f} ms (in a "
              f"CUDA graph {t['library_graph_ms']:.4f} ms)"
              + (f"; plain {t['plain_ms']:.4f} ms" if plain else "") +
              f"; bound {bound_ms:.4f} ms by {bound_by} ({n_bytes} B, "
              f"{flops} FLOP at {rate / 1e12:.0f} TFLOP/s)", flush=True)
        return t

    # the f32 body (phase 6's f32 scoring) at the three widths, then the
    # path's bf16 body: the entry's own numbers
    f32 = timed(*ATTN, torch.float32, plain=True)
    for B, H, L, hd in ATTN_GPT3.values():
        for dtype in (torch.float32, torch.bfloat16):
            timed(B, H, L, hd, dtype)
    bf = timed(*ATTN, torch.bfloat16, plain=True)
    return {"name": "flash_attention", "route": "cuda",
            "source": f"{CSRC}/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:66",
            "launches": 0, "max_abs_err": err, "ms": bf["ms"],
            "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
            "bound_by": bf["bound_by"], "library_ms": bf["library_ms"],
            "f32_ms": f32["ms"], "f32_graph_ms": f32["graph_ms"],
            "f32_plain_ms": f32["plain_ms"],
            "f32_bound_ms": f32["bound_ms"], "f32_bound_by": f32["bound_by"],
            "f32_library_ms": f32["library_ms"],
            "shape": f"bf16 causal {ATTN}", "bytes": bf["bytes"],
            "flops": bf["flops"], "graph_ms": bf["graph_ms"],
            "library_graph_ms": bf["library_graph_ms"]}


def check_ssd(device) -> dict:
    """Phase 3, B4: ssd_intra_chunk against its plain version at
    mamba2_370m's shape (batch 4 x 2048, B and C from one group expanded
    over the heads, as ``ssd_chunked`` passes them), the reference's
    sweep (tests/test_kernels.py:170-174), two groups repeated per head,
    ragged chunks (cl 100; cl 16 as in the reduced config) and state
    sizes that are not a multiple of 8 (zero-padded) or of 4 (copied 4
    bytes at a time), at the reference's 1e-4. Returns the ``kernels`` entry (launches filled in by
    phase 8)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_intra_chunk_plain
    gen = torch.Generator(device=device).manual_seed(2)

    def inputs(b, nc, cl, h, p, n, groups=None):
        """groups None: B and C per head; 1: one group expanded (head
        stride 0); g > 1: g groups repeated per head."""
        xc = torch.randn((b, nc, cl, h, p), generator=gen, device=device)
        dAc = -torch.randn((b, nc, cl, h), generator=gen,
                           device=device).abs() * 0.1
        gh = h if groups is None else groups
        Bc, Cc = (torch.randn((b, nc, cl, gh, n), generator=gen,
                              device=device) for _ in range(2))
        if groups == 1:
            Bc, Cc = (t.expand(b, nc, cl, h, n) for t in (Bc, Cc))
        elif groups is not None:
            Bc, Cc = (t.repeat_interleave(h // groups, dim=3)
                      for t in (Bc, Cc))
        return xc, dAc, Bc, Cc

    err = 0.0
    print("  ssd_intra_chunk (B4) against ssd_intra_chunk_plain:",
          flush=True)
    for shape, groups in ((SSD, 1), (SSD, None), ((1, 2, 64, 2, 32, 16),
                          None), ((2, 4, 128, 4, 64, 32), None),
                          ((1, 1, 256, 8, 64, 64), None),
                          ((1, 2, 256, 8, 64, 128), 2),
                          ((1, 2, 100, 4, 128, 20), 1),
                          ((1, 1, 64, 2, 32, 18), 1),
                          ((2, 3, 16, 4, 32, 16), 1)):
        args = inputs(*shape, groups=groups)
        got = ops.ssd_intra_chunk(*args)
        want = ssd_intra_chunk_plain(*args)
        torch.cuda.synchronize()
        err = max(err, _close(f"f32 (b, nc, cl, h, p, n) = {shape}, "
                              f"groups {groups}", got, want, TOL_SSD))
    args = inputs(*SSD, groups=1)        # the path's layout
    ms = _cuda_ms(lambda: ops.ssd_intra_chunk(*args))
    graph_ms = _graph_ms(lambda: ops.ssd_intra_chunk(*args))
    plain_ms = _cuda_ms(lambda: ssd_intra_chunk_plain(*args))
    b, nc, cl, h, p, n = SSD
    rows = b * nc * cl
    # x, y and dA per head; B and C once, for the one group the path has
    n_bytes = 4 * rows * (h * (2 * p + 1) + 2 * n)
    per_head_bytes = 4 * rows * h * (2 * p + 2 * n + 1)
    pairs = b * nc * h * cl * (cl + 1) // 2          # s <= l only
    # C·Bᵀ once per group (the path has one), then per head with X
    products = pairs // h * 2 * n + pairs * 2 * p
    flops = products + pairs             # and the decay's multiply
    bound_ms, bound_by = _bound(
        n_bytes, products / F32_SPLIT_FLOPS + pairs / F32_FLOPS)
    return {"name": "ssd_intra_chunk", "route": "cuda",
            "source": f"{CSRC}/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:40",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "shape": f"f32 (b, nc, cl, h, p, n) = {SSD}, B and C from one "
                     f"group", "bytes": n_bytes,
            "bytes_per_head": per_head_bytes, "flops": flops,
            "graph_ms": graph_ms}


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
    batch (for phase 6), the extras a save of it carries (phase 7) and
    the bytes its two generations held on the disk together (phase 9's
    disk budget)."""
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
                {"step": step, "data": tr2.data.state()},
                first.total_bytes + second.total_bytes)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- phase 6
def score_restored(cfg, state, batch, kernel_ms: float, kernel_ms32: float):
    """Phase 6: score the restored state with the kernel forward path
    (``build_model(use_kernels=True)``) on the trainer's next batch, in
    bf16 on the bf16 params and in f32 on the master weights, against the
    same forward through ``flash_attention_plain``. Returns the
    flash_attention launch count of the phase. Then a second, warm call
    of the bf16 loss and of the f32 forward (after the count is read) is
    timed beside the first, with B3's share at phase 3's ``kernel_ms``
    (bf16) and ``kernel_ms32`` (f32) per launch.

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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model32.forward(state.opt.master, batch)
        torch.cuda.synchronize()
        wall32 = time.perf_counter() - t0
        n = ops.flash_attention.launches - n
        if n != cfg.n_layers:
            fail(f"the f32 forward launched flash_attention {n} times; "
                 f"expected {cfg.n_layers}")
        if logits.shape != (*batch["tokens"].shape, cfg.vocab_size):
            fail(f"f32 logits of shape {tuple(logits.shape)}")
        want = plain_forward(state.opt.master, torch.float32)
        _close(f"f32 logits {tuple(logits.shape)} ({n} launches)", logits,
               want, TOL_MODEL, rtol=0.0)
        del logits, want
    torch.cuda.synchronize()
    launches = ops.flash_attention.launches
    with torch.inference_mode():
        t0 = time.perf_counter()
        warm_loss = float(model.loss(state.params, batch))
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        model32.forward(state.opt.master, batch)
        torch.cuda.synchronize()
        warm32 = time.perf_counter() - t0
    for what, first, again, per in (
            (f"bf16 loss (loss {warm_loss:.6f})", wall, warm, kernel_ms),
            ("f32 forward", wall32, warm32, kernel_ms32)):
        share = cfg.n_layers * per
        print(f"  {what}: first call {first:.4f} s, warm call {again:.4f} "
              f"s; B3's {cfg.n_layers} launches at phase 3's {per:.4f} ms: "
              f"{share:.3f} ms, {100 * share / 1e3 / again:.1f} % of the "
              f"warm call", flush=True)
    return launches


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
def run_mamba2(device, kernel_ms: float):
    """Phase 8: mamba2_370m at full width. Returns the ssd_intra_chunk
    launch count of its kernel forward; a second, warm forward (after the
    count is read) is timed beside the first, with B4's share at phase
    3's ``kernel_ms`` per launch."""
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
        t0 = time.perf_counter()
        model.forward(params, batch)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        share = cfg.n_layers * kernel_ms
        print(f"  forward: first call {wall:.3f} s, warm call {warm:.3f} s;"
              f" B4's {cfg.n_layers} launches at phase 3's {kernel_ms:.4f} "
              f"ms: {share:.3f} ms, {100 * share / 1e3 / warm:.1f} % of the "
              f"warm call", flush=True)

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


# ---------------------------------------------------------------- phase 9
#: the two peers keep their replicas in memory, as a peer's RAM tier
#: would: a tmpfs directory; the local checkpoint and the object store
#: are on the disk
PEER_ROOT = "/dev/shm"
#: the served tensor of phase 9 (100352 x 2048 bf16) and the read cache
SERVED, SERVE_CACHE_MB = ".params/embed", 512


def _tier_depth(cfg, disk_budget: float, mem_budget: float) -> int:
    """The deepest n_layers at which keyframe + delta fit twice on the
    disk (local and object store) within ``disk_budget`` bytes and twice
    in memory (the two peers) within ``mem_budget`` bytes. Both
    generations are counted at the full state's size (14 B per
    parameter: bf16 param, f32 master, m, v); the delta is ~91 % of it,
    since Adam changes master, m and v every step."""
    per_layer = cfg._layer_params(0) * 14
    fixed = cfg.param_count() * 14 - cfg.n_layers * per_layer
    state = min(disk_budget, mem_budget) / 4     # 2 copies x (K + D)
    return min(cfg.n_layers, int((state - fixed) // per_layer))


def _same_state(what, got, want):
    """Fail unless two {name: tensor} sets hold the same records with the
    same bits (on the card)."""
    import torch
    got, want = dict(got), dict(want)
    if sorted(got) != sorted(want):
        fail(f"{what}: other records than the saved state")
    for name, b in want.items():
        a = got[name]
        if a.device.type != "cuda":
            fail(f"{what}: {name} is on {a.device}, not on the card")
        if a.dtype != b.dtype or a.shape != b.shape \
                or not torch.equal(_ints(a.detach()), _ints(b.detach())):
            fail(f"{what}: {name} is not bit-equal to the saved state")


def tiers(device, disk_peak: int) -> int:
    """Phase 9: the durability tiers on the card. ``disk_peak``: the
    bytes phase 4's generations held on the disk; this phase keeps its
    own disk peak under 90 % of it, so the run's peak disk use stays
    phase 4's. Returns the ckpt_pack_dirty_blocks launches of the tiered
    delta save."""
    import dataclasses
    import gc
    import os

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.checkpointer import (FastPersistConfig,
                                               allgather_owned)
    from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
    from repro_torch.core.partition import Topology
    from repro_torch.core.retention import RetentionPolicy
    from repro_torch.core.serializer import deserialize
    from repro_torch.kernels import ckpt_pack as cp
    from repro_torch.train.trainer import (CheckpointPolicy, Trainer,
                                           TrainerConfig)
    from repro_torch.tree import flatten

    cfg = get_config("stablelm_1_6b")
    if not os.path.isdir(PEER_ROOT):
        fail(f"no {PEER_ROOT} for the peers' in-memory replicas")
    root = tempfile.mkdtemp(prefix="chip_smoke_tiers_")
    peer_root = tempfile.mkdtemp(prefix="chip_smoke_peers_", dir=PEER_ROOT)
    try:
        free = shutil.disk_usage(root).free
        mem = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        disk_budget = min(0.75 * free, 0.9 * disk_peak)
        n = _tier_depth(cfg, disk_budget, 0.4 * mem)
        print(f"phase 9: durability tiers; {free} B free on the disk "
              f"(phase 4 held {disk_peak} B), {mem} B of memory available "
              f"(the peers' replicas live in {PEER_ROOT}); full state "
              f"{cfg.param_count() * 14} B", flush=True)
        if n < 2:
            fail(f"keyframe + delta of a 2-layer {cfg.name} do not fit "
                 f"twice in {disk_budget:.0f} B of disk and twice in "
                 f"{0.4 * mem:.0f} B of memory")
        print(f"  CUT: n_layers {cfg.n_layers} -> {n} (depth {n}) so "
              f"keyframe + delta fit twice on the disk (local, object "
              f"store) in min(75 % of the free disk, 90 % of phase 4's "
              f"peak) and twice in memory (2 peers) in 40 % of the "
              f"available memory (widths unchanged)" if n < cfg.n_layers
              else f"  depth {n}: no cut", flush=True)
        cfg = dataclasses.replace(cfg, n_layers=n)
        local, bucket = (os.path.join(root, d) for d in ("local", "bucket"))
        peer_dirs = [os.path.join(peer_root, f"peer{i}") for i in range(2)]
        pol = CheckpointPolicy(
            directory=local, every=1,
            backend="fastpersist-tiered-pipelined", keyframe_every=2,
            upload=bucket, replicate_peers=[f"peer{i}={d}@rack{i}" for
                                            i, d in enumerate(peer_dirs)],
            replication_factor=2, failure_domain="rack-trainer",
            retention=RetentionPolicy(keep_last=1), restore_readers="auto",
            fp=FastPersistConfig(device_dirty=True, topology=Topology(
                dp_degree=4, ranks_per_node=4)))
        tcfg = TrainerConfig(model=cfg, steps=STEPS, global_batch=BATCH,
                             seq_len=SEQ, checkpoint=pol, log_every=100)
        tr = Trainer(tcfg, device=device)
        tr.init_state()
        n_kernel = _kernel_records(tr, pol.fp.dirty_block)
        _zero_counts()             # just before the tiered path
        t0 = time.perf_counter()
        tr.run()                   # drains the upload and peer tiers too
        wall = time.perf_counter() - t0
        launches = cp.ckpt_pack_dirty_blocks.launches
        print(f"  trained {cfg.name} ({n} layers) {STEPS} steps of "
              f"{BATCH} x {SEQ} through {pol.backend} in {wall:.2f} s, "
              f"uploads and replication drained", flush=True)
        for h in tr.saves:
            st, up, rep = h.result(), h.wait_uploaded(), h.wait_replicated()
            print(f"  save step {st.step}: "
                  f"{'delta' if st.delta else 'keyframe'} "
                  f"{st.total_bytes} B, persist {st.seconds:.3f} s + commit "
                  f"{st.commit_seconds:.3f} s; upload {up.bytes_uploaded} B "
                  f"in {up.seconds:.3f} s ({up.n_uploaded} objects, "
                  f"{up.n_deduped} deduped); replication {rep.bytes_sent} B "
                  f"to {rep.replicas} peers in {rep.seconds:.3f} s", flush=True)
            if not (up.committed and rep.committed and rep.replicas == 2):
                fail(f"step {st.step} is not durable on both tiers")
        if [h.result().delta is not None for h in tr.saves] != [False, True]:
            fail("the tiered chain is not keyframe + delta")
        print(f"  ckpt_pack_dirty_blocks launches on the tiered delta: "
              f"{launches} (records through the kernel: {n_kernel})",
              flush=True)
        if launches != n_kernel:
            fail(f"ckpt_pack_dirty_blocks launched {launches} times on the "
                 f"tiered delta; expected {n_kernel}")
        tr._retain.after_commit()
        print(f"  retention keep_last=1: collected steps "
              f"{tr._retain.deleted}, local steps {tr.engine.steps()} (the "
              f"delta's keyframe stays)", flush=True)
        live = dict(flatten(tr.state))
        position = tr.data.position
        tr.engine.close()
        del tr
        gc.collect()

        def restore(tier):
            shutil.rmtree(local)
            t = Trainer(tcfg, device=device)
            t0 = time.perf_counter()
            step = t.restore(tier=tier)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            hs = t.engine.last_hydrate_stats
            print(f"  restore from the {tier} tier: step {step} in "
                  f"{wall:.2f} s, of which hydration {hs.seconds:.2f} s "
                  f"({hs.fetched_bytes} B fetched in {hs.n_fetched} objects,"
                  f" {hs.reused_bytes} B reused, steps {hs.steps})",
                  flush=True)
            if step != STEPS or t.data.position != position:
                fail(f"{tier} restore gave step {step} at data position "
                     f"{t.data.position}; expected {STEPS} at {position}")
            if hs.fetched_bytes == 0 or hs.reused_bytes != 0:
                fail(f"{tier} restore did not move the bytes")
            _same_state(f"{tier} restore", flatten(t.state), live)
            print(f"  {len(live)} records bit-equal on the card to the "
                  f"state saved at step {step}", flush=True)
            return t

        restore("peer").engine.close()
        gc.collect()
        for d in peer_dirs:        # the peers are lost too
            shutil.rmtree(d)
        t = restore("remote")
        del live
        t.state = None
        gc.collect()
        torch.cuda.empty_cache()

        # owned reads: 4 simulated ranks of the keyframe, ZeRO-1 spans
        t0 = time.perf_counter()
        reads = [t.engine.load_owned(r, 4, step=1, ownership="zero1")
                 for r in range(4)]
        t_read = time.perf_counter() - t0
        t0 = time.perf_counter()
        stream = allgather_owned(reads)
        owned = {k: v.to(device) for k, v in
                 deserialize(reads[0].manifest, stream).items()}
        torch.cuda.synchronize()
        t_gather = time.perf_counter() - t0
        keyframe, _ = t.engine.load(1, device=device)
        _same_state("owned-read allgather", owned, keyframe)
        print(f"  owned reads of the keyframe, 4 ranks (zero1): "
              f"{[r.nbytes for r in reads]} B in {t_read:.2f} s; allgather "
              f"onto the card {t_gather:.2f} s; {len(owned)} records "
              f"bit-equal to load()", flush=True)
        del owned, stream, reads
        t.engine.close()

        # serving: one tensor straight off the store, cold then warm
        eng = CheckpointEngine(CheckpointSpec(
            directory=os.path.join(root, "serve"), upload_store=bucket,
            serve_cache_mb=SERVE_CACHE_MB))
        for kind in ("cold", "warm"):
            got = eng.load_tensor(SERVED, step=1, tier="remote",
                                  device=device)
            torch.cuda.synchronize()
            st = eng.last_serve[-1]
            print(f"  served {SERVED} {tuple(got.shape)} {got.dtype} from "
                  f"the store ({kind}, cache {SERVE_CACHE_MB} MiB): "
                  f"{st.tensor_bytes} B in {st.seconds:.3f} s, "
                  f"{st.fetched_bytes} B fetched, {st.cache_hit_bytes} B "
                  f"from the cache, {st.n_spans} spans", flush=True)
            _same_state(f"served {SERVED} ({kind})", {SERVED: got},
                        {SERVED: keyframe[SERVED]})
            if kind == "warm" and (st.fetched_bytes != 0 or
                                   st.cache_hit_bytes < st.tensor_bytes):
                fail("the warm served read did not come from the cache")
        eng.close()
        if eng.steps():
            fail("serving a tensor hydrated a local checkpoint")
        del keyframe, got
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(peer_root, ignore_errors=True)


def sass_check():
    """Phase 2: the instructions of each flash_attention body in the SASS
    that ``cuobjdump`` reads from the built library. Fails unless every
    body does its products on the tensor cores (HMMA: bf16 in the bf16
    body, TF32 in the f32 one); the FFMA count is printed beside them
    (the softmax's exp2f and the f32 output's division use FFMA)."""
    import re
    from collections import Counter

    from repro_torch.kernels import build
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print(f"  sass: {tool} not found, SASS not read", flush=True)
        return
    sass = subprocess.run(
        [str(tool), "-sass", str(build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True).stdout
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0]
        kernel = re.search(r"(flash_tc_kernel|flash_tf32_kernel)ILi(\d+)E",
                           name)
        if kernel is None:
            continue
        ops = Counter(re.findall(
            r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", body,
            re.M))
        hmma = {o: n for o, n in ops.items() if o.startswith("HMMA")}
        ffma = sum(n for o, n in ops.items() if o.split(".")[0] == "FFMA")
        print(f"  sass {kernel[1]} hd {kernel[2]}: {hmma}, FFMA {ffma}",
              flush=True)
        want = "TF32" if kernel[1] == "flash_tf32_kernel" else "BF16"
        if not any(o.endswith(want) for o in hmma):
            fail(f"{kernel[1]} hd {kernel[2]}: no HMMA {want} in its SASS")


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
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"  ptxas {name}: {line.strip()}")
    from repro_torch.kernels import flash_attention as fa, ssd_scan
    smem = {f"flash_attention {dt} hd {hd}": fa.smem_bytes(hd, dt)
            for dt in (torch.bfloat16, torch.float32) for hd in fa.HEAD_DIMS}
    smem[f"ssd_intra_chunk {SSD} (C Bᵀ, per head)"] = ssd_scan.smem_bytes(
        SSD[2], SSD[4], SSD[5])
    print(f"  dynamic shared memory per block, bytes: {smem}", flush=True)
    sass_check()

    # float32 products in full precision (cuDNN is not used)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entries = check_kernels(device)
    entries += [check_attention(device), check_ssd(device)]
    for e in entries[2:]:
        lib = ("none" if e["library_ms"] is None
               else f"{e['library_ms']:.4f} ms (in a CUDA graph "
                    f"{e['library_graph_ms']:.4f} ms)")
        per_head = ("" if "bytes_per_head" not in e else
                    f" ({e['bytes_per_head']} B if read per head)")
        print(f"  time {e['name']} {e['shape']}: {e['ms']:.4f} ms (in a "
              f"CUDA graph {e['graph_ms']:.4f} ms; plain "
              f"{e['plain_ms']:.4f} ms, library {lib}, bound "
              f"{e['bound_ms']:.4f} ms by {e['bound_by']}: {e['bytes']} B"
              f"{per_head}, {e['flops']} FLOP)", flush=True)
    torch.cuda.empty_cache()
    launches, cfg, state, batch, extras, disk_peak = main_path(
        device, STEPS, BATCH, SEQ)
    ms = {e["name"]: e["ms"] for e in entries}
    launches["flash_attention"] = score_restored(
        cfg, state, batch, ms["flash_attention"], entries[2]["f32_ms"])
    del batch
    torch.cuda.empty_cache()
    launches["ckpt_pack_blocks"] = quantized_save(cfg, state, extras, device)
    del state
    torch.cuda.empty_cache()
    quantized_chain(cfg, device)
    torch.cuda.empty_cache()
    launches["ssd_intra_chunk"] = run_mamba2(device, ms["ssd_intra_chunk"])
    torch.cuda.empty_cache()
    tiers(device, disk_peak)
    for e in entries:
        e["launches"] = launches[e["name"]]
    print(f"every phase passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [
        {k: v for k, v in e.items()
         if k not in ("shape", "bytes", "bytes_per_head", "flops",
                      "graph_ms", "library_graph_ms")}
        for e in entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
