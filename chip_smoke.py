#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each of which exits non-zero on failure:

1. the card: name and power limit (``nvidia-smi``);
2. build: compile the four CUDA sources of ``src/repro_torch`` (one
   ``nvcc`` each, in parallel), with each kernel's registers and spills
   (``ptxas -v``), dynamic shared memory per block, and the tensor-core
   (HMMA) and FFMA instructions of each flash_attention body in its SASS
   (``cuobjdump``);
3. kernels: every kernel held against its plain PyTorch version on the
   card — ckpt_pack bit-exact at the shapes of the main path plus ragged,
   NaN, ±0.0, all-clean and one-dirty cases; flash_attention (bf16 on
   its bf16 tensor-core body, f32 on its 3xTF32 tensor-core body, at
   head dims 64, 80, 96 and 128 — the path's, gpt3_2_7b's and
   gpt3_0_7b's widths among them — and every variant in both; bf16 at
   internvl2_26b's GQA 6:1 shape, 48 heads on 8 of 128; SDPA
   timed on the path's bf16 and f32 inputs, the f32 body and SDPA f32
   also at the two GPT-3 widths, the bf16 body and SDPA (GQA) also at
   internvl2_26b's)
   and ssd_intra_chunk (B and C per head, from one group expanded over
   the heads as the paths pass them — mamba2_370m's n 128 with 32 heads
   and zamba2_2_7b's n 64 with 80 —, two groups repeated, ragged
   chunks) within the reference's tolerances at the paths' shapes and
   the reference's sweep, each check with its largest share of the
   allowance — with CUDA-event times (and times replayed from a CUDA
   graph, for the kernel and its library call alike) beside the bound,
   the plain version and the library call where there is one; and the
   fused Adam update (adam_update_, no TPU counterpart) bit-equal to its
   plain version on every leaf of the main path's model over two steps,
   with f32 and bf16 gradients, timed there and at the 2.7B benchmark
   cell's leaves beside its bytes bound, the plain version and the
   library's fused AdamW; then flash_attention's backward (two bf16
   tensor-core kernels, no TPU counterpart) and the forward's
   log-sum-exp at the benchmark cells' train-step shapes, internvl2_26b's
   GQA 6:1 and the main path's, against the plain versions and autograd
   of ``layers.attention``, timed beside its bound, the plain version
   and SDPA's backward;
4. main path: ``repro_torch`` Trainer on ``stablelm_1_6b`` at full width
   on ``cuda``, checkpointing every step (fastpersist-pipelined,
   keyframe_every=2, device-dirty), with the kernels' launch counts
   read around it (the fused Adam update once a leaf a step; the
   attention's forward and backward kernels once a layer a micro-batch);
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
7. quantized save: first the quantize kernel (ckpt_quant_blocks, B2's
   quantize mode) held bit-equal to its plain version on the card — on
   the largest record of each dtype of the state, a ragged cut of each,
   and tie, zero, -0.0, subnormal and ragged blocks in f32, bf16 and f16
   (on NaN and inf blocks the scales only) — and timed; then the
   restored state saved with ``quantize=True`` (int8 per block of 4096,
   quantized on the card before the snapshot: its launches read around
   the save, no host quantize, ``d2h_bytes`` the quantized stream's,
   no device memory of the save held once its snapshot is released),
   each record's B2 amax (the route the save took before; a check, its
   launches not counted, so B2's pack mode reports the 0 launches of
   the paths) held bit for bit against the host amax, the int8 and
   scale bytes on disk against
   host quantization, a restore onto the card dequantized there within
   the quantizer's per-block bound and bit-equal to the host dequantize
   on the sampled records, the seconds, bytes and peak device memory
   printed; then a ``delta_quantize`` chain (2 layers at published
   widths, device-dirty) restored within the same bound on its q8
   spans;
8. mamba2_370m at full width: init from a seed, a checkpoint round trip
   through the engine, the kernel forward at batch 4 x 2048 against the
   plain hook (ssd_intra_chunk launch counts read around it), a second,
   warm forward timed beside the first with B4's share of it, and a
   batch-4 x 512 prefill + 16 greedy decode steps against the forward;
9. the durability tiers: ``stablelm_1_6b`` at its published widths and
   the deepest depth, at most 2 layers, at which keyframe + delta fit
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
   bit-equal to ``load``;
10. the paper's own models (its Table 2) at their published widths:
   ``gpt3_1_8b_moe`` cut to 4 of its 24 layers, trained 2 steps
   through ``fastpersist-pipelined`` with one keyframe save, restored
   bit-equal by a fresh Trainer and scored through flash_attention at
   head dim 64 (each layer's attention output against the plain version,
   the bf16 loss against the plain forward's, tokens per expert, dropped
   and routed elsewhere per layer); ``gpt3_2_7b`` (head dim 80) and
   ``gpt3_0_7b`` (96) at full depth from a seed, scored the same way in
   bf16, ``gpt3_2_7b`` also in f32 (each layer at the f32 kernel
   tolerance) and decoded in f32: a 4 x 512 prefill and 16 greedy steps,
   each step's logits against the forward over the same tokens; B3's
   launches counted around each kernel path, each part timed;
11. the remaining decoder families at their published widths, one model
   on the card at a time: ``zamba2_2_7b`` at full depth from a seed (its
   f32 params through the engine and back bit-equal, the kernel forward
   at 4 x 2048 against the plain hook with B4's launches counted, one per
   SSM block, at its n 64 and 80 heads, a warm call timed with B4's
   share, a 4 x 512 prefill and 16 greedy decode steps against the
   forward); ``gemma2_9b`` in f32 as deep as the card holds (at least
   two local/global pairs), a 1 x 4608 prompt past its 4096 window
   prefilled through the paired ring cache and 16 teacher-forced decode
   steps against the forward; ``minicpm3_4b`` (MLA) at full depth, a 4 x
   512 prefill and 16 decode steps with the naive and the absorbed path,
   each against the forward and against each other; each leg timed;
12. the two frontend families at their published widths, one model on
   the card at a time, and the write-rate example: ``internvl2_26b`` in
   depth as far as half the card's free memory holds its f32 params
   (the cut printed), 4 x (256 patch embeddings from a seeded generator
   + 512 tokens) scored through B3 in bf16 (each layer's attention
   output against the plain version, the loss over the text against the
   plain forward's, one launch per layer, a warm call with B3's share),
   then a 4 x (256 + 512) prefill and 16 greedy decode steps in f32
   against the forward; ``whisper_small`` at full depth (its f32 params
   through the engine and back bit-equal, the forward at 4 x 1500
   frames x 448 tokens, a prefill of the frames and 432 tokens and 16
   greedy steps against the forward; no kernel, as in the reference);
   ``repro_torch.launch.fastpersist_vs_baseline --mb 1024`` with the
   state on the card (the baseline's and each FastPersist variant's
   GB/s, the pipelined submit cost);
13. expert parallelism across 4 processes on the one card, joined by a
   ``gloo`` process group (NCCL refuses two ranks on one GPU), and the
   dry run: (a) ``gpt3_1_8b_moe`` cut to 4 of its 24 layers at its
   published widths, capacity = n_experts, on the meshes 1 x 4 and 2 x
   2 (data x model): each rank's ``local_params`` and data shard through
   ``build_model(use_kernels=True, mesh=...)`` in bf16 and f32 (B3 at
   head dim 64 on every rank, its launches counted), each rank's logits
   against the single-process forward (bf16 within 2e-2 on the tokens
   before a routing flip, f32 within 1e-4) and its aux against the
   per-data-shard rule; (b) ``qwen3_moe_235b``'s MoE layer at its
   published widths (128 experts of 4096 x 1536, top 8, capacity 1.25)
   in f32 on 1 x 4, the ranks making the 9.66 GB layer in turn, each
   rank's output against the single-process sorted layer within 1e-4,
   timed beside the sorted and einsum layers on one process; (c)
   ``repro_torch.launch.dryrun.lower_one("gpt3_1_8b_moe", "train_4k")``
   with and without ``shard_map_moe`` on the 16 x 16 mesh (meta
   tensors), and ``op_cost`` around one real bf16 forward of (a)'s
   model on the card, its flops and its bytes equal to the same
   forward's on meta (``F.one_hot`` counted as one op), with the
   achieved rate. A rank that
   fails, exits non-zero or does not finish in time fails the phase;
14. the paper's figures (``repro_torch.benchmarks.run``, in this process,
   on ``cuda``, at their quick sizes; fig11 trains ``gpt3_0_7b`` at its
   published widths cut to 1 of 24 layers and 4 steps a cell,
   perf_writer at 128 MiB): B2 and its quantize mode on beyond_quant's
   leaves and B1 on fig_snapshot's dirty blob first held against their
   plain versions;
   every figure's CSV rows and wall time printed; fig_delta's,
   fig_snapshot's and fig10's restores bit-exact; B1 launched once per
   delta save of fig_snapshot's device-dirty chains and B2's quantize
   mode once per leaf of beyond_quant's int8 save (added to the kernels
   line), and the scales of that save equal to the plain version's; no
   figure
   holding more on the disk and in /dev/shm at once than min(75 % of
   the free disk, 90 % of phase 4's peak). The figures' verdicts are
   printed as measurements, never held.

The last three lines of standard output are one JSON object of
per-kernel numbers, the card's name and power limit, and one JSON
object naming the device.
"""
from __future__ import annotations

import argparse
import json
import math
import os
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
#: internvl2_26b's attention on phase 12's batch (256 patch tokens + 512
#: text tokens): (B, H, KV, L, hd), GQA 6:1 at head dim 128
ATTN_VLM = (BATCH, 48, 8, 256 + SEQ, 128)
#: flash_attention's backward in phase 3, causal (B, H, KV, L, hd): the
#: benchmark cells' train steps (gpt3_2_7b_tp4, hd 80; gpt3_1_3b_tp2, hd
#: 128), internvl2_26b's GQA 6:1 and the main path's stablelm_1_6b
ATTN_GRAD = {"gpt3_2_7b_tp4": (4, 8, 8, 2048, 80),
             "gpt3_1_3b_tp2": (4, 8, 8, 2048, 128),
             "internvl2_26b": ATTN_VLM,
             "stablelm_1_6b": (BATCH, 32, 32, SEQ, 64),
             # MLA (B, H, KV, L, hd, hd_v): deepseek_v2_lite_ep8's micro-batch
             "deepseek_v2_lite_ep8": (2, 16, 16, 4096, 192, 128)}
#: gpt3_1_8b_moe's attention in phase 13 (a), 16 heads of 64: over the
#: whole batch (one process, and each rank of the 1 x 4 mesh) and over
#: one data shard (each rank of the 2 x 2 mesh)
ATTN_EP = ((BATCH, 16, SEQ, 64), (BATCH // 2, 16, SEQ, 64))
#: mamba2_370m: batch x sequence of the forward, prompt and new tokens
#: of the decode check, and ssd_intra_chunk's (b, nc, cl, h, p, n) there
#: (B and C from its one group, expanded over the 32 heads)
M_BATCH, M_SEQ, M_PROMPT, M_NEW = 4, 2048, 512, 16
SSD = (M_BATCH, M_SEQ // 256, 256, 32, 64, 128)
#: zamba2_2_7b's ssd_intra_chunk on the same batch (phase 11): 80 heads
#: of 64, state size n 64, B and C from its one group
SSD_ZAMBA2 = (M_BATCH, M_SEQ // 256, 256, 80, 64, 64)
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
    from repro_torch.kernels import adam as kadam
    from repro_torch.kernels import ckpt_pack as cp
    from repro_torch.kernels import ops
    for w in (cp.ckpt_pack_blocks, cp.ckpt_pack_dirty_blocks,
              cp.ckpt_quant_blocks, ops.flash_attention, ops.ssd_intra_chunk,
              kadam.adam_update_):
        w.launches = 0
    ops.flash_attention.backward_launches = 0


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
    path's shape, at gpt3_2_7b's and gpt3_0_7b's widths and at phase 13's
    gpt3_1_8b_moe shapes (bf16 and f32, the model's strided views), at
    internvl2_26b's GQA 6:1 shape (bf16, its forward's dtype) and at the reference's sweep and variants
    (tests/test_kernels.py:126-166, at its tolerances), at head dims 64,
    80, 96 and 128. Times the f32 body beside SDPA f32 at the three
    widths, and the bf16 body beside SDPA at internvl2_26b's shape.
    Returns the ``kernels`` entry (launches filled in by phase 6)."""
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
    cases += [("ep", (B, H, H, L, L, hd), {}) for B, H, L, hd in ATTN_EP]
    B, H, KV, L, hd = ATTN_VLM
    cases.append(("internvl2", (B, H, KV, L, L, hd), {}))
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
        for dtype in ((torch.bfloat16,) if kind == "internvl2"
                      else (torch.bfloat16, torch.float32)):
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

    def timed(B, H, L, hd, dtype, plain=False, KV=None):
        """Kernel and SDPA (the yardstick only: the port never calls it)
        on the same causal inputs (``KV`` key/value heads, default H),
        events and in a CUDA graph, the plain version too if ``plain``,
        and the kernel's bound: f32 products at three TF32 products
        each."""
        KV = KV or H
        q, k, v = qkv(B, H, KV, L, L, hd, dtype)
        n_bytes = 2 * (H + KV) * B * L * hd * q.element_size()
        flops = 4 * hd * B * H * L * (L + 1) // 2    # causal pairs only
        rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_SPLIT_FLOPS
        bound_ms, bound_by = _bound(n_bytes, flops / rate)

        def kernel():
            return ops.flash_attention(q, k, v)

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=KV != H)
        t = {"ms": _cuda_ms(kernel), "graph_ms": _graph_ms(kernel),
             "library_ms": _cuda_ms(sdpa), "library_graph_ms": _graph_ms(sdpa),
             "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes,
             "flops": flops}
        if plain:
            t["plain_ms"] = _cuda_ms(lambda: flash_attention_plain(q, k, v))
        print(f"  time flash_attention {str(dtype)[6:]} causal "
              f"{(B, H, L, hd)}, KV {KV}: {t['ms']:.4f} ms (in a CUDA graph "
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
    B, H, KV, L, hd = ATTN_VLM
    vlm = timed(B, H, L, hd, torch.bfloat16, plain=True, KV=KV)
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
            "library_graph_ms": bf["library_graph_ms"],
            "internvl2": f"bf16 causal {ATTN_VLM} (B, H, KV, L, hd): "
                         f"{vlm['ms']:.4f} ms (in a CUDA graph "
                         f"{vlm['graph_ms']:.4f} ms; plain "
                         f"{vlm['plain_ms']:.4f} ms, SDPA "
                         f"{vlm['library_ms']:.4f} ms (in a CUDA graph "
                         f"{vlm['library_graph_ms']:.4f} ms), bound "
                         f"{vlm['bound_ms']:.4f} ms by {vlm['bound_by']}: "
                         f"{vlm['bytes']} B, {vlm['flops']} FLOP)",
            "internvl2_ms": vlm["ms"]}


def check_attention_grad(device) -> dict:
    """Phase 3, flash_attention's backward: at each shape of ATTN_GRAD,
    causal, on the model's strided views, the forward's output and
    log-sum-exp and the gradient's dq, dk, dv through ``ops.flash_attention``
    against the plain versions (the backward's from the kernel's own
    output and log-sum-exp) and against autograd of ``layers.attention``
    (bf16), each within TOL_ATTN_BF16 of the largest magnitude of its
    reference. Then the backward alone (``autograd.grad`` over a kept
    graph) timed with CUDA events beside its bound, the plain version and
    SDPA's backward (the yardstick only: the port never calls it), and
    the forward with and without the log-sum-exp. The bound counts the
    products the backward needs per causal pair: S, dP, dV and dK and dQ
    each as two (dS as bf16 hi + lo), 7 x 2 hd FLOP at the bf16 rate,
    against q, k, v, o, dO and the log-sum-exp read and dq, dk, dv
    written once. A shape with a sixth number is MLA's: v, o and dO at
    that head dim, S, dK and dQ over hd, dP and dV over it. Returns the
    ``kernels`` entry at gpt3_2_7b_tp4's shape (launches filled in by
    phase 4)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (flash_attention_bwd_plain,
                                         flash_attention_plain)
    from repro_torch.models import layers as ly
    gen = torch.Generator(device=device).manual_seed(2)
    print("  flash_attention backward (bf16 tensor-core kernels) against "
          "flash_attention_bwd_plain and autograd of layers.attention:",
          flush=True)

    def share(got, want):
        got, want = got.detach().float(), want.float()
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            fail("flash_attention backward: non-finite values")
        return float((got - want).abs().max() / want.abs().max())

    entry, worst = None, 0.0
    for name, (B, H, KV, L, hd, *rest) in ATTN_GRAD.items():
        hdv = rest[0] if rest else hd
        q = torch.randn((B, L, H, hd), generator=gen, device=device)
        k = torch.randn((B, L, KV, hd), generator=gen, device=device)
        v = torch.randn((B, L, KV, hdv), generator=gen, device=device)
        do = torch.randn((B, L, H, hdv), generator=gen, device=device)
        q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
        views = [t.transpose(1, 2).detach().requires_grad_()
                 for t in (q, k, v)]
        dot = do.transpose(1, 2)
        out = ops.flash_attention(*views)
        grads = torch.autograd.grad(out, views, dot, retain_graph=True)
        qt, kt, vt = (x.detach() for x in views)
        o2, lse = fa._forward(qt, kt, vt, True, None, None, want_lse=True)
        want_o, want_lse = flash_attention_plain(qt, kt, vt, lse=True)
        plain = flash_attention_bwd_plain(qt, kt, vt, o2, lse, dot)
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        pos = torch.arange(L, device=device)
        ly.attention(*xs, q_pos=pos, kv_pos=pos).backward(do)
        torch.cuda.synchronize()
        if not torch.equal(o2, out.detach()):
            fail(f"{name}: the forward with the log-sum-exp differs from "
                 f"the forward without it")
        err_lse = float((lse[..., :L] - want_lse).abs().max())
        if err_lse > 1e-3 or not bool(torch.isinf(lse[..., L:]).all()):
            fail(f"{name}: log-sum-exp off the plain version by {err_lse}")
        shares = {"o": share(out, want_o)}
        for n, g, pl, x in zip(("dq", "dk", "dv"), grads, plain, xs):
            shares[n] = share(g, pl)
            shares[n + " vs autograd"] = share(g, x.grad.transpose(1, 2))
            worst = max(worst, float((g.float() - pl.float()).abs().max()))
        if max(shares.values()) > TOL_ATTN_BF16:
            fail(f"{name}: flash_attention backward beyond {TOL_ATTN_BF16} "
                 f"of the largest magnitude: {shares}")
        print(f"  ok {name} (B, H, KV, L, hd, hd_v) "
              f"{(B, H, KV, L, hd, hdv)}: "
              f"|lse err| {err_lse:.2e}; largest |err| / max|ref|: "
              + ", ".join(f"{n} {v:.2e}" for n, v in shares.items()),
              flush=True)

        sd = [t.detach().requires_grad_() for t in views]
        sdpa = F.scaled_dot_product_attention(*sd, is_causal=True,
                                              enable_gqa=KV != H)
        pairs = B * H * L * (L + 1) // 2
        flops = 2 * (5 * hd + 2 * hdv) * pairs
        n_bytes = 2 * (hd + hdv) * B * L * 2 * (H + KV) + 4 * B * H * L
        bound_ms, bound_by = _bound(n_bytes, flops / BF16_FLOPS)
        t = {"ms": _cuda_ms(lambda: torch.autograd.grad(
                 out, views, dot, retain_graph=True)),
             "plain_ms": _cuda_ms(lambda: flash_attention_bwd_plain(
                 qt, kt, vt, o2, lse, dot)),
             "library_ms": _cuda_ms(lambda: torch.autograd.grad(
                 sdpa, sd, dot, retain_graph=True)),
             "fwd_ms": _cuda_ms(lambda: fa._forward(
                 qt, kt, vt, True, None, None, want_lse=False)),
             "fwd_lse_ms": _cuda_ms(lambda: fa._forward(
                 qt, kt, vt, True, None, None, want_lse=True)),
             "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"  time flash_attention backward {name}: {t['ms']:.4f} ms "
              f"({bound_ms / t['ms']:.1%} of its bound {bound_ms:.4f} ms by "
              f"{bound_by}: {flops} FLOP, {n_bytes} B); plain "
              f"{t['plain_ms']:.4f} ms; SDPA's backward "
              f"{t['library_ms']:.4f} ms; forward {t['fwd_ms']:.4f} ms, "
              f"with the log-sum-exp {t['fwd_lse_ms']:.4f} ms", flush=True)
        if entry is None:
            entry = {"name": "flash_attention_bwd", "route": "cuda",
                     "source": f"{CSRC}/flash_attention.cu",
                     "replaces": "none: the reference leaves its training "
                                 "attention to XLA",
                     "launches": 0, "shape": f"bf16 causal {name} "
                                             f"{(B, H, KV, L, hd)}",
                     **t}
        del out, grads, sdpa, plain, xs
        torch.cuda.empty_cache()
    entry["max_abs_err"] = worst
    return entry


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
    for shape, groups in ((SSD, 1), (SSD, None), (SSD_ZAMBA2, 1),
                          ((1, 2, 64, 2, 32, 16),
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
    timed = {}
    for shape in (SSD, SSD_ZAMBA2):      # each path's layout
        args = inputs(*shape, groups=1)
        timed[shape] = dict(
            ms=_cuda_ms(lambda: ops.ssd_intra_chunk(*args)),
            graph_ms=_graph_ms(lambda: ops.ssd_intra_chunk(*args)),
            plain_ms=_cuda_ms(lambda: ssd_intra_chunk_plain(*args)),
            **_ssd_bound(*shape))
        del args
    z = timed[SSD_ZAMBA2]
    return {"name": "ssd_intra_chunk", "route": "cuda",
            "source": f"{CSRC}/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:40",
            "launches": 0, "max_abs_err": err, **timed[SSD],
            "library_ms": None,
            "shape": f"f32 (b, nc, cl, h, p, n) = {SSD}, B and C from one "
                     f"group",
            "zamba2": f"{SSD_ZAMBA2}: {z['ms']:.4f} ms (in a CUDA graph "
                      f"{z['graph_ms']:.4f} ms; plain {z['plain_ms']:.4f} "
                      f"ms, bound {z['bound_ms']:.4f} ms by "
                      f"{z['bound_by']}: {z['bytes']} B, {z['flops']} "
                      f"FLOP)", "zamba2_ms": z["ms"]}


def _ssd_bound(b, nc, cl, h, p, n) -> dict:
    """B4's bytes, FLOPs and bound at a path's shape, B and C from one
    group as the paths pass them."""
    rows = b * nc * cl
    # x, y and dA per head; B and C once, for the one group the path has
    n_bytes = 4 * rows * (h * (2 * p + 1) + 2 * n)
    per_head_bytes = 4 * rows * h * (2 * p + 2 * n + 1)
    pairs = b * nc * h * cl * (cl + 1) // 2          # s <= l only
    # C·Bᵀ once per group (the path has one), then per head with X
    products = pairs // h * 2 * n + pairs * 2 * p
    bound_ms, bound_by = _bound(
        n_bytes, products / F32_SPLIT_FLOPS + pairs / F32_FLOPS)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes,
            "bytes_per_head": per_head_bytes,
            "flops": products + pairs}   # and the decay's multiply


def _adam_scalars(cfg, t: int, scale: float, device):
    """``adam.apply_``'s 0-d scalars at step ``t`` with the clip scale
    ``scale`` (the mean's ``1/gas`` in it): (scale, lr, b1c, b2c)."""
    import torch
    step = torch.tensor(float(t), device=device)
    return (torch.tensor(scale, device=device),
            cfg.lr * torch.clamp(step / cfg.warmup_steps, max=1.0),
            1 - cfg.b1 ** step, 1 - cfg.b2 ** step)


def _adam_leaves(shapes, gen, device):
    """bf16 weights with their f32 master, m and v after one update's
    worth of moments: ([params], [master], [m], [v])."""
    import torch
    out = ([], [], [], [])
    for shape in shapes:
        w = torch.randn(shape, generator=gen, device=device)
        out[0].append(w.to(torch.bfloat16))
        out[1].append(out[0][-1].float())
        out[2].append(torch.randn(shape, generator=gen, device=device) * 1e-3)
        out[3].append(torch.rand(shape, generator=gen, device=device) * 1e-6)
        del w
    return out


def _adam_times(cfg, shapes, device, gen) -> dict:
    """``adam_update_`` over every leaf of ``shapes`` at once (one
    launch a leaf), with f32 and bf16 gradients, beside its bytes bound,
    ``adam_plain`` and the library's fused AdamW: ``torch._fused_adamw_``
    (its ``grad_scale`` carrying the clip scale) after the step count's
    ``_foreach_add_``, then one ``_foreach_copy_`` into the bf16 weights.
    The library's update is not bit-equal (it decays the weight before
    the step and corrects the moments in another order); it is timed
    for what the hand-written kernel buys beyond bit-equality."""
    import torch
    from repro_torch.kernels import adam as kadam
    from repro_torch.kernels.ref import adam_plain
    params, master, m, v = _adam_leaves(shapes, gen, device)
    n = sum(p.numel() for p in params)
    grads = [torch.randn(p.shape, generator=gen, device=device) * 1e-3
             for p in params]
    grads16 = [g.to(torch.bfloat16) for g in grads]
    scal = _adam_scalars(cfg, 7, 0.25, device)
    one = torch.ones((), device=device)
    steps = [torch.full((), 7.0, device=device) for _ in params]
    lr = scal[1].clone()

    def library():
        torch._foreach_add_(steps, 1)
        torch._fused_adamw_(master, grads, m, v, [], steps, lr=lr,
                            beta1=cfg.b1, beta2=cfg.b2,
                            weight_decay=cfg.weight_decay, eps=cfg.eps,
                            amsgrad=False, maximize=False, grad_scale=one,
                            found_inf=None)
        torch._foreach_copy_(params, master)

    t = {"ms": _cuda_ms(lambda: kadam.adam_update_(
            cfg, grads, params, master, m, v, *scal)),
         "bf16_ms": _cuda_ms(lambda: kadam.adam_update_(
             cfg, grads16, params, master, m, v, *scal)),
         "plain_ms": _cuda_ms(lambda: adam_plain(
             cfg, grads, params, master, m, v, *scal)),
         "library_ms": _cuda_ms(library),
         "bound_ms": 30 * n / HBM_BYTES_PER_S * 1e3,
         "bf16_bound_ms": 28 * n / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "params": n, "bytes": 30 * n,
         "leaves": len(shapes)}
    del params, master, m, v, grads, grads16, steps
    torch.cuda.empty_cache()
    return t


def check_adam(device) -> dict:
    """Phase 3, the fused Adam update (``kernels/adam.py``, a port kernel
    with no TPU counterpart): ``adam_update_`` held bit for bit against
    ``adam_plain`` on every leaf of the main path's ``stablelm_1_6b``
    (full depth; one leaf on the card at a time), two steps from the
    same state, once with f32 gradients (a sum of 4 micro-batches,
    ``1/4`` in the clip scale) and once with bf16 ones (gas 1, as on the
    main path), one launch a leaf a step; then timed over all of its
    leaves at once and over ``gpt3_2_7b_tp4``'s (the benchmark's 2.7B
    cell, ``bench/configs``) by :func:`_adam_times`. Returns the
    ``kernels`` entry (launches filled in by phase 4)."""
    import torch
    from bench import common
    from repro_torch.configs import get_config
    from repro_torch.kernels import adam as kadam
    from repro_torch.kernels.ref import adam_plain
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.steps import init_train_state
    from repro_torch.tree import leaves

    def shapes_of(model_cfg):
        st = init_train_state(build_model(model_cfg), 0, "meta")
        return [tuple(p.shape) for p in leaves(st.params)]

    gen = torch.Generator(device=device).manual_seed(3)
    cfg = AdamConfig(warmup_steps=2)          # the steps cross the warm-up
    shapes = shapes_of(get_config("stablelm_1_6b"))
    print(f"  adam_update_ against adam_plain, bit for bit: stablelm_1_6b's "
          f"{len(shapes)} leaves, 2 steps each, f32 and bf16 gradients",
          flush=True)
    before = kadam.adam_update_.launches
    for shape in shapes:
        for gdt, gas in ((torch.float32, 4), (torch.bfloat16, 1)):
            kern = _adam_leaves([shape], gen, device)
            plain = tuple([t.clone() for t in ts] for ts in kern)
            for t in (1, 2):
                g = [(torch.randn(shape, generator=gen, device=device)
                      * 1e-2).to(gdt)]
                scal = _adam_scalars(cfg, t, 0.5 / gas, device)
                kadam.adam_update_(cfg, g, *kern, *scal)
                adam_plain(cfg, g, *plain, *scal)
            torch.cuda.synchronize()
            for what, a, b in zip(("param", "master", "m", "v"), kern,
                                  plain):
                if not torch.equal(_ints(a[0]), _ints(b[0])):
                    fail(f"adam_update_ {shape} {gdt} grads: {what} differs "
                         f"from adam_plain's after 2 steps")
            del kern, plain, g
    n_launch = kadam.adam_update_.launches - before
    if n_launch != 4 * len(shapes):
        fail(f"adam_update_ launched {n_launch} times over the check; "
             f"expected {4 * len(shapes)} (one a leaf a step)")
    print(f"  ok adam_update_: params, master, m, v bit-equal after 2 steps "
          f"on each of the {len(shapes)} leaves, f32 and bf16 gradients; "
          f"{n_launch} launches", flush=True)
    torch.cuda.empty_cache()
    main = _adam_times(cfg, shapes, device, gen)
    cell_json = common.load("configs", "gpt3_2_7b_tp4")
    cell = _adam_times(AdamConfig(**cell_json["optimizer"]),
                       shapes_of(common.model_config(cell_json)), device, gen)
    for name, t in (("stablelm_1_6b", main), ("gpt3_2_7b_tp4", cell)):
        print(f"  time adam_update_ at {name}'s {t['leaves']} leaves "
              f"({t['params']} params): {t['ms']:.4f} ms with f32 grads "
              f"({100 * t['bound_ms'] / t['ms']:.1f} % of the bytes bound "
              f"{t['bound_ms']:.4f} ms), {t['bf16_ms']:.4f} ms with bf16 "
              f"({100 * t['bf16_bound_ms'] / t['bf16_ms']:.1f} % of "
              f"{t['bf16_bound_ms']:.4f} ms); plain {t['plain_ms']:.4f} ms, "
              f"library (_fused_adamw_ + bf16 copy) {t['library_ms']:.4f} "
              f"ms", flush=True)
    return {"name": "adam_update_", "route": "cuda",
            "source": f"{CSRC}/adam.cu",
            "replaces": "none: src/repro/optim/adam.py:46 is XLA's fusion",
            "launches": 0, "max_abs_err": 0.0,
            **{k: main[k] for k in ("ms", "bf16_ms", "plain_ms",
                                    "library_ms", "bound_ms",
                                    "bf16_bound_ms", "bound_by", "bytes")},
            "shape": f"stablelm_1_6b's {main['leaves']} leaves",
            "gpt3_2_7b_tp4": {k: cell[k] for k in (
                "ms", "bf16_ms", "plain_ms", "library_ms", "bound_ms",
                "bf16_bound_ms")}}


# ------------------------------------------------------------ phase 4-5
def _kernel_records(trainer) -> int:
    """Records the device-dirty snapshot sends through the kernel: float
    records of at least one dirty block (every float record of the full
    model)."""
    from repro_torch.core.checkpointer import DIRTY_BLOCK
    from repro_torch.tree import flatten
    return sum(1 for _, t in flatten(trainer.state)
               if t.is_floating_point()
               and t.numel() * t.element_size() >= DIRTY_BLOCK)


def main_path(device, steps: int, batch: int, seq: int):
    """Phases 4 and 5. Returns the ckpt_pack and adam_update_ launch
    counts of the main path, the model config, the restored state with the trainer's next
    batch (for phase 6), the extras a save of it carries (phase 7) and
    the bytes its two generations held on the disk together (phase 9's
    disk budget)."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.checkpointer import FastPersistConfig
    from repro_torch.core.partition import Topology
    from repro_torch.kernels import adam as kadam
    from repro_torch.kernels import ckpt_pack as cp
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import (CheckpointPolicy, Trainer,
                                           TrainerConfig)
    from repro_torch.tree import flatten, leaves

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
            restore_readers="auto",
            fp=FastPersistConfig(device_dirty=True, keyframe_every=2,
                                 topology=Topology(dp_degree=4,
                                                   ranks_per_node=4)))
        tcfg = TrainerConfig(model=cfg, steps=steps, global_batch=batch,
                             seq_len=seq, checkpoint=pol, log_every=1)
        tr = Trainer(tcfg, device="cuda")
        tr.init_state()
        n_kernel = _kernel_records(tr)
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
                    "ckpt_pack_blocks": cp.ckpt_pack_blocks.launches,
                    "adam_update_": kadam.adam_update_.launches,
                    "flash_attention": ops.flash_attention.launches,
                    "flash_attention_bwd":
                        ops.flash_attention.backward_launches}
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
        n_adam = len(leaves(tr.state.params)) * steps
        if launches["adam_update_"] != n_adam:
            fail(f"adam_update_ launched {launches['adam_update_']} times "
                 f"over {steps} steps; expected {n_adam}, one a leaf a step")
        # the train step's attention: the forward and the backward kernels
        # once a layer a micro-batch
        n_attn = cfg.n_layers * tcfg.gas * steps
        if (launches["flash_attention"],
                launches["flash_attention_bwd"]) != (n_attn, n_attn):
            fail(f"flash_attention launched {launches['flash_attention']} "
                 f"forward and {launches['flash_attention_bwd']} backward "
                 f"times over {steps} steps; expected {n_attn} each, n_layers"
                 f" x gas x steps")

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


def _quant_specials(dtype, device):
    """(finite cases, non-finite case) for the quantize kernel, as flat
    ``dtype`` tensors on ``device``, each ending in a ragged tail: tie
    blocks whose values divide exactly to k + 0.5 at scales 1, 2 and 1/2
    (half to even goes down for even k, up for odd k), an all-zero block
    and a -0.0 tail, subnormals (of f32 for f32 and bf16, of f16 for
    f16) and a normal block; then blocks with NaN, inf and -inf."""
    import torch
    from repro_torch.core.quant import BLOCK
    gen = torch.Generator(device=device).manual_seed(24)

    def normal(n, mul=1.0):
        return torch.randn(n, generator=gen, device=device) * mul

    k = torch.arange(-126, 127, device=device, dtype=torch.float32)
    ties = []
    for sc in (1.0, 2.0, 0.5):
        blk = (k.repeat(-(-(BLOCK - 2) // k.numel()))[:BLOCK - 2] + 0.5) * sc
        ties.append(torch.cat([blk, blk.new_tensor([127 * sc, -127 * sc])]))
    tiny = 1e-6 if dtype == torch.float16 else 1e-39
    finite = torch.cat(ties + [normal(BLOCK).zero_(), normal(BLOCK, tiny),
                               normal(BLOCK, 5.0), normal(37, tiny),
                               normal(5).zero_().neg_()]).to(dtype)
    if not torch.equal(finite[:3 * BLOCK].float(), torch.cat(ties)):
        fail(f"quantize specials: the ties are not exact in {dtype}")
    odd = normal(3 * BLOCK + 21)
    odd[5], odd[BLOCK + 9], odd[2 * BLOCK + 3] = (float("nan"), float("inf"),
                                                  -float("inf"))
    return finite, odd.to(dtype)


def check_quant(leaves, qnames, device) -> dict:
    """Phase 7 (a), before the save: the quantize kernel (B2's quantize
    mode) held bit-equal to its plain version on the card — on the
    largest record of each dtype of phase 7's state, a ragged one cut
    from it, and ``_quant_specials`` in f32, bf16 and f16 (the int8 values
    and the scales bit for bit; on the NaN and inf blocks the scales
    only, C.10) — then timed on the largest f32 record beside its plain
    version and its bytes bound. Returns its entry of the kernels line
    (launches filled in after the save)."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import ckpt_pack as cp
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ckpt_quant_plain

    def held(name, x, scales_only=False):
        q, s = ops.ckpt_quant(x, block=quant.BLOCK)
        flat = x.reshape(-1)
        pq, ps = ckpt_quant_plain(cp.to_blocks(flat, quant.BLOCK))
        torch.cuda.synchronize()
        pq = pq.reshape(-1)[:flat.numel()]
        if not torch.equal(_ints(s), _ints(ps)):
            fail(f"ckpt_quant {name}: scales differ from the plain version")
        if not scales_only and not torch.equal(q, pq):
            fail(f"ckpt_quant {name}: {int((q != pq).sum())} int8 values "
                 f"differ from the plain version")
        print(f"  ok ckpt_quant {name}: {s.numel()} blocks, "
              f"{'scales' if scales_only else 'int8 values and scales'} "
              f"bit-equal", flush=True)

    print("phase 7: the quantize kernel (ckpt_quant_blocks) against its "
          "plain version", flush=True)
    by_dtype = {}
    for name, t in leaves:
        if name in qnames and (t.dtype not in by_dtype
                               or t.numel() > by_dtype[t.dtype][1].numel()):
            by_dtype[t.dtype] = (name, t)
    for name, t in by_dtype.values():
        held(f"{name} {str(t.dtype)[6:]} {tuple(t.shape)}", t)
        cut = t.reshape(-1)[:t.numel() // 3 + 1001]
        held(f"{name} cut to {cut.numel()} (ragged)", cut)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        finite, odd = _quant_specials(dt, device)
        held(f"{str(dt)[6:]} ties at scales 1, 2, 1/2, zeros, -0.0, "
             f"subnormals, ragged", finite)
        held(f"{str(dt)[6:]} NaN / inf / -inf blocks", odd, scales_only=True)

    _, big = by_dtype[torch.float32]
    n = big.numel()
    n_bytes = n * (big.element_size() + 1) + 4 * -(-n // quant.BLOCK)
    ms = _cuda_ms(lambda: ops.ckpt_quant(big, block=quant.BLOCK))
    x2d = cp.to_blocks(big.reshape(-1), quant.BLOCK)
    plain = _cuda_ms(lambda: ckpt_quant_plain(x2d))
    del x2d
    entry = {"name": "ckpt_quant_blocks", "route": "cuda",
             "source": f"{CSRC}/ckpt_pack.cu",
             "replaces": "src/repro/kernels/ckpt_pack.py:56",
             "launches": 0, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
             "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
             "bound_by": "bytes", "library_ms": None,
             "shape": f"f32 {tuple(big.shape)}", "bytes": n_bytes,
             "sampled": [name for name, _ in by_dtype.values()]}
    print(f"  time ckpt_quant_blocks {entry['shape']}: {ms:.3f} ms (plain "
          f"{plain:.3f} ms, bytes bound {entry['bound_ms']:.3f} ms, "
          f"{n_bytes / ms / 1e6:.0f} GB/s)", flush=True)
    return entry


def quantized_save(cfg, state, extras, device):
    """Phase 7 (a)-(f): the quantize kernel held against its plain version
    (``check_quant``), then the restored ``cfg`` state saved through an
    engine with ``FastPersistConfig(quantize=True)``, the kernels' launches
    read around the save, and the result held against host quantization
    and the live state. Returns (the ckpt_quant_blocks and the
    ckpt_pack_blocks launches of the save, the kernels-line entry of
    ckpt_quant_blocks); the launches of the checks are not counted."""
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
    gc.collect()                   # earlier phases' states held in cycles
    torch.cuda.reset_peak_memory_stats()
    entry = check_quant(leaves, qnames, device)
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
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        _zero_counts()             # just before the quantized save
        t0 = time.perf_counter()
        h = eng.save(state, extras["step"], extras)
        eng.wait_snapshot()
        held = torch.cuda.memory_allocated() - base
        st = h.wait()
        wall = time.perf_counter() - t0
        launches = cp.ckpt_quant_blocks.launches
        packs = cp.ckpt_pack_blocks.launches
        eng.close()
        del eng                    # frees the save's staging arena
        gc.collect()
        snap_s = st.serialize_seconds - st.quantize_seconds
        print(f"  (a) save: {launches} ckpt_quant_blocks launches, {packs} "
              f"ckpt_pack_blocks; {st.total_bytes} B on disk vs {full} B "
              f"full ({full / st.total_bytes:.3f}x smaller); d2h_bytes "
              f"{st.d2h_bytes}; snapshot {snap_s:.3f} s, quantize "
              f"{st.quantize_seconds:.3f} s, persist {st.seconds:.3f} s, "
              f"commit {st.commit_seconds:.3f} s, wall {wall:.3f} s; "
              f"writers {st.n_writers}, o_direct "
              f"{all(w.direct for w in st.per_writer)}; device memory held "
              f"past the snapshot {held} B", flush=True)
        smallest = min(t.numel() for n, t in leaves if n in qnames)
        if not 0 <= held < smallest:
            fail(f"the card's memory moved by {held} B across the save's "
                 f"snapshot: expected 0, and under the int8 values of its "
                 f"smallest record ({smallest} B)")
        if launches != len(qnames) or packs:
            fail(f"the quantized save launched ckpt_quant_blocks {launches} "
                 f"times and ckpt_pack_blocks {packs}; expected "
                 f"{len(qnames)} and 0")
        if st.quantize_seconds != 0.0:
            fail(f"the quantized save of state on the card quantized on "
                 f"the host for {st.quantize_seconds} s")
        if sorted(st.device_scales) != sorted(qnames):
            fail("the save's device scales do not cover exactly the "
                 "quantizable records")
        if st.total_bytes != want_bytes or st.d2h_bytes != want_bytes:
            fail(f"{st.total_bytes} B on disk and {st.d2h_bytes} B over "
                 f"PCIe; the quantized layout gives {want_bytes}")

        # (b) the route saves took before the quantize mode, B2's amax
        # on the card (``device_block_amax``, the reference's device
        # half), held bit-equal to the host amax: a check, so its
        # launches are not counted; (c) the disk bytes against host
        # quantization of the same values, an oracle that runs no kernel
        rd = CheckpointEngine(CheckpointSpec(directory=tmp))
        t0 = time.perf_counter()
        amax0 = cp.ckpt_pack_blocks.launches
        for name, t in leaves:
            if name not in qnames:
                continue
            host = t.detach().cpu()
            amax = quant.block_amax(host)
            dev = quant.device_block_amax(t)
            nan = np.isnan(amax)
            if not (np.array_equal(np.isnan(dev), nan) and np.array_equal(
                    dev[~nan].view(np.uint32), amax[~nan].view(np.uint32))):
                fail(f"{name}: B2's amax differs from the host amax of the "
                     f"same values")
            q, scale = quant._blockwise(host, amax=amax)
            q_disk = rd.load_tensor(name + "#q8").reshape(-1).numpy()
            s_disk = rd.load_tensor(name + "#scale").numpy()
            ok = s_disk.tobytes() == scale.tobytes() == \
                st.device_scales[name].tobytes()
            finite = ~np.isnan(host.float().reshape(-1).numpy())
            ok = ok and np.array_equal(q_disk[finite], q[finite])
            if not ok:
                fail(f"{name}: int8/scale bytes on disk differ from "
                     f"host quantization")
        amax_launches = cp.ckpt_pack_blocks.launches - amax0
        print(f"  (b) B2's amax ({amax_launches} ckpt_pack_blocks launches, "
              f"not counted) "
              f"bit-equal to the host amax on all {len(qnames)} records; "
              f"(c) their #q8 and #scale bytes on disk (and the save's "
              f"device scales) equal host quantization "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if amax_launches != len(qnames):
            fail(f"(b) launched ckpt_pack_blocks {amax_launches} times; "
                 f"expected {len(qnames)}")

        # (d) restore onto the card, dequantized there: within the
        # per-block bound of the live state, and bit-equal to the host
        # dequantize of the disk bytes on the sampled records
        like = init_train_state(build_model(cfg), 0, "meta")
        t0 = time.perf_counter()
        got, man = rd.load(like=like, device=device, parallel="auto")
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        t_deq = rd._payload.ckpt.last_dequantize_seconds
        worst = {}
        restored = dict(flatten(got))
        for (name, a), (_, b) in zip(restored.items(), leaves):
            if a.dtype != b.dtype or a.shape != b.shape or not a.is_cuda:
                fail(f"restored {name} is {a.dtype}{tuple(a.shape)} on "
                     f"{a.device}")
            if name in qnames:
                bad, err = _q8_bound(b, a)
                if bad:
                    fail(f"restored {name}: {bad} elements beyond the "
                         f"per-block bound (max err {err})")
                worst[str(a.dtype)] = max(worst.get(str(a.dtype), 0.0), err)
            elif not _same_bits(a, b):
                fail(f"restored {name} (not quantized) is not bit-equal")
        for name in entry["sampled"]:
            a = restored[name]
            want = quant._deblock(rd.load_tensor(name + "#q8"),
                                  rd.load_tensor(name + "#scale"),
                                  dtype_name(a))
            if not _same_bits(a.cpu().reshape(-1), want):
                fail(f"restored {name}: the dequantize on the card is not "
                     f"bit-equal to the host's")
        if man.extras.get("step") != extras["step"] \
                or man.extras.get("data") != extras["data"]:
            fail(f"restored extras {man.extras}; expected {extras}")
        print(f"  (d) restored onto {device} in {t_restore:.3f} s "
              f"(dequantize on the card {t_deq:.3f} s): {len(qnames)} "
              f"records within the per-block bound (max abs err {worst}), "
              f"{entry['sampled']} bit-equal to the host dequantize, the "
              f"rest bit-equal; step {man.extras['step']}, data "
              f"{man.extras['data']}", flush=True)
        peak = torch.cuda.max_memory_allocated()
        print(f"  (e) bytes on disk {st.total_bytes} vs keyframe {full}, "
              f"d2h_bytes {st.d2h_bytes}; (f) seconds: snapshot "
              f"{snap_s:.3f} quantize {st.quantize_seconds:.3f} persist "
              f"{st.seconds:.3f} commit {st.commit_seconds:.3f} restore "
              f"{t_restore:.3f} dequantize {t_deq:.3f}; peak device memory "
              f"{peak} B", flush=True)
        del got, restored
        rd.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the quantize kernel's time inside the save (its launches; timing
    # launches, after the counts were read) beside the route it replaced
    torch.cuda.synchronize()
    qleaves = [t for n, t in leaves if n in qnames]
    ms = _cuda_ms(lambda: [ops.ckpt_quant(t, block=quant.BLOCK)
                           for t in qleaves], iters=3)
    n_bytes = sum(t.numel() * (t.element_size() + 1)
                  + 4 * -(-t.numel() // quant.BLOCK) for t in qleaves)
    amax_ms = _cuda_ms(lambda: [quant.launch_block_amax(t) for t in qleaves],
                       iters=3)
    print(f"  B2's quantize mode in the save: {launches} launches in "
          f"{ms:.3f} ms ({n_bytes} B, bytes bound "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms); B2's amax on the same "
          f"records, the route it replaced, {amax_ms:.3f} ms", flush=True)
    entry["save_ms"], entry["save_bytes"] = ms, n_bytes
    return launches, packs, entry


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
            restore_readers="auto",
            fp=FastPersistConfig(device_dirty=True, delta_quantize=True,
                                 keyframe_every=2,
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
def _disk_budget(disk_peak: int) -> float:
    """The bytes a later phase may hold on the disk at once: min(75 % of
    the free disk, 90 % of phase 4's peak ``disk_peak``)."""
    free = shutil.disk_usage(tempfile.gettempdir()).free
    return min(0.75 * free, 0.9 * disk_peak)


def _engine_round_trip(cfg, model, params, device, disk_budget: float,
                       times: dict):
    """Phases 8, 11 and 12: ``params`` saved through the engine
    (fastpersist, 2 writers) and loaded back onto the card in parallel,
    every record bit-equal; within ``disk_budget`` bytes on the disk."""
    import torch
    from repro_torch.core.checkpointer import FastPersistConfig
    from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
    from repro_torch.core.partition import Topology
    from repro_torch.tree import flatten

    n_bytes = sum(t.numel() * t.element_size() for _, t in flatten(params))
    if n_bytes > disk_budget:
        fail(f"{cfg.name}'s params ({n_bytes} B) do not fit min(75 % of "
             f"the free disk, 90 % of phase 4's peak) = {disk_budget:.0f} B")
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{cfg.name}_")
    try:
        eng = CheckpointEngine(CheckpointSpec(
            directory=tmp, backend="fastpersist", fp=FastPersistConfig(
                topology=Topology(dp_degree=4, ranks_per_node=4))))
        t0 = time.perf_counter()
        st = eng.save(params, 1, {"step": 1}).wait()
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, _ = eng.load(like=model.init(0, "meta"), device=device,
                          parallel=4)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        eng.close()
        for (name, a), (_, b) in zip(flatten(got), flatten(params)):
            if a.shape != b.shape or not torch.equal(_ints(a), _ints(b)):
                fail(f"{cfg.name} checkpoint: {name} is not bit-equal")
        print(f"  checkpoint: {st.total_bytes} bytes (disk budget "
              f"{disk_budget:.0f} B) saved in {t_save:.2f} s, loaded in "
              f"{t_load:.2f} s; all {len(flatten(got))} records bit-equal",
              flush=True)
        times[f"{cfg.name} checkpoint save / load s"] = (t_save, t_load)
        del got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_ssm_model(key, device, kernel_ms: float, disk_budget: float,
                  times: dict, prefix: str = "  ") -> int:
    """Phases 8 and 11: an SSM-family model (``mamba2_370m``,
    ``zamba2_2_7b``) at full width and depth from seed 0: its f32 params
    through the engine and back bit-equal (within ``disk_budget`` bytes on
    the disk); the ``use_kernels`` forward at batch 4 x 2048 against the
    plain hook, with ssd_intra_chunk's launches counted around it (one
    per SSM block); a second, warm forward (after the count is read)
    timed beside the first, with B4's share at phase 3's ``kernel_ms``
    per launch; a 4 x 512 prefill and 16 greedy decode steps against the
    forward. Returns B4's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model, cross_entropy
    from repro_torch.tree import flatten

    t_leg = time.perf_counter()
    cfg = get_config(key)
    model = build_model(cfg, dtype=torch.float32, use_kernels=True)
    params = model.init(0, device)
    n_params = sum(t.numel() for _, t in flatten(params))
    groups = ("" if not cfg.attn_every else
              f" in {cfg.n_layers // cfg.attn_every} groups of "
              f"{cfg.attn_every}, a shared attention block of "
              f"{cfg.n_heads} heads of {cfg.resolved_head_dim} after each")
    print(f"{prefix}{cfg.name} at full width: {cfg.n_layers} SSM blocks"
          f"{groups}; d_model {cfg.d_model}, d_state {cfg.ssm.d_state}, "
          f"head_dim {cfg.ssm.head_dim}, chunk {cfg.ssm.chunk}; {n_params}"
          f" f32 params ({4 * n_params} B) from seed 0", flush=True)
    _engine_round_trip(cfg, model, params, device, disk_budget, times)
    batch = TokenStream(DataConfig(cfg.vocab_size, M_SEQ, M_BATCH, seed=0),
                        device=device).peek(0)
    plain = build_model(cfg, dtype=torch.float32)   # the plain hook
    with torch.inference_mode():
        _zero_counts()             # just before the kernel forward
        t0 = time.perf_counter()
        logits, _ = model.forward(params, batch)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        launches = ops.ssd_intra_chunk.launches
        loss = float(cross_entropy(logits, batch["labels"]))
        print(f"  forward batch {M_BATCH} x seq {M_SEQ}: {first:.3f} s, "
              f"{launches} ssd_intra_chunk launches, loss {loss:.6f}",
              flush=True)
        if launches != cfg.n_layers:
            fail(f"{cfg.name}: ssd_intra_chunk launched {launches} times; "
                 f"expected {cfg.n_layers}")
        if logits.shape != (M_BATCH, M_SEQ, cfg.vocab_size) \
                or not math.isfinite(loss):
            fail(f"{cfg.name} logits {tuple(logits.shape)}, loss {loss}")
        want, _ = plain.forward(params, batch)
        _close(f"{cfg.name} f32 logits {tuple(logits.shape)} vs the plain "
               f"hook", logits, want, TOL_MODEL, rtol=0.0)
        del logits, want
        t0 = time.perf_counter()
        model.forward(params, batch)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        share = cfg.n_layers * kernel_ms
        print(f"  forward: first call {first:.3f} s, warm call {warm:.3f} s;"
              f" B4's {cfg.n_layers} launches at phase 3's {kernel_ms:.4f} "
              f"ms: {share:.3f} ms, {100 * share / 1e3 / warm:.1f} % of the "
              f"warm call", flush=True)
        times[f"{cfg.name} f32 forward first / warm s"] = (first, warm)
    # serving: prefill a prompt, greedy-decode, hold against the forward
    _greedy_decode(cfg, params, {"tokens": batch["tokens"][:, :M_PROMPT]},
                   device, times)
    times[f"{cfg.name} s"] = time.perf_counter() - t_leg
    return launches


# ---------------------------------------------------------------- phase 9
#: the two peers keep their replicas in memory, as a peer's RAM tier
#: would: a tmpfs directory; the local checkpoint and the object store
#: are on the disk
PEER_ROOT = "/dev/shm"
#: the served tensor of phase 9 (100352 x 2048 bf16) and the read cache
SERVED, SERVE_CACHE_MB = ".params/embed", 512
#: phase 9's depth at most: its minimum, 2 layers. At 5 (what the disk
#: and memory budgets allow) the script ran past 720 s of its 1,200 s
#: limit once phase 11 came in (799.2 s on an NVIDIA H100 80GB HBM3 at
#: 700 W); the tiers' paths are the same at any depth, only their bytes
#: shrink
TIER_MAX_LAYERS = 2


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
        n = min(TIER_MAX_LAYERS, _tier_depth(cfg, disk_budget, 0.4 * mem))
        print(f"phase 9: durability tiers; {free} B free on the disk "
              f"(phase 4 held {disk_peak} B), {mem} B of memory available "
              f"(the peers' replicas live in {PEER_ROOT}); full state "
              f"{cfg.param_count() * 14} B", flush=True)
        if n < 2:
            fail(f"keyframe + delta of a 2-layer {cfg.name} do not fit "
                 f"twice in {disk_budget:.0f} B of disk and twice in "
                 f"{0.4 * mem:.0f} B of memory")
        print(f"  CUT: n_layers {cfg.n_layers} -> {n} (widths unchanged):"
              f" at most {TIER_MAX_LAYERS} for the script's time, and "
              f"keyframe + delta fit twice on the disk (local, object "
              f"store) in min(75 % of the free disk, 90 % of phase 4's "
              f"peak) and twice in memory (2 peers) in 40 % of the "
              f"available memory", flush=True)
        cfg = dataclasses.replace(cfg, n_layers=n)
        local, bucket = (os.path.join(root, d) for d in ("local", "bucket"))
        peer_dirs = [os.path.join(peer_root, f"peer{i}") for i in range(2)]
        pol = CheckpointPolicy(
            directory=local, every=1,
            backend="fastpersist-tiered-pipelined",
            upload_store=bucket, peers=[f"peer{i}={d}@rack{i}" for
                                        i, d in enumerate(peer_dirs)],
            replication_factor=2, failure_domain="rack-trainer",
            retention=RetentionPolicy(keep_last=1), restore_readers="auto",
            fp=FastPersistConfig(device_dirty=True, keyframe_every=2,
                                 topology=Topology(dp_degree=4,
                                                   ranks_per_node=4)))
        tcfg = TrainerConfig(model=cfg, steps=STEPS, global_batch=BATCH,
                             seq_len=SEQ, checkpoint=pol, log_every=100)
        tr = Trainer(tcfg, device=device)
        tr.init_state()
        n_kernel = _kernel_records(tr)
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


# --------------------------------------------------------------- phase 10
#: gpt3_1_8b_moe's depth in phase 10: 4 of its 24 layers (its widths are
#: the published ones). All 24 are 4.98 B params, 69.8 GB of train state
#: at 14 B/param: with gradients and activations more than one 80 GB
#: card, and more than the disk holds beside phase 4's peak.
MOE_LAYERS = 4
#: the dense paper models phase 10 runs at full width and depth: B3 at
#: head dims 80 and 96
GPT3_DENSE = ("gpt3_2_7b", "gpt3_0_7b")


def _score_paper(cfg, params, batch, dtype, times, routes=None):
    """Phase 10's and 12's scoring of one model: each layer's attention output
    through B3 against the plain version on the same q, k, v (bf16 at
    2e-2, f32 at 2e-5; comparison launches, not counted), then the
    ``use_kernels`` path with B3's launches counted around it: the bf16
    loss (CE + aux) within 1e-3 relative of the plain forward's, or the
    f32 logits within 1e-3 of the plain forward's. A warm call is timed
    after the count is read. ``routes``: a dict that receives each MoE
    layer's expert choice on the kernel forward ("kernel") and on the
    plain one ("plain"), with the routed and dropped counts. Returns B3's
    launches on the path."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_plain
    from repro_torch.models import layers as ly
    from repro_torch.models import transformer
    from repro_torch.models.registry import build_model, cross_entropy

    f32 = dtype == torch.float32
    tol = TOL_ATTN_F32 if f32 else TOL_ATTN_BF16
    kind = "f32" if f32 else "bf16"
    layer_errs, shares = [], []

    def checked_hook(q, k, v, cap=None):
        got = ops.flash_attention(q, k, v, causal=True, cap=cap)
        want = flash_attention_plain(q, k, v, causal=True, cap=cap)
        layer_errs.append(_close(
            f"{kind} attention of layer {len(layer_errs)}", got, want, tol,
            quiet=True, shares=shares))
        return got

    def plain_hook(q, k, v, cap=None):
        return flash_attention_plain(q, k, v, causal=True, cap=cap)

    def recorder(side):
        def moe(p, h, c):
            r = ly.moe_route(p, h, c)
            counts = torch.bincount(r.gate_i.reshape(-1),
                                    minlength=c.moe.n_experts)
            routes.setdefault(side, []).append(
                (r.gate_i, counts.tolist(),
                 int((counts - r.C).clamp(min=0).sum()), r.C))
            return ly.moe_apply(p, h, c)
        return moe if routes is not None else None

    def plain_forward():
        return transformer.forward(params, cfg, batch, dtype=dtype,
                                   attn_kernel=plain_hook,
                                   moe_kernel=recorder("plain"))

    model = build_model(cfg, dtype=dtype, use_kernels=True)
    with torch.inference_mode():
        transformer.forward(params, cfg, batch, dtype=dtype,
                            attn_kernel=checked_hook,
                            moe_kernel=recorder("kernel"))
        if len(layer_errs) != cfg.n_layers:
            fail(f"{cfg.name}: the checked {kind} forward ran attention "
                 f"{len(layer_errs)} times; expected {cfg.n_layers}")
        print(f"  ok {kind} attention output of each of the {cfg.n_layers} "
              f"layers through B3 vs the plain version: tol {tol} (rtol "
              f"{tol}), max_abs_err {max(layer_errs)}, largest share of "
              f"the allowance {max(shares):.3f}", flush=True)
        torch.cuda.synchronize()
        _zero_counts()         # just before this model's kernel path
        t0 = time.perf_counter()
        if f32:
            out, _ = model.forward(params, batch)
        else:
            out = model.loss(params, batch)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        launches = ops.flash_attention.launches
        if launches != cfg.n_layers:
            fail(f"{cfg.name}: the {kind} kernel path launched "
                 f"flash_attention {launches} times; expected "
                 f"{cfg.n_layers}")
        plain_logits, aux = plain_forward()
        if f32:
            _close(f"{cfg.name} f32 logits {tuple(out.shape)} vs the plain "
                   f"forward", out, plain_logits, TOL_MODEL, rtol=0.0)
            what = "f32 forward"
        else:
            loss = float(out)
            n_prefix = (batch["patch_embeds"].shape[1]
                        if "patch_embeds" in batch else 0)
            plain = float(cross_entropy(plain_logits, batch["labels"],
                                        n_prefix) + aux)
            print(f"  bf16 loss (CE + aux) {loss:.6f}, plain forward "
                  f"{plain:.6f}", flush=True)
            if not (math.isfinite(loss) and abs(loss - plain)
                    <= TOL_LOSS_BF16 * abs(plain)):
                fail(f"{cfg.name}: bf16 loss {loss} vs plain {plain} beyond "
                     f"{TOL_LOSS_BF16} relative")
            what = "bf16 loss"
        del out, plain_logits
        t0 = time.perf_counter()
        if f32:
            model.forward(params, batch)
        else:
            model.loss(params, batch)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
    print(f"  {cfg.name} {what} on {tuple(batch['tokens'].shape)}: first "
          f"call {first:.4f} s, warm call {warm:.4f} s; {launches} B3 "
          f"launches", flush=True)
    times[f"{cfg.name} {what} first/warm s"] = (first, warm)
    return launches


def _moe_routes(cfg, routes):
    """Print each MoE layer's tokens per expert and tokens dropped (on the
    kernel forward), and the tokens routed to another expert on the plain
    forward (bf16 roundings of the attention can flip a near tie)."""
    flips = []
    for i, ((gi, counts, dropped, cap), (gp, *_)) in enumerate(
            zip(routes["kernel"], routes["plain"])):
        flips.append(int((gi != gp).any(-1).sum()))
        print(f"  layer {i}: tokens per expert {counts} (capacity {cap}), "
              f"dropped {dropped}, routed elsewhere on the plain forward "
              f"{flips[-1]}", flush=True)
    if len(flips) != cfg.n_layers:
        fail(f"{cfg.name}: routing recorded in {len(flips)} layers")
    return flips


def paper_models(device, disk_peak: int, times: dict) -> int:
    """Phase 10: the paper's own models (its Table 2) at their published
    widths on the card. (a) gpt3_1_8b_moe, cut to ``MOE_LAYERS`` layers:
    trained 2 steps through ``fastpersist-pipelined`` with one keyframe
    save, restored by a fresh Trainer bit-equal to the live state and
    data position, and the restored state scored through B3 (hd 64).
    (b) gpt3_2_7b (hd 80) and gpt3_0_7b (hd 96) at full depth from seed
    0: the bf16 kernel loss, gpt3_2_7b's f32 forward, and gpt3_2_7b's f32
    prefill of 4 x 512 tokens with 16 greedy decode steps, each step's
    logits against the forward over the same tokens. Keeps its disk peak
    under 90 % of phase 4's. Returns B3's launches on the phase's kernel
    paths; ``times`` receives each part's seconds."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_paper_config
    from repro_torch.core.checkpointer import FastPersistConfig
    from repro_torch.core.partition import Topology
    from repro_torch.models.registry import build_model
    from repro_torch.train.trainer import (CheckpointPolicy, Trainer,
                                           TrainerConfig)
    from repro_torch.tree import flatten, tree_map

    full = get_paper_config("gpt3_1_8b_moe")
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    state_bytes = cfg.param_count() * 14
    tmp = tempfile.mkdtemp(prefix="chip_smoke_paper_")
    launches = 0
    try:
        free = shutil.disk_usage(tmp).free
        budget = min(0.75 * free, 0.9 * disk_peak)
        print(f"phase 10: the paper's models at their published widths; "
              f"{free} B free on the disk (phase 4 held {disk_peak} B)",
              flush=True)
        print(f"  CUT: {full.name} n_layers {full.n_layers} -> {MOE_LAYERS}"
              f" (widths unchanged: d_model {cfg.d_model}, {cfg.n_heads} "
              f"heads of {cfg.resolved_head_dim}, {cfg.moe.n_experts} "
              f"experts of d_ff {cfg.d_ff}, top-{cfg.moe.top_k}, capacity "
              f"{cfg.moe.capacity_factor}, vocab {cfg.vocab_size}): "
              f"{cfg.param_count()} params, {state_bytes} B of train state;"
              f" all {full.n_layers} layers are {full.param_count()} params,"
              f" {full.param_count() * 14} B, more than one card with "
              f"gradients and activations", flush=True)
        if state_bytes > budget:
            fail(f"the {MOE_LAYERS}-layer keyframe ({state_bytes} B) does "
                 f"not fit min(75 % of the free disk, 90 % of phase 4's "
                 f"peak) = {budget:.0f} B")
        pol = CheckpointPolicy(
            directory=tmp, every=2, backend="fastpersist-pipelined",
            restore_readers="auto", fp=FastPersistConfig(
                topology=Topology(dp_degree=4, ranks_per_node=4)))
        tcfg = TrainerConfig(model=cfg, steps=STEPS, global_batch=BATCH,
                             seq_len=SEQ, checkpoint=pol, log_every=100)
        tr = Trainer(tcfg, device=device)
        tr.init_state()
        t0 = time.perf_counter()
        _, metrics = tr.run()
        wall = time.perf_counter() - t0
        st = tr.saves[0].result()
        loss = float(metrics["loss"])
        print(f"  trained {cfg.name} ({MOE_LAYERS} layers) {STEPS} steps of "
              f"{BATCH} x {SEQ} in {wall:.2f} s (iterations "
              f"{[round(t, 3) for t in tr.iter_times]} s), loss {loss:.4f};"
              f" keyframe step {st.step}: {st.total_bytes} B, snapshot "
              f"{st.snapshot_seconds:.3f} s, persist {st.seconds:.3f} s, "
              f"commit {st.commit_seconds:.3f} s", flush=True)
        times["moe train 2 steps s"] = wall
        times["moe keyframe persist + commit s"] = (st.seconds
                                                    + st.commit_seconds)
        if len(tr.saves) != 1 or st.delta is not None \
                or not math.isfinite(loss):
            fail(f"{cfg.name}: {len(tr.saves)} saves, loss {loss}")
        live, position = tr.state, tr.data.position
        tr.engine.close()
        del tr, metrics
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tr2 = Trainer(tcfg, device=device)
        step = tr2.restore()
        torch.cuda.synchronize()
        times["moe restore s"] = time.perf_counter() - t0
        if step != STEPS or tr2.data.position != position:
            fail(f"{cfg.name} restore gave step {step} at data position "
                 f"{tr2.data.position}; expected {STEPS} at {position}")
        _same_state(f"{cfg.name} restore", flatten(tr2.state),
                    flatten(live))
        print(f"  restored step {step} in {times['moe restore s']:.2f} s; "
              f"all {len(flatten(live))} records bit-equal to the live "
              f"state, data position {position}", flush=True)
        tr2.engine.close()
        del live
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        batch = tr2.data.peek(tr2.data.position)
        routes = {}
        launches += _score_paper(cfg, tr2.state.params, batch,
                                 torch.bfloat16, times, routes)
        flips = _moe_routes(cfg, routes)
        print(f"  tokens routed to another expert by the plain forward: "
              f"{sum(flips)} of {cfg.n_layers} x {BATCH * SEQ}", flush=True)
        del tr2, routes
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the dense models at full width and depth, from seed 0
        for key in GPT3_DENSE:
            cfg = get_paper_config(key)
            params = build_model(cfg).init(0, device)
            print(f"  {cfg.name}: {cfg.n_layers} layers, d_model "
                  f"{cfg.d_model}, {cfg.n_heads} heads of "
                  f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}; "
                  f"{sum(t.numel() for _, t in flatten(params))} f32 params"
                  f" from seed 0", flush=True)
            bf = tree_map(lambda t: t.to(torch.bfloat16), params)
            launches += _score_paper(cfg, bf, batch, torch.bfloat16, times)
            del bf
            if key == "gpt3_2_7b":
                launches += _score_paper(cfg, params, batch, torch.float32,
                                         times)
                _greedy_decode(cfg, params, batch, device, times)
            del params
            gc.collect()
            torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _greedy_decode(cfg, params, batch, device, times):
    """A model in f32 (phases 8, 10, 11 and 12): prefill the batch's
    tokens (after its patch embeddings, which take their positions in
    the cache first, or given its audio frames), then ``M_NEW`` greedy
    decode steps; the prefill's and each step's logits against the plain
    forward over the prompt and the tokens generated so far, at
    TOL_DECODE."""
    import torch
    from repro_torch.models.registry import build_model

    plain = build_model(cfg, dtype=torch.float32)
    prompt = batch["tokens"]
    front = {k: v for k, v in batch.items()
             if k in ("patch_embeds", "audio_frames")}
    B, P = prompt.shape
    S = P + (front["patch_embeds"].shape[1] if "patch_embeds" in front
             else 0)
    with torch.inference_mode():
        cache = plain.init_cache(B, S + M_NEW, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = plain.prefill(params, {"tokens": prompt, **front},
                                    cache)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        tok = last[:, -1:].argmax(dim=-1).to(torch.int32)
        toks, dec = [tok], []
        t0 = time.perf_counter()
        for i in range(M_NEW):
            lg, cache = plain.decode(params, tok, cache, S + i)
            dec.append(lg[:, 0])
            tok = lg[:, -1:].argmax(dim=-1).to(torch.int32)
            toks.append(tok)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        del cache
        full, _ = plain.forward(params, {"tokens": torch.cat(
            [prompt] + toks[:M_NEW], dim=1), **front})
        print(f"  {cfg.name} f32 prefill {B} x {S}: {t_prefill:.4f} s; "
              f"{M_NEW} greedy decode steps {t_decode:.4f} s "
              f"({t_decode / M_NEW * 1e3:.2f} ms per token step of {B} "
              f"sequences)", flush=True)
        _close(f"{cfg.name} prefill logits vs forward", last[:, 0],
               full[:, S - 1], TOL_DECODE, rtol=0.0)
        _close(f"{cfg.name} {M_NEW} decode steps' logits vs forward",
               torch.stack(dec, dim=1), full[:, S:], TOL_DECODE, rtol=0.0)
    times[f"{cfg.name} f32 prefill s"] = t_prefill
    times[f"{cfg.name} f32 decode s per token step"] = t_decode / M_NEW


# --------------------------------------------------------------- phase 11
#: gemma2_9b's prompt (1 x 4608, past its 4096 window, so the local
#: layers' mask bites and the ring is gathered from a wrapped prompt) and
#: its least depth (two local/global pairs)
G_PROMPT, G_MIN_LAYERS = 4608, 4
#: MLA's absorbed decode against its naive one: the reference's
#: tolerance for the two paths (tests/test_perf_variants.py:52)
TOL_ABSORB = 2e-4


def _teacher_forced(plain, params, tokens, prompt: int, device, times,
                    what):
    """Prefill ``tokens[:, :prompt]``, then decode the rest one token at
    a time (teacher-forced); returns the prefill's last logits and each
    step's, (B, 1 + steps, V), with the cache the run left."""
    import torch
    B, L = tokens.shape
    cache = plain.init_cache(B, L, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = plain.prefill(params, {"tokens": tokens[:, :prompt]},
                                cache)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    out = [last[:, 0]]
    t0 = time.perf_counter()
    for i in range(prompt, L):
        lg, cache = plain.decode(params, tokens[:, i:i + 1], cache, i)
        out.append(lg[:, 0])
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    steps = L - prompt
    print(f"  {what}: prefill {B} x {prompt} {t_prefill:.4f} s; {steps} "
          f"decode steps {t_decode:.4f} s ({t_decode / steps * 1e3:.2f} ms "
          f"per token step of {B} sequences)", flush=True)
    times[f"{what} prefill s"] = t_prefill
    times[f"{what} decode s per token step"] = t_decode / steps
    return torch.stack(out, dim=1), cache


def _card_depth(cfg, free_bytes: int, least: int = 1, step: int = 1) -> int:
    """The deepest depth, a multiple of ``step`` and at least ``least``,
    whose f32 params take at most half the card's free memory; the rest
    holds the forward's f32 logits, the attention's scores and the
    casts of a layer's weights (gemma2_9b: two local/global pairs at
    least, pairs kept whole; internvl2_26b)."""
    per_layer = cfg._layer_params(0)
    fixed = cfg.param_count() - cfg.n_layers * per_layer
    fit = int((free_bytes / 2 / 4 - fixed) // per_layer)
    return max(least, min(cfg.n_layers, fit - fit % step))


def _run_gemma2(device, times):
    """gemma2_9b at its published widths, f32 from seed 0, as deep as the
    card holds (at least two pairs): the forward over 1 x (4608 + 16)
    tokens, then a 4608-token prefill through the paired ring cache and
    16 teacher-forced decode steps, each against the forward's logits at
    its position (TOL_DECODE); the rings hold W = 4096 slots."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models.registry import build_model
    from repro_torch.tree import flatten

    t_leg = time.perf_counter()
    full_cfg = get_config("gemma2_9b")
    depth = _card_depth(full_cfg, torch.cuda.mem_get_info(device)[0],
                        G_MIN_LAYERS, 2)
    cfg = dataclasses.replace(full_cfg, n_layers=depth)
    plain = build_model(cfg, dtype=torch.float32)
    params = plain.init(0, device)
    n_params = sum(t.numel() for _, t in flatten(params))
    cut = ("" if depth == full_cfg.n_layers else
           f"; CUT: n_layers {full_cfg.n_layers} -> {depth} (widths "
           f"unchanged) to fit the card")
    print(f"  {cfg.name}: {depth} layers (local/global pairs), d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, window {cfg.window_size}, caps "
          f"{cfg.attn_softcap}/{cfg.final_softcap}; {n_params} f32 params "
          f"from seed 0{cut}", flush=True)
    tokens = TokenStream(DataConfig(cfg.vocab_size, G_PROMPT + M_NEW, 1,
                                    seed=0), device=device).peek(0)["tokens"]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = plain.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        if logits.dtype != torch.float32 or not (
                logits.abs().max() <= cfg.final_softcap):
            fail(f"{cfg.name}: logits {logits.dtype}, largest "
                 f"{float(logits.abs().max())}")
        want = logits[:, G_PROMPT - 1:].clone()
        del logits
        print(f"  forward 1 x {G_PROMPT + M_NEW}: {t_fwd:.4f} s", flush=True)
        times["gemma2 f32 forward s"] = t_fwd
        got, cache = _teacher_forced(plain, params, tokens, G_PROMPT,
                                     device, times, "gemma2 f32")
        W = cache["k_loc"].shape[2] if "k_loc" in cache else None
        if W != cfg.window_size:
            fail(f"{cfg.name}: ring of {W} slots; expected "
                 f"{cfg.window_size}")
        print(f"  the local layers' rings hold W = {W} slots; the global "
              f"layers' cache {cache['k'].shape[2]}", flush=True)
        _close(f"{cfg.name} prefill and {M_NEW} teacher-forced decode "
               f"steps' logits vs forward (the ring wrapped)", got, want,
               TOL_DECODE, rtol=0.0)
    times["gemma2 layers"] = depth
    times["gemma2 leg s"] = time.perf_counter() - t_leg


def _run_minicpm3(device, times):
    """minicpm3_4b (MLA) at full depth, f32 from seed 0: the forward at 4
    x (512 + 16), then a 512-token prefill and 16 teacher-forced decode
    steps through the latent cache with ``mla_absorb`` off and on, each
    against the forward (TOL_DECODE) and the two against each other
    (TOL_ABSORB)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models.registry import build_model
    from repro_torch.tree import flatten

    t_leg = time.perf_counter()
    cfg = get_config("minicpm3_4b")
    plain = build_model(cfg, dtype=torch.float32)
    params = plain.init(0, device)
    m = cfg.mla
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, MLA ranks q {m.q_lora_rank} / kv "
          f"{m.kv_lora_rank}, qk {m.qk_nope_head_dim} + "
          f"{m.qk_rope_head_dim}, v {m.v_head_dim}, vocab {cfg.vocab_size};"
          f" {sum(t.numel() for _, t in flatten(params))} f32 params from "
          f"seed 0", flush=True)
    tokens = TokenStream(DataConfig(cfg.vocab_size, M_PROMPT + M_NEW,
                                    M_BATCH, seed=0),
                         device=device).peek(0)["tokens"]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = plain.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        print(f"  forward {M_BATCH} x {M_PROMPT + M_NEW}: {t_fwd:.4f} s",
              flush=True)
        times["minicpm3 f32 forward s"] = t_fwd
        want = logits[:, M_PROMPT - 1:].clone()
        del logits
        runs = {}
        for absorb in (False, True):
            what = f"minicpm3 f32 {'absorbed' if absorb else 'naive'}"
            model = build_model(dataclasses.replace(cfg, mla_absorb=absorb),
                                dtype=torch.float32)
            runs[absorb], cache = _teacher_forced(
                model, params, tokens, M_PROMPT, device, times, what)
            if sorted(cache) != ["latent"] or cache["latent"].shape[-1] \
                    != m.kv_lora_rank + m.qk_rope_head_dim:
                fail(f"{what}: cache {sorted(cache)}")
            del cache
            _close(f"{what}: prefill and {M_NEW} decode steps' logits vs "
                   f"forward", runs[absorb], want, TOL_DECODE, rtol=0.0)
        _close(f"{cfg.name} absorbed vs naive decode logits", runs[True],
               runs[False], TOL_ABSORB)
    times["minicpm3 leg s"] = time.perf_counter() - t_leg


def decoder_families(device, disk_peak: int, kernel_ms: float,
                     times: dict) -> int:
    """Phase 11: the remaining decoder families at their published
    widths, one model on the card at a time: zamba2_2_7b (B4 in its
    stack), gemma2_9b (windows, soft-caps, the ring cache) and
    minicpm3_4b (MLA, both decode paths). Keeps its disk peak under 90 %
    of phase 4's. Returns B4's launches on the zamba2 forward."""
    import gc

    import torch
    print(f"phase 11: the remaining decoder families at their published "
          f"widths", flush=True)
    launches = run_ssm_model("zamba2_2_7b", device, kernel_ms,
                             _disk_budget(disk_peak), times)
    for run in (_run_gemma2, _run_minicpm3):
        gc.collect()
        torch.cuda.empty_cache()
        run(device, times)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- phase 12
#: whisper_small's text context: the forward's tokens, and the decode
#: check's prompt (W_CTX - M_NEW) plus its M_NEW greedy steps
W_CTX = 448
#: the state fastpersist_vs_baseline saves, MiB
FVB_MB = 1024


def _run_internvl2(device, kernel_ms: float, times) -> int:
    """internvl2_26b at its published widths, f32 params from seed 0, as
    deep as half the card's free memory allows: a batch of 4 x (256
    patch embeddings from a seeded generator + 512 tokens) scored through
    B3 in bf16, the weights cast at use (each layer's attention output
    against the plain version, the loss over the text against the plain
    forward's, one launch per layer), a warm call with B3's share at
    phase 3's ``kernel_ms`` a launch; then a 4 x (256 + 512) prefill and
    16 greedy decode steps in f32 against the forward. Returns B3's
    launches."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.tree import flatten

    t_leg = time.perf_counter()
    full = get_config("internvl2_26b")
    depth = _card_depth(full, torch.cuda.mem_get_info(device)[0])
    cfg = dataclasses.replace(full, n_layers=depth)
    params = build_model(cfg).init(0, device)
    n_params = sum(t.numel() for _, t in flatten(params))
    print(f"  CUT: {full.name} n_layers {full.n_layers} -> {depth} (widths "
          f"unchanged: d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.n_frontend_tokens} "
          f"patch tokens) so that its f32 params take at most half the "
          f"card's free memory: {n_params} f32 params from seed 0; all "
          f"{full.n_layers} layers are {full.param_count()} params, "
          f"{4 * full.param_count()} B in f32", flush=True)
    batch = make_batch(cfg, BATCH, SEQ, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    batch["patch_embeds"] = torch.randn(batch["patch_embeds"].shape,
                                        generator=gen, device=device)
    launches = _score_paper(cfg, params, batch, torch.bfloat16, times)
    warm = times[f"{cfg.name} bf16 loss first/warm s"][1]
    share = launches * kernel_ms
    print(f"  B3's {launches} launches at phase 3's {kernel_ms:.4f} ms: "
          f"{share:.3f} ms, {100 * share / 1e3 / warm:.1f} % of the warm "
          f"bf16 loss ({warm:.4f} s, the casts of the f32 weights "
          f"included)", flush=True)
    _greedy_decode(cfg, params, batch, device, times)
    times["internvl2 layers"] = depth
    times["internvl2 leg s"] = time.perf_counter() - t_leg
    return launches


def _run_whisper(device, disk_budget: float, times):
    """whisper_small at full depth, f32 from seed 0: its params through
    the engine and back bit-equal; the forward at 4 x 1500 audio frames
    (from a seeded generator) x 448 tokens; a prefill of the frames and
    432 tokens and 16 greedy decode steps against the forward. No kernel
    runs, as in the reference."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models.registry import build_model
    from repro_torch.tree import flatten

    t_leg = time.perf_counter()
    cfg = get_config("whisper_small")
    model = build_model(cfg, dtype=torch.float32)
    params = model.init(0, device)
    n_params = sum(t.numel() for _, t in flatten(params))
    print(f"  {cfg.name}: {cfg.n_enc_layers} encoder + {cfg.n_layers} "
          f"decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.n_enc_ctx} frames; {n_params} f32 "
          f"params ({4 * n_params} B) from seed 0", flush=True)
    _engine_round_trip(cfg, model, params, device, disk_budget, times)
    gen = torch.Generator(device=device).manual_seed(0)
    frames = torch.randn((M_BATCH, cfg.n_enc_ctx, cfg.d_model),
                         generator=gen, device=device)
    tokens = TokenStream(DataConfig(cfg.vocab_size, W_CTX, M_BATCH, seed=0),
                         device=device).peek(0)["tokens"]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, aux = model.forward(params, {"tokens": tokens,
                                             "audio_frames": frames})
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        if logits.shape != (M_BATCH, W_CTX, cfg.vocab_size) \
                or not bool(torch.isfinite(logits).all()) or float(aux):
            fail(f"{cfg.name}: logits {tuple(logits.shape)}, finite "
                 f"{bool(torch.isfinite(logits).all())}, aux {float(aux)}")
        del logits
    print(f"  f32 forward {M_BATCH} x {cfg.n_enc_ctx} frames x {W_CTX} "
          f"tokens: {t_fwd:.4f} s", flush=True)
    times["whisper f32 forward s"] = t_fwd
    _greedy_decode(cfg, params, {"tokens": tokens[:, :W_CTX - M_NEW],
                                 "audio_frames": frames}, device, times)
    times["whisper leg s"] = time.perf_counter() - t_leg


def _run_write_rates(times):
    """``repro_torch.launch.fastpersist_vs_baseline --mb 1024`` on the
    card: the baseline and each FastPersist variant save the same state
    once (a failed save raises); each must have written the whole
    state."""
    from repro_torch.launch import fastpersist_vs_baseline as fvb
    t_leg = time.perf_counter()
    print(f"  repro_torch.launch.fastpersist_vs_baseline --mb {FVB_MB} "
          f"--device cuda:", flush=True)
    results, t_submit = fvb.main(["--mb", str(FVB_MB), "--device", "cuda",
                                  "--dir", tempfile.gettempdir()])
    n_bytes = FVB_MB * 1024 * 1024 // 14 * 14
    for name, st in results.items():
        if st.total_bytes < n_bytes or not st.gbps > 0:
            fail(f"{name}: wrote {st.total_bytes} B of a {n_bytes} B "
                 f"state at {st.gbps} GB/s")
        times[f"{name} GB/s"] = st.gbps
    times["pipelined submit ms"] = t_submit * 1e3
    times["write rates leg s"] = time.perf_counter() - t_leg


def frontend_families(device, disk_peak: int, kernel_ms: float,
                      times: dict) -> int:
    """Phase 12: the two frontend families at their published widths, one
    model on the card at a time — internvl2_26b (cut in depth; B3 at GQA
    6:1, head dim 128) and whisper_small (full depth) — then the
    FastPersist-against-baseline example. Returns B3's launches on the
    internvl2 forward."""
    import gc

    import torch
    print("phase 12: the two frontend families at their published widths"
          " and the write-rate example", flush=True)
    launches = _run_internvl2(device, kernel_ms, times)
    gc.collect()
    torch.cuda.empty_cache()
    _run_whisper(device, _disk_budget(disk_peak), times)
    gc.collect()
    torch.cuda.empty_cache()
    _run_write_rates(times)
    return launches


# --------------------------------------------------------------- phase 13
#: phase 13's meshes (data x model) of EP_WORLD processes on the one card,
#: joined by gloo (NCCL refuses two ranks on one GPU), and their time limit
EP_MESHES = ((1, 4), (2, 2))
EP_WORLD = 4
EP_TIMEOUT = 240
#: gpt3_1_8b_moe's logits on each rank against the single-process
#: forward: the model-level tolerance of the bf16 kernel path (B3's) and
#: the f32 one; the aux against the per-data-shard rule
TOL_EP_BF16, TOL_EP_F32, TOL_EP_AUX = 2e-2, 1e-4, 1e-6
#: qwen3_moe_235b's MoE layer: its published widths (d 4096, 128 experts
#: of d_ff 1536, top 8, capacity 1.25) on the main path's batch
EP_LAYER = "qwen3_moe_235b"


def _ep_first_flips(gi_got, gi_want, rows):
    """Per sequence, the first position whose routing differs between
    the two forwards in any layer (``SEQ`` where none does): a bf16 near
    tie can route a token elsewhere, and through attention every later
    token of its sequence then sees other inputs."""
    import torch
    differs = torch.zeros(rows.stop - rows.start, SEQ, dtype=torch.bool,
                          device=gi_got[0].device)
    for got, want in zip(gi_got, gi_want):
        g = got.reshape(-1, SEQ, got.shape[-1])
        w = want.reshape(BATCH, SEQ, want.shape[-1])[rows]
        differs |= (g != w).any(-1)
    pos = torch.arange(SEQ, device=differs.device)
    return torch.where(differs, pos, SEQ).min(dim=1).values


def _ep_shard_aux(cfg, routes, rows_of):
    """The reference's aux on expert-parallel ranks: each data shard's
    own load-balance loss (summed over the layers), from the
    single-process routing, averaged over the shards."""
    import torch
    import torch.nn.functional as F
    E = cfg.moe.n_experts
    out = []
    for rows in rows_of:
        aux = 0.0
        for probs, gi in routes:
            p = probs.reshape(BATCH, SEQ, E)[rows].reshape(-1, E)
            c = F.one_hot(gi.reshape(BATCH, SEQ, -1)[rows], E).float()
            aux += float(cfg.moe.aux_loss_coef * E * torch.sum(
                p.mean(0) * c.sum(-2).reshape(-1, E).mean(0)))
        out.append(aux)
    return sum(out) / len(out)


def _ep_model_rank(rank, device):
    """Phase 13 (a) on one rank: gpt3_1_8b_moe cut to ``MOE_LAYERS``
    layers, f32 params from seed 0 (the same on every rank), capacity =
    n_experts (no drops). Rank 0 runs the single-process forward over
    the whole batch through B3 (bf16 and f32, routing recorded) and
    sends its logits and routing to every rank. Then on each mesh of
    ``EP_MESHES`` this rank's ``local_params`` and data shard go through
    ``build_model(use_kernels=True, mesh=...)`` — B3's launches counted
    around it — held against the single-process rows."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_paper_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.models import layers as ly
    from repro_torch.models import transformer
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.sharding.moe_ep import local_params, make_moe_ep
    from repro_torch.tree import tree_map

    full = get_paper_config("gpt3_1_8b_moe")
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS, moe=dataclasses
                              .replace(full.moe, capacity_factor=float(
                                  full.moe.n_experts)))
    params = build_model(cfg).init(0, device)
    tokens = make_batch(cfg, BATCH, SEQ, seed=13, device=device)["tokens"]

    def fa(q, k, v, cap=None):
        return ops.flash_attention(q, k, v, causal=True, cap=cap)

    def recording(routes, inner=None):
        def moe(p, h, c):
            r = ly.moe_route(p, h, c)
            routes.append((r.probs, r.gate_i))
            return inner(p, h, c) if inner else ly.moe_apply(p, h, c)
        return moe

    def cast(tree, dt):
        return tree if dt == torch.float32 else tree_map(
            lambda t: t.to(dt), tree)

    dtypes = (torch.bfloat16, torch.float32)
    single = {}
    with torch.inference_mode():
        # the oracle: once, on rank 0; its logits go out as f32 (exact
        # for bf16), the routing as it is
        flat = {}
        if rank == 0:
            for dt in dtypes:
                routes = []
                logits, _ = transformer.forward(
                    cast(params, dt), cfg, {"tokens": tokens}, dtype=dt,
                    attn_kernel=fa, moe_kernel=recording(routes))
                flat[dt] = [t.contiguous() for t in [logits.float()] + [
                    t for r in routes for t in r]]
        box = [{dt: [(tuple(t.shape), t.dtype) for t in ts]
                for dt, ts in flat.items()}]
        dist.broadcast_object_list(box, src=0)
        for dt in dtypes:
            ts = flat.get(dt) or [torch.empty(shape, dtype=t, device=device)
                                  for shape, t in box[0][dt]]
            for t in ts:
                dist.broadcast(t, src=0)
            single[dt] = (ts[0], list(zip(ts[1::2], ts[2::2])))
        del flat
    out = {"launches": 0, "meshes": {}}
    for shape in EP_MESHES:
        mesh = init_process_mesh(shape, ("data", "model"), backend="gloo",
                                 device=device)
        b_loc = BATCH // shape[0]
        d = mesh.coords["data"]
        rows = slice(d * b_loc, (d + 1) * b_loc)
        local = local_params(params, mesh)
        model_rows = {}
        for dt in dtypes:
            model = build_model(cfg, dtype=dt, use_kernels=True, mesh=mesh)
            p = cast(local, dt)
            with torch.inference_mode():
                torch.cuda.synchronize()
                _zero_counts()     # just before the expert-parallel path
                t0 = time.perf_counter()
                logits, aux = model.forward(p, {"tokens": tokens[rows]})
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                launches = ops.flash_attention.launches
                t0 = time.perf_counter()
                model.forward(p, {"tokens": tokens[rows]})
                torch.cuda.synchronize()
                warm = time.perf_counter() - t0
                routes = []
                transformer.forward(p, cfg, {"tokens": tokens[rows]},
                                    dtype=dt, attn_kernel=fa,
                                    moe_kernel=recording(routes,
                                                         make_moe_ep(mesh)))
            if launches != cfg.n_layers:
                fail(f"rank {rank} mesh {shape}: the expert-parallel "
                     f"forward launched B3 {launches} times; expected "
                     f"{cfg.n_layers}")
            out["launches"] += launches
            want, want_routes = single[dt]
            first_flip = _ep_first_flips([g for _, g in routes],
                                         [g for _, g in want_routes], rows)
            keep = (torch.arange(SEQ, device=device)[None, :]
                    < first_flip[:, None])
            f32 = dt == torch.float32
            tol = TOL_EP_F32 if f32 else TOL_EP_BF16
            shares = []
            err = _close(f"rank {rank} mesh {shape} {dt} logits",
                         logits[keep], want[rows][keep], tol, quiet=True,
                         shares=shares)
            want_aux = _ep_shard_aux(
                cfg, want_routes, [slice(i * b_loc, (i + 1) * b_loc)
                                   for i in range(shape[0])])
            aux_tol = TOL_EP_AUX if f32 else TOL_LOSS_BF16 * abs(want_aux)
            if abs(float(aux) - want_aux) > aux_tol:
                fail(f"rank {rank} mesh {shape} {dt}: aux {float(aux)} vs "
                     f"the per-data-shard rule {want_aux} beyond {aux_tol}")
            model_rows[str(dt).split(".")[-1]] = {
                "max_abs_err": err, "share": shares[0],
                "tokens_held": int(keep.sum()),
                "tokens_after_a_flip": int((~keep).sum()),
                "aux": float(aux), "aux_rule": want_aux,
                "first_s": first, "warm_s": warm, "launches": launches}
            del logits, model
        out["meshes"][f"{shape[0]}x{shape[1]}"] = {
            "coords": mesh.coords, **model_rows}
        del local
    return out


def _ep_layer_rank(rank, device):
    """Phase 13 (b) on one rank of the 1 x 4 mesh: qwen3_moe_235b's MoE
    layer at its published widths. The ranks make the full layer from
    seed 0 in turn (one full layer on the card at a time) and keep their
    32 experts; rank 0 first runs and times the single-process sorted
    and einsum layers and sends the sorted output (the same capacity and
    drop policy) to every rank. Each rank's expert-parallel output is
    held against it within 1e-4."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.models import layers as ly
    from repro_torch.sharding.moe_ep import EXPERT_SPEC, make_moe_ep
    from repro_torch.sharding.specs import local_slice

    cfg = get_config(EP_LAYER)
    mesh = init_process_mesh((1, EP_WORLD), ("data", "model"),
                             backend="gloo", device=device)
    gen = torch.Generator(device=device).manual_seed(21)
    x = torch.randn((BATCH, SEQ, cfg.d_model), generator=gen, device=device)
    out = {}

    def timed(fn, n=3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return res, first, (time.perf_counter() - t0) / n

    ref = torch.empty_like(x)
    with torch.inference_mode():
        for r in range(EP_WORLD):
            if r == rank:
                full = ly.moe_init(cfg, torch.Generator(device=device)
                                   .manual_seed(0), device)
                out["full_layer_bytes"] = sum(
                    t.numel() * t.element_size() for t in full.values())
                if rank == 0:
                    (ref, _), out["sorted_first_s"], out["sorted_s"] = \
                        timed(lambda: ly.moe_apply_sorted(full, x, cfg))
                    (ein, _), out["einsum_first_s"], out["einsum_s"] = \
                        timed(lambda: ly.moe_apply(full, x, cfg), n=1)
                    out["einsum_vs_sorted_max_abs"] = float(
                        (ein - ref).abs().max())
                    del ein
                mine = {k: local_slice(v, EXPERT_SPEC, mesh)
                        .clone() if k in ("wi", "wg", "wo") else v
                        for k, v in full.items()}
                del full
                torch.cuda.empty_cache()
            dist.barrier()
        dist.broadcast(ref, src=0)
        kernel = make_moe_ep(mesh)
        dist.barrier()
        (got, aux), out["ep_first_s"], out["ep_s"] = timed(
            lambda: kernel(mine, x, cfg))
        r = ly.moe_route(mine, x, cfg)
        counts = torch.bincount(r.gate_i.reshape(-1),
                                minlength=cfg.moe.n_experts)
        out["dropped"] = int((counts - r.C).clamp(min=0).sum())
        out["capacity"] = r.C
    shares = []
    out["max_abs_err"] = _close(f"rank {rank} {EP_LAYER} layer", got, ref,
                                TOL_EP_F32, quiet=True, shares=shares)
    out["share"] = shares[0]
    out["local_expert_bytes"] = sum(
        mine[k].numel() * mine[k].element_size() for k in ("wi", "wg", "wo"))
    return out


def _ep_rank(rank, device: str):
    """One of phase 13's ``EP_WORLD`` processes, all on the one card
    ``device``: (a), then (b). Returns its numbers."""
    import gc

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(device)
    t0 = time.perf_counter()
    out = {"a": _ep_model_rank(rank, device)}
    gc.collect()
    torch.cuda.empty_cache()
    out["b"] = _ep_layer_rank(rank, device)
    out["seconds"] = time.perf_counter() - t0
    return out


def _op_cost_on_card(device, times):
    """Phase 13 (c), second half: ``op_cost`` around one real bf16 forward
    of (a)'s model on the card (no kernel: every product is an aten op,
    the attention ``layers.attention`` through the hook, where the card
    would take the flash-attention kernel) and around the same forward on
    meta tensors; the two flop counts must be equal. A warm forward
    outside the counter gives the achieved rate."""
    import dataclasses
    from functools import partial

    import torch
    from repro_torch.configs import get_paper_config
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models import layers as ly
    from repro_torch.models import transformer
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.tree import tree_map

    def plain_attention(q, k, v, cap=None):
        pos = torch.arange(q.shape[2], device=q.device)
        return ly.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), q_pos=pos, kv_pos=pos,
                            cap=cap).transpose(1, 2)

    cfg = dataclasses.replace(get_paper_config("gpt3_1_8b_moe"),
                              n_layers=MOE_LAYERS)
    forward = partial(transformer.forward, cfg=cfg,
                      attn_kernel=plain_attention)
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      build_model(cfg).init(0, device))
    batch = make_batch(cfg, BATCH, SEQ, seed=13, device=device)
    meta = tree_map(lambda t: torch.empty_like(t, device="meta"), params)
    meta_batch = {k: torch.empty_like(v, device="meta")
                  for k, v in batch.items()}
    with torch.inference_mode():
        with OpCost() as on_card:
            forward(params, batch=batch)
            torch.cuda.synchronize()
        with OpCost() as on_meta:
            forward(meta, batch=meta_batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(params, batch=batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    card, dry = on_card.aggregate(), on_meta.aggregate()
    if card["flops"] != dry["flops"] or not card["flops"] > 0:
        fail(f"op_cost: {card['flops']} flops counted on the card, "
             f"{dry['flops']} on meta for the same forward")
    names = sorted(set(on_card.by_op) | set(on_meta.by_op))
    differ = {n: [on_card.by_op.get(n, 0), on_meta.by_op.get(n, 0)]
              for n in names
              if on_card.by_op.get(n, 0) != on_meta.by_op.get(n, 0)}
    print(f"  op_cost bytes of the same forward that differ between the "
          f"card and meta, by aten op [card, meta]: {json.dumps(differ)}; "
          f"one_hot counted whole: {on_card.by_op.get('one_hot', 0)} B on "
          f"the card, {on_meta.by_op.get('one_hot', 0)} B on meta",
          flush=True)
    times["op_cost bytes card vs meta by op"] = differ
    # F.one_hot is one op of its own (op_cost.WHOLE), not ATen's
    # per-device decomposition, so the bytes agree too
    if card["bytes"] != dry["bytes"] or not card["bytes"] > 0:
        fail(f"op_cost: {card['bytes']:.0f} bytes counted on the card, "
             f"{dry['bytes']:.0f} on meta for the same forward")
    rate = card["flops"] / wall / 1e12
    print(f"  op_cost of one bf16 forward of {cfg.name} ({MOE_LAYERS} "
          f"layers, {BATCH} x {SEQ}, einsum dispatch, no kernel): "
          f"{card['flops']:.0f} flops on the card = {dry['flops']:.0f} on "
          f"meta; bytes {card['bytes']:.0f} vs {dry['bytes']:.0f}; warm "
          f"wall {wall:.4f} s: {rate:.1f} TFLOP/s against the 989 TFLOP/s "
          f"bf16 peak", flush=True)
    times["op_cost forward flops"] = card["flops"]
    times["op_cost forward warm s"] = wall
    times["op_cost forward TFLOP/s"] = rate


def expert_parallel(device, times: dict) -> int:
    """Phase 13: expert parallelism across ``EP_WORLD`` processes on the
    card and the dry run. (a) gpt3_1_8b_moe through
    ``build_model(mesh=...)`` on the meshes of ``EP_MESHES``; (b)
    qwen3_moe_235b's MoE layer at its published widths on 1 x 4; (c)
    ``dryrun.lower_one("gpt3_1_8b_moe", "train_4k")`` with and without
    ``shard_map_moe`` on the 16 x 16 mesh, and ``op_cost`` on the card
    against meta. A rank that fails, exits non-zero or outlasts
    ``EP_TIMEOUT`` fails the phase. Returns B3's launches on (a)'s
    expert-parallel forwards, summed over the ranks."""
    import gc

    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import run_ranks

    print(f"phase 13: expert parallelism across {EP_WORLD} processes on "
          f"the card (gloo) and the dry run", flush=True)
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(_ep_rank, EP_WORLD, (str(device),),
                          backend="gloo", timeout=EP_TIMEOUT)
    except RuntimeError as e:
        fail(f"phase 13: {e}")
    times["ranks s"] = time.perf_counter() - t0
    launches = 0
    for rank, r in enumerate(ranks):
        launches += r["a"]["launches"]
        for mesh, m in r["a"]["meshes"].items():
            for dt in ("bfloat16", "float32"):
                e = m[dt]
                print(f"  (a) rank {rank} mesh {mesh} {m['coords']} {dt}: "
                      f"logits max_abs_err {e['max_abs_err']:.3g} (share "
                      f"{e['share']:.3f}) over {e['tokens_held']} tokens, "
                      f"{e['tokens_after_a_flip']} after a routing flip "
                      f"left out; aux {e['aux']:.6f} vs the per-shard rule"
                      f" {e['aux_rule']:.6f}; forward first "
                      f"{e['first_s']:.4f} s, warm {e['warm_s']:.4f} s; "
                      f"{e['launches']} B3 launches", flush=True)
        b = r["b"]
        print(f"  (b) rank {rank}: {EP_LAYER} layer max_abs_err "
              f"{b['max_abs_err']:.3g} (share {b['share']:.3f}), "
              f"{b['dropped']} (token, k) dropped at capacity "
              f"{b['capacity']}; EP first {b['ep_first_s']:.4f} s, warm "
              f"{b['ep_s']:.4f} s; {b['local_expert_bytes']} B of experts "
              f"(full layer {b['full_layer_bytes']} B); rank seconds "
              f"{r['seconds']:.1f}", flush=True)
    b0 = ranks[0]["b"]
    print(f"  (b) one process: sorted first {b0['sorted_first_s']:.4f} s, "
          f"warm {b0['sorted_s']:.4f} s; einsum first "
          f"{b0['einsum_first_s']:.4f} s, warm {b0['einsum_s']:.4f} s "
          f"(its drops by arrival order: {b0['einsum_vs_sorted_max_abs']:.3g}"
          f" from sorted); expert-parallel on 4 ranks sharing the card, "
          f"warm {max(r['b']['ep_s'] for r in ranks):.4f} s", flush=True)
    times.update({"ep layer warm s": max(r["b"]["ep_s"] for r in ranks),
                  "sorted layer warm s": b0["sorted_s"],
                  "einsum layer warm s": b0["einsum_s"]})
    gc.collect()
    torch.cuda.empty_cache()
    for ep in (False, True):
        t1 = time.perf_counter()
        r = dryrun.lower_one("gpt3_1_8b_moe", "train_4k", verbose=False,
                             shard_map_moe=ep)
        keys = ("flops_per_device", "bytes_per_device",
                "collective_total_per_device", "t_compute_s", "t_memory_upper_s",
                "t_collective_s", "useful_flops_ratio", "dominant")
        print(f"  (c) dry run gpt3_1_8b_moe train_4k on 16 x 16, "
              f"shard_map_moe={ep}, in {time.perf_counter() - t1:.2f} s: "
              f"{json.dumps({k: r[k] for k in keys})}, argument bytes per "
              f"device {r['memory']['argument_size_bytes']}", flush=True)
        times[f"dry run shard_map_moe={ep}"] = {k: r[k] for k in keys}
    _op_cost_on_card(device, times)
    return launches


# --------------------------------------------------------------- phase 14
class _DiskPeak:
    """The most the filesystems under ``paths`` held together above
    their levels at start, sampled every ``period`` seconds on a thread
    (statvfs only; two paths on one filesystem count once)."""

    def __init__(self, paths, period: float = 0.2):
        import threading
        by_dev = {os.stat(p).st_dev: p for p in paths if os.path.isdir(p)}
        self.paths, self.period = list(by_dev.values()), period
        self.start = self._used()
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def _used(self) -> int:
        return sum(shutil.disk_usage(p).used for p in self.paths)

    def _watch(self):
        while not self._stop.wait(self.period):
            self.sample()

    def sample(self):
        self.peak = max(self.peak, self._used() - self.start)

    def stop(self) -> int:
        self._stop.set()
        self._thread.join()
        self.sample()
        return self.peak


def _figure_kernels(device) -> dict:
    """B2, its quantize mode and B1 at the shapes phase 14's figures give
    them, held against their plain versions before the figures run (these
    launches stay out of the counts): B2 and the quantize mode on
    beyond_quant's four leaves (bf16 and f32, at the quantizer's block
    with a ragged tail), B1 on fig_snapshot's f32
    dirty blob at the device-dirty block, against its image before a
    step that touches a tenth of its pages. Returns the largest error by
    kernel name."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import beyond_quant, fig_snapshot
    from repro_torch.core import quant
    from repro_torch.core.checkpointer import DIRTY_BLOCK
    from repro_torch.kernels import ckpt_pack as cp
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (ckpt_pack_dirty_plain,
                                         ckpt_pack_plain, ckpt_quant_plain)
    errs = {"ckpt_quant_blocks": 0.0}
    for name, leaf in beyond_quant.synth_moments(beyond_quant.QUICK_MB,
                                                 device).items():
        x2d = ops._to_blocks(leaf.reshape(-1), quant.BLOCK)
        q, scale = cp.ckpt_quant_blocks(leaf.reshape(-1), block=quant.BLOCK)
        pq, ps = ckpt_quant_plain(x2d)
        torch.cuda.synchronize()
        if not (torch.equal(q, pq.reshape(-1)[:leaf.numel()])
                and torch.equal(_ints(scale), _ints(ps))):
            fail(f"phase 14: ckpt_quant_blocks on beyond_quant's {name} "
                 f"differs from the plain version")
        got = cp.ckpt_pack_blocks(x2d, out_dtype=torch.bfloat16)
        want = ckpt_pack_plain(x2d, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        err = _compare(f"ckpt_pack_blocks beyond_quant {name}", got, want,
                       bits=False)
        errs["ckpt_pack_blocks"] = max(errs.get("ckpt_pack_blocks", 0.0),
                                       err)
        print(f"  ok ckpt_pack_blocks on beyond_quant's {name} "
              f"{leaf.dtype} ({leaf.numel()} elements, {x2d.shape[0]} "
              f"blocks of {quant.BLOCK}): max_abs_err {err}; "
              f"ckpt_quant_blocks bit-equal", flush=True)
    rng = np.random.default_rng(23)
    mb = fig_snapshot.QUICK_DIRTY_MB
    w = torch.from_numpy(rng.standard_normal(mb * (1 << 20) // 4)
                         .astype(np.float32)).to(device)
    block = DIRTY_BLOCK // w.element_size()
    prev2d = ops.pack_blocks(w, block=block)
    fig_snapshot._touch_pages(w, rng, 0.1)
    x2d = ops._to_blocks(w, block)
    got = cp.ckpt_pack_dirty_blocks(x2d, prev2d, out_dtype=w.dtype)
    want = ckpt_pack_dirty_plain(x2d, prev2d, out_dtype=w.dtype)
    torch.cuda.synchronize()
    errs["ckpt_pack_dirty_blocks"] = _compare(
        "ckpt_pack_dirty_blocks fig_snapshot", got, want, bits=True)
    print(f"  ok ckpt_pack_dirty_blocks on fig_snapshot's {mb} MiB f32 "
          f"blob ({x2d.shape[0]} blocks of {block}, {int(got[2].sum())} "
          f"dirty): max_abs_err {errs['ckpt_pack_dirty_blocks']}",
          flush=True)
    return errs


def _hold_quant_scales(bq: dict, device):
    """Fail unless every block scale beyond_quant's int8 save took from
    the quantize kernel on the card equals the plain version's on the
    same leaves (drawn again from the figure's seed)."""
    import numpy as np
    from repro_torch.benchmarks import beyond_quant
    from repro_torch.core import quant
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ckpt_quant_plain
    from repro_torch.tree import flatten
    used = bq[True].device_scales
    leaves = dict(flatten(beyond_quant.synth_moments(beyond_quant.QUICK_MB,
                                                     device)))
    if sorted(used) != sorted(leaves):
        fail(f"phase 14: beyond_quant's int8 save took scales from the "
             f"card for {sorted(used)}; expected {sorted(leaves)}")
    for name, leaf in leaves.items():
        want = ckpt_quant_plain(ops._to_blocks(leaf.reshape(-1),
                                               quant.BLOCK))[1]
        if np.asarray(used[name]).tobytes() != want.cpu().numpy().tobytes():
            fail(f"phase 14: beyond_quant's int8 save of {name} took "
                 f"block scales that differ from the plain version's")
    print(f"  ok beyond_quant's int8 save: the block scales of "
          f"{sorted(leaves)} equal the plain version's", flush=True)


#: the dry-run pairs phase 14 writes for the tables: phase 13's pair with
#: and without expert parallelism, and one decode pair
FIGURE_DRY_RUNS = (("gpt3_1_8b_moe", "train_4k", False),
                   ("gpt3_1_8b_moe", "train_4k", True),
                   ("stablelm_1_6b", "decode_32k", False))


def _figure_dry_runs() -> dict:
    """Count ``FIGURE_DRY_RUNS`` on meta tensors on the 16 x 16 mesh and
    write them where the port's ``roofline`` and ``make_tables`` read
    (``experiments/torch/dryrun`` under the working directory). Returns
    the results by roofline key."""
    from repro_torch.benchmarks.roofline import dryrun_dir, row_key
    from repro_torch.launch import dryrun
    out = dryrun_dir()
    os.makedirs(out, exist_ok=True)
    rows = {}
    for arch, shape, ep in FIGURE_DRY_RUNS:
        r = dryrun.lower_one(arch, shape, verbose=False, shard_map_moe=ep)
        tag = "pod_ep" if ep else "pod"
        with open(os.path.join(out, f"{arch}__{shape}__{tag}.json"),
                  "w") as f:
            json.dump(r, f, indent=2)
        rows[row_key(r)] = r
    return rows


def _hold_tier_figures(results: dict, times: dict):
    """The durability tiers' bit-exact round trips and fig_serve's
    deterministic fields, held; their timed verdicts and the analytic
    projections printed, never held."""
    f13, peer, serve = (results["fig13"], results["fig_peer"],
                        results["fig_serve"])
    bad = [] if f13["roundtrip_ok"] else ["fig13 remote round trip"]
    bad += [] if peer["failover_ok"] else ["fig_peer failover"]
    if bad:
        fail(f"phase 14: restores onto the card not bit-exact: {bad}")
    if serve["warm_fetched_bytes"] != 0 or not serve["dedup_metadata_only"]:
        fail(f"phase 14: fig_serve fetched {serve['warm_fetched_bytes']} B "
             f"warm (0 expected); dedup to metadata only: "
             f"{serve['dedup_metadata_only']}")
    print(f"  bit-exact onto the card: fig13's remote round trip "
          f"({f13['mb']} MiB), fig_peer's failover from a surviving peer "
          f"({peer['mb']} MiB), fig_serve's served head; fig_serve warm "
          f"hydration fetched 0 B, the unchanged re-save deduped to "
          f"metadata ({serve['dedup_bytes_saved']} B)", flush=True)
    verdicts = {
        "fig13 overhead_pct": f13["overhead_pct"],
        "fig13 overlap_pct": f13["overlap_pct"],
        "fig13 verdict": f13["verdict"],
        "fig_peer tier_gap_x": peer["tier_gap_x"],
        "fig_peer t_replicated_ms": peer["t_replicated_ms"],
        "fig_peer t_uploaded_ms": peer["t_uploaded_ms"],
        "fig_peer verdict": peer["verdict"],
        "fig_serve speedup_4x": serve["speedup_4x"],
        "fig_serve tensor_fetch_frac": serve["tensor_fetch_frac"],
        "fig_serve verdict": serve["verdict"],
        "fig10b e2e by dp": {str(k): v for k, v in results["fig10"].items()},
        "fig12 speedup": {f"{k}/dp{dp}": v
                          for (k, dp), v in results["fig12"].items()},
    }
    print(f"  verdicts (measurements and projections, not held): "
          f"{json.dumps(verdicts)}", flush=True)
    times["tier verdicts"] = verdicts


def _hold_tables(results: dict, dry: dict):
    """The roofline's rows keep the dry run's ``dominant``; then every
    table is printed."""
    import contextlib
    import io

    from repro_torch.benchmarks import make_tables
    rows = results["roofline"]
    if sorted(rows) != sorted(dry):
        fail(f"phase 14: roofline rows {sorted(rows)}; the dry run wrote "
             f"{sorted(dry)}")
    off = {k: (rows[k][3], r["dominant"]) for k, r in dry.items()
           if rows[k][3] != r["dominant"]}
    if off:
        fail(f"phase 14: roofline dominant differs from the dry run's: "
             f"{off}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        make_tables.render()
    text = buf.getvalue()
    for want in ("### Roofline", "### Tiered durability",
                 "### Peer-replication", "### Checkpoint serving",
                 "989 TF/s"):
        if want not in text:
            fail(f"phase 14: make_tables printed no {want!r}")
    print(f"  roofline dominant equals the dry run's on "
          f"{ {k: r['dominant'] for k, r in dry.items()} }; the tables:",
          flush=True)
    print(text, flush=True)


def paper_figures(device, disk_peak: int, times: dict) -> dict:
    """Phase 14: the paper's figures through ``repro_torch.benchmarks.run``
    in this process on the card at their quick sizes, with
    ``FASTPERSIST_BENCH_DIR`` and the working directory in a temporary
    directory, where the dry run of ``FIGURE_DRY_RUNS`` is written first
    for ``roofline``. Every figure must run; the bit-exact checks of
    fig_delta, fig_snapshot, fig10, fig13 and fig_peer and fig_serve's
    warm and dedup fields must hold (``_hold_tier_figures``), and the
    roofline's ``dominant`` must equal the dry run's (``_hold_tables``,
    which prints every table); B1 must launch once per delta save
    of fig_snapshot's device-dirty chains and B2's quantize mode once
    per leaf of beyond_quant's int8 save (B2 itself not at all); no
    figure may hold more on the disk at once than
    ``_disk_budget(disk_peak)``. The figures' verdicts are printed,
    never held. B1, B2 and its quantize mode are first held against
    their plain versions at the figures' shapes, and the scales of
    beyond_quant's int8 save against the plain ones. Returns (the
    phase's launches by kernel name, the largest error of those checks
    by kernel name)."""

    from repro_torch.benchmarks import run as bench
    from repro_torch.kernels import ckpt_pack as cp

    budget = _disk_budget(disk_peak)
    print(f"phase 14: the paper's figures (repro_torch.benchmarks, quick "
          f"sizes) on the card; disk budget {budget:.0f} B", flush=True)
    errs = _figure_kernels(device)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_figures_")
    cwd, env = os.getcwd(), os.environ.get("FASTPERSIST_BENCH_DIR")
    os.environ["FASTPERSIST_BENCH_DIR"] = os.path.join(tmp, "bench")
    os.chdir(tmp)
    held = {}
    results, seconds, failed = {}, {}, []
    try:
        dry = _figure_dry_runs()   # what roofline and the tables read
        _zero_counts()             # just before the figures
        for name, _module in bench.FIGURES:
            watch = _DiskPeak([tmp, PEER_ROOT])
            r, sec, bad = bench.run_all(quick=True, device=device,
                                        only=[name])
            held[name] = watch.stop()
            results.update(r)
            seconds.update(sec)
            failed += bad
        launches = {"ckpt_pack_dirty_blocks":
                    cp.ckpt_pack_dirty_blocks.launches,
                    "ckpt_pack_blocks": cp.ckpt_pack_blocks.launches,
                    "ckpt_quant_blocks": cp.ckpt_quant_blocks.launches}
        if not failed:
            _hold_tier_figures(results, times)
            _hold_tables(results, dry)
    finally:
        os.chdir(cwd)
        if env is None:
            os.environ.pop("FASTPERSIST_BENCH_DIR", None)
        else:
            os.environ["FASTPERSIST_BENCH_DIR"] = env
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  seconds per figure: "
          f"{json.dumps({k: round(v, 1) for k, v in seconds.items()})}",
          flush=True)
    print(f"  most held on the disk at once, bytes per figure: "
          f"{json.dumps(held)}", flush=True)
    times["figure s"] = {k: round(v, 1) for k, v in seconds.items()}
    times["figure disk bytes held"] = held
    if failed:
        fail(f"phase 14: figures {failed} raised")
    over = {k: v for k, v in held.items() if v > budget}
    if over:
        fail(f"phase 14: {over} held more than the disk budget "
             f"{budget:.0f} B")
    delta, snap = results["fig_delta"], results["fig_snapshot"]
    f10 = results["fig10_restore"]
    bad = [f"fig_delta kf{c['keyframe_every']} dirty{c['dirty_frac']}"
           for c in delta["cells"] if not (c["ok_full"] and c["ok_delta"])]
    bad += [f"fig_snapshot {c}" for c in snap["chunk_cells"]
            + snap["dirty_cells"] if not c["ok"]]
    bad += [] if f10["roundtrip_ok"] else ["fig10 restore"]
    if bad:
        fail(f"phase 14: restores not bit-exact: {bad}")
    print(f"  bit-exact: fig_delta's {2 * len(delta['cells'])} chain "
          f"restores, fig_snapshot's {len(snap['chunk_cells'])} stall and "
          f"{len(snap['dirty_cells'])} dirty cells, fig10's parallel "
          f"restore", flush=True)
    print(f"  verdicts (measurements, not held): fig_delta "
          f"{delta['verdict']} (best sparse bytes_x "
          f"{delta['best_sparse_bytes_x']}), fig_snapshot {snap['verdict']}"
          f" (stall_x {snap['default_chunk_stall_x']}, sparse pcie_x "
          f"{snap['sparse_pcie_x']}), fig10 4 readers vs 1 "
          f"{f10['speedup_4readers_vs_single']}x", flush=True)
    n_b1 = snap["steps"] * len(snap["dirty_cells"])
    n_b2q = len(results["beyond_quant"][True].device_scales)
    print(f"  launches in phase 14: {launches} (expected B1 {n_b1}: one "
          f"per delta save of fig_snapshot's device-dirty chains; B2's "
          f"quantize mode {n_b2q}: one per leaf of beyond_quant's int8 "
          f"save; B2 0)", flush=True)
    if launches["ckpt_pack_dirty_blocks"] != n_b1 or n_b1 < 1:
        fail(f"phase 14: ckpt_pack_dirty_blocks launched "
             f"{launches['ckpt_pack_dirty_blocks']} times; expected {n_b1}")
    if launches["ckpt_quant_blocks"] != n_b2q or n_b2q < 1 \
            or launches["ckpt_pack_blocks"]:
        fail(f"phase 14: ckpt_quant_blocks launched "
             f"{launches['ckpt_quant_blocks']} times and ckpt_pack_blocks "
             f"{launches['ckpt_pack_blocks']}; expected {n_b2q} and 0")
    _hold_quant_scales(results["beyond_quant"], device)
    return launches, errs


def sass_check():
    """Phase 2: the instructions of each flash_attention body in the SASS
    that ``cuobjdump`` reads from the built library. Fails unless every
    body does its products on the tensor cores (HMMA: bf16 in the bf16
    body and the two backward kernels, TF32 in the f32 one); the FFMA
    count is printed beside them
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
        kernel = re.search(r"(flash_tc_kernel|flash_tf32_kernel|"
                           r"flash_bwd_dq_kernel|flash_bwd_dkv_kernel)"
                           r"ILi(\d+)E", name)
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
    laps, t_lap = {}, [t_start]

    def lap(name):
        """Record the seconds since the last lap under ``name``."""
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now
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
    smem.update({f"flash_attention backward hd {hd}": fa.bwd_smem_bytes(hd)
                 for hd in fa.HEAD_DIMS})
    for hd, hdv in fa.MLA_DIMS:
        smem[f"flash_attention bf16 hd {hd} hd_v {hdv}"] = fa.smem_bytes(
            hd, torch.bfloat16, hdv)
        smem[f"flash_attention backward hd {hd} hd_v {hdv}"] = \
            fa.bwd_smem_bytes(hd, hdv)
    for shape in (SSD, SSD_ZAMBA2):
        smem[f"ssd_intra_chunk {shape} (C Bᵀ, per head)"] = \
            ssd_scan.smem_bytes(shape[2], shape[4], shape[5])
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
        if "zamba2" in e:
            print(f"  time {e['name']} at zamba2_2_7b's "
                  f"{e['zamba2']}", flush=True)
        if "internvl2" in e:
            print(f"  time {e['name']} at internvl2_26b's "
                  f"{e['internvl2']}", flush=True)
    entries.append(check_adam(device))
    torch.cuda.empty_cache()
    entries.append(check_attention_grad(device))
    torch.cuda.empty_cache()
    lap("1-3")
    launches, cfg, state, batch, extras, disk_peak = main_path(
        device, STEPS, BATCH, SEQ)
    lap("4-5")
    ms = {e["name"]: e["ms"] for e in entries}
    launches["flash_attention"] += score_restored(
        cfg, state, batch, ms["flash_attention"], entries[2]["f32_ms"])
    del batch
    torch.cuda.empty_cache()
    lap("6")
    n_quant, n_pack, quant_entry = quantized_save(cfg, state, extras, device)
    launches["ckpt_quant_blocks"] = n_quant
    launches["ckpt_pack_blocks"] += n_pack
    entries.append(quant_entry)
    del state
    torch.cuda.empty_cache()
    quantized_chain(cfg, device)
    torch.cuda.empty_cache()
    lap("7")
    times = {}
    launches["ssd_intra_chunk"] = run_ssm_model(
        "mamba2_370m", device, ms["ssd_intra_chunk"],
        _disk_budget(disk_peak), times, prefix="phase 8: ")
    print(f"phase 8 times: {json.dumps(times)}", flush=True)
    torch.cuda.empty_cache()
    lap("8")
    tiers(device, disk_peak)
    torch.cuda.empty_cache()
    lap("9")
    times = {}
    launches["flash_attention"] += paper_models(device, disk_peak, times)
    print(f"phase 10 times: {json.dumps(times)}", flush=True)
    torch.cuda.empty_cache()
    lap("10")
    times = {}
    launches["ssd_intra_chunk"] += decoder_families(
        device, disk_peak, entries[3]["zamba2_ms"], times)
    lap("11")
    print(f"phase 11 times: {json.dumps(times)}", flush=True)
    times = {}
    launches["flash_attention"] += frontend_families(
        device, disk_peak, entries[2]["internvl2_ms"], times)
    lap("12")
    print(f"phase 12 times: {json.dumps(times)}", flush=True)
    times = {}
    launches["flash_attention"] += expert_parallel(device, times)
    lap("13")
    print(f"phase 13 times: {json.dumps(times)}", flush=True)
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    times = {}
    figure_launches, figure_errs = paper_figures(device, disk_peak, times)
    for name, n in figure_launches.items():
        launches[name] += n
    for e in entries:
        if e["name"] in figure_errs:
            e["max_abs_err"] = max(e["max_abs_err"], figure_errs[e["name"]])
    lap("14")
    print(f"phase 14 times: {json.dumps(times)}", flush=True)
    for e in entries:
        e["launches"] = launches[e["name"]]
    print(f"seconds per phase: {json.dumps(laps)}", flush=True)
    print(f"every phase passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [
        {k: v for k, v in e.items()
         if k not in ("shape", "bytes", "bytes_per_head", "flops",
                      "graph_ms", "library_graph_ms", "zamba2",
                      "zamba2_ms", "internvl2", "internvl2_ms", "sampled",
                      "save_ms", "save_bytes")}
        for e in entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
