"""Dry run: every (architecture × input shape) on the production meshes,
counted on meta tensors, with the roofline terms of one device (the
counterpart of ``repro.launch.dryrun``; DESIGN.md §6–7).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch gemma2_9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --all [--multi-pod] [--out DIR]

``--out`` defaults to ``experiments/torch/dryrun``, where the port's
``roofline`` and ``make_tables`` read (the reference's tables read
``experiments/dryrun``, whose keys differ).

The step — the train step (remat, ``ce_chunk=512``, Adam), prefill, or
one decode step — runs ONCE on the global batch on ``device="meta"``:
nothing is allocated and nothing is computed, but every aten op it would
run is counted by ``launch/op_cost.py``. The terms of the result:

  * ``argument_size_bytes`` (under ``memory``): one device's share of
    the step's inputs, exact from the specs of ``sharding/specs.py``
    (``shard_shape`` of every leaf);
  * ``flops_per_device`` / ``bytes_per_device``: the GLOBAL count ÷
    ``n_chips`` (the per-device program is not partitioned here; the
    reference reads its per-device HLO instead); bytes are an eager,
    unfused upper bound (every intermediate written and read again);
  * ``collective_bytes_per_device``: ``collective_bytes`` below, a
    model of the program the specs shard (not a count), held within
    25 % of the reference's HLO count on a 2 x 4 mesh for one pair per
    family (tests/test_torch_dryrun_mesh.py); ``collectives_not_counted``
    names the kinds it leaves out, and why;
  * ``t_compute_s`` and ``t_collective_s`` at the H100 SXM data sheet's
    rates, ``model_flops_global`` and ``useful_flops_ratio`` as the
    reference computes them;
  * ``t_memory_upper_s``: the unfused bytes at the HBM rate, an UPPER
    bound on the step's memory term (the reference's ``t_memory_s``
    reads a fused program's bytes). It takes no part in ``dominant``,
    the larger of the compute and collective terms; ``memory_term``
    says so in the result itself;
  * ``count_s`` and ``n_ops``: the seconds and aten ops of the count
    (the reference's ``lower_s``).

The reference's XLA-only keys have no counterpart and are dropped:
``compile_s``, ``xla_flops_per_device_noloop`` and the memory analysis's
``output_size_bytes``, ``temp_size_bytes`` and
``generated_code_size_bytes``; so is the 512-host-device ``XLA_FLAGS``
the reference sets before importing jax.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import replace
from typing import NamedTuple

import torch

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, PAPER_ARCH_IDS,
                                 get_config, get_paper_config)
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import OpCost
from repro_torch.models.registry import build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.sharding.specs import (batch_specs, cache_specs, dp_axes,
                                        param_specs, shard_shape,
                                        zero1_specs)
from repro_torch.train.steps import make_train_step

#: NVIDIA H100 SXM data sheet (dense bf16 tensor cores, HBM3, NVLink per
#: direction); the card these terms describe is the one the port's chip
#: runs printed: NVIDIA H100 80GB HBM3, 700.00 W
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
#: what the result says of its memory term
MEMORY_TERM = ("t_memory_upper_s is an upper bound (eager, unfused "
               "bytes) and takes no part in dominant")
#: bytes an element of every collective ``collective_bytes`` counts: the
#: products take bf16 operands and accumulate in f32, and the partitioned
#: program reduces a split product's f32 partial sums (and gathers the
#: f32 master) before the cast to bf16, as the reference's HLO shows
ACC_BYTES = 4
#: the kinds the collective model leaves out, and why; the result says so
NOT_COUNTED = {
    "collective-permute": "XLA's halo exchange of a slice or split whose "
                          "bounds fall inside a shard (rope's halves of a "
                          "split head, the SSM's fused in_proj split)",
    "all-to-all": "XLA's re-layout of rope's halves of a head dim split "
                  "over model",
}


def _config(arch: str):
    key = arch.replace("-", "_").replace(".", "_")
    return get_paper_config(key) if key in PAPER_ARCH_IDS \
        else get_config(key)


def arg_specs(kind: str, specs: dict, mesh, batch_size: int,
              fsdp: bool = False) -> dict:
    """The spec tree of ``input_specs``' tree, as the reference's
    ``shardings_for``: train params by ``param_specs`` (``zero1_specs``
    under ``fsdp``: the bf16 working params split over ``data`` too),
    Adam master/m/v by ``zero1_specs``, the batch by ``batch_specs``;
    serving params by ``param_specs``, the cache by ``cache_specs``;
    the step, decode's tokens and ``pos`` replicated."""
    if kind == "train":
        state = specs["state"]
        opt = state.opt
        return {"state": type(state)(
            (zero1_specs if fsdp else param_specs)(state.params, mesh),
            type(opt)((), zero1_specs(opt.master, mesh),
                      zero1_specs(opt.m, mesh), zero1_specs(opt.v, mesh))),
            "batch": batch_specs(specs["batch"], mesh)}
    out = {"params": param_specs(specs["params"], mesh),
           "cache": cache_specs(specs["cache"], mesh, batch_size)}
    if kind == "prefill":
        out["batch"] = batch_specs(specs["batch"], mesh)
    else:
        out["tokens"], out["pos"] = (), ()
    return out


def leaf_specs(tree, spec_tree):
    """[(tensor, spec)] over ``tree``'s leaves, walking ``spec_tree``
    (which mirrors it, a spec tuple at each leaf) alongside."""
    if isinstance(tree, torch.Tensor):
        return [(tree, spec_tree)]
    if isinstance(tree, dict):
        return [x for k in tree for x in leaf_specs(tree[k], spec_tree[k])]
    return [x for t, s in zip(tree, spec_tree) for x in leaf_specs(t, s)]


def _shard_elems(t, spec, mesh) -> int:
    return torch.Size(shard_shape(t.shape, spec, mesh)).numel()


def _shard_bytes(t, spec, mesh) -> int:
    return _shard_elems(t, spec, mesh) * t.element_size()


def argument_bytes(specs: dict, spec_tree: dict, mesh) -> int:
    """One device's bytes of the step's inputs: Σ over the leaves of the
    shard shape's elements × the leaf's item size."""
    return sum(_shard_bytes(t, s, mesh)
               for t, s in leaf_specs(specs, spec_tree))


class _Blocks(NamedTuple):
    """``n`` blocks of one kind, as the model axis sees them: ``rows``
    row-parallel products whose f32 partial sums a forward all-reduces
    (``wo``, the MLP's down projection, the expert combine, the SSM's
    ``out_proj``); ``cols`` column-parallel products whose input gradient
    the backward all-reduces, each on its own (q, k, v, gate, up, the
    expert dispatch, the SSM's ``in_proj``; MLA's latent products count
    their latent's share of ``d_model``); ``remat`` when the block is
    recomputed in the backward; ``post_norm`` when a norm follows its
    last row-parallel product (gemma2); ``enc`` when it runs on the
    encoder's positions; ``attn`` when it attends over a K/V cache in
    serving; ``cross`` products reading the encoder output
    (their gradient reduced at the encoder's positions); ``kv_gather``
    when its K/V heads do not split over ``model`` (each device gathers
    whole heads); ``latent`` MLA's normalized latent width, gathered at
    each use; ``inner`` the SSM width whose gradient the backward
    gathers."""
    n: int
    rows: int
    cols: float
    remat: bool = False
    post_norm: bool = False
    enc: bool = False
    attn: bool = True
    cross: int = 0
    kv_gather: bool = False
    latent: int = 0
    inner: int = 0


def _tp_blocks(cfg, m: int, remat: bool) -> list:
    """The blocks of ``cfg`` on a ``model`` axis of size ``m``, under the
    port's specs (``sharding/specs.py``): heads, the MLP's hidden width,
    the SSM's fused projection and the experts (``E``) split over
    ``model``."""
    mlp_cols = 2 if cfg.gated_mlp else 1
    kv_gather = (cfg.attn_kind == "gqa"
                 and cfg.n_kv_heads % m != 0)
    if cfg.arch_type in ("ssm", "hybrid"):
        inner = cfg.ssm.expand * cfg.d_model
        out = [_Blocks(cfg.n_layers, 1, 1, attn=False, inner=inner)]
        if cfg.arch_type == "hybrid":
            out.append(_Blocks(cfg.n_layers // cfg.attn_every, 2,
                               3 + mlp_cols, kv_gather=kv_gather))
        return out
    if cfg.arch_type == "encdec":
        return [_Blocks(cfg.n_enc_layers, 2, 3 + mlp_cols, enc=True,
                        attn=False),
                _Blocks(cfg.n_layers, 3, 4 + mlp_cols, remat=remat,
                        cross=2, kv_gather=kv_gather)]
    rows, ffn_cols = 2, mlp_cols
    if cfg.moe is not None:
        ffn_cols = 1                      # the dispatch product
        if cfg.moe.dense_residual:
            rows, ffn_cols = 3, 1 + mlp_cols
    if cfg.attn_kind == "mla":
        la = cfg.mla
        latent = la.q_lora_rank + la.kv_lora_rank + la.qk_rope_head_dim
        return [_Blocks(cfg.n_layers, rows, 2 + latent / cfg.d_model
                        + ffn_cols, remat=remat, latent=latent)]
    return [_Blocks(cfg.n_layers, rows, 3 + ffn_cols, remat=remat,
                    post_norm=cfg.attn_softcap is not None,
                    kv_gather=kv_gather)]


def _add(out: dict, kind: str, nbytes) -> None:
    if nbytes:
        out[kind] = out.get(kind, 0.0) + float(nbytes)


def _on_model(spec) -> bool:
    """Whether a leaf's spec splits some dim over ``model``."""
    return any(e == "model" or (isinstance(e, tuple) and "model" in e)
               for e in spec)


def _split_weight_elems(params, mesh) -> int:
    """Elements of the layer weights that ``param_specs`` splits over
    ``model`` (the embedding and the unembedding left out)."""
    layers = {k: v for k, v in params.items()
              if k not in ("embed", "lm_head")}
    return sum(t.numel() for t, spec in leaf_specs(
        layers, param_specs(layers, mesh)) if _on_model(spec))


def _cache_seq_split(specs, mesh, batch_size) -> bool:
    """Whether ``cache_specs`` splits the attention cache's sequence over
    ``model`` (a cache at least ``128·|model|`` long)."""
    cache = specs["cache"]
    return any(_on_model(spec) for _, spec in leaf_specs(
        cache, cache_specs(cache, mesh, batch_size)))


def _model_axis_train(cfg, shape, b_loc, mesh, out) -> None:
    """The ``model`` axis's collectives of a train step (remat, chunked
    CE, the backward)."""
    m = mesh.shape["model"]
    d, hd = cfg.d_model, cfg.resolved_head_dim
    n_prefix = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    tok = b_loc * (shape.seq_len + n_prefix)
    tok_enc = b_loc * cfg.n_enc_ctx
    for blk in _tp_blocks(cfg, m, remat=True):
        t = tok_enc if blk.enc else tok
        act = t * d * ACC_BYTES
        re_rows = (blk.rows if blk.post_norm else blk.rows - 1) \
            if blk.remat else 0
        _add(out, "all-reduce",
             blk.n * act * (blk.rows + re_rows + blk.cols))
        _add(out, "all-reduce", blk.n * blk.cross * tok_enc * d
             * ACC_BYTES)
        passes = 2 if blk.remat else 1
        if blk.kv_gather:
            kv = t * max(cfg.n_kv_heads // m, 1) * hd * ACC_BYTES
            _add(out, "all-gather", blk.n * 2 * passes * kv)
            _add(out, "all-reduce", blk.n * 2 * kv)
        _add(out, "all-gather", blk.n * (passes + 1) * t * blk.latent
             * ACC_BYTES)
        _add(out, "all-gather", blk.n * t * blk.inner * ACC_BYTES)
    if cfg.vocab_size % m == 0:
        # the vocab-split embedding's lookup, the unembedding's input
        # gradient, and the chunked CE's max, sum and target logit
        _add(out, "all-reduce", b_loc * shape.seq_len * d * ACC_BYTES
             + tok * d * ACC_BYTES + 3 * b_loc * shape.seq_len
             * ACC_BYTES)


def _model_axis_serve(cfg, shape, b_loc, specs, mesh, out) -> None:
    """The ``model`` axis's collectives of a prefill or decode step."""
    m = mesh.shape["model"]
    d, hd, H = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads
    s_q = 1 if shape.kind == "decode" else shape.seq_len
    tok = b_loc * s_q
    act = tok * d * ACC_BYTES
    blocks = _tp_blocks(cfg, m, remat=False)
    attn = sum(b.n for b in blocks if b.attn)
    split = _cache_seq_split(specs, mesh, shape.global_batch)
    if split and attn:
        # attention over a cache whose sequence is split: the queries
        # gathered to every head, the partial outputs and the softmax's
        # max and sum reduced
        if cfg.attn_kind == "mla":
            q_w = H * (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)
            o_w = H * cfg.mla.v_head_dim
        else:
            q_w = o_w = H * hd
        _add(out, "all-gather", attn * tok * q_w * ACC_BYTES)
        _add(out, "all-reduce", attn * (tok * o_w + 2 * b_loc * H * s_q)
             * ACC_BYTES)
    reduce_ = sum(b.n * b.rows * (b_loc * cfg.n_enc_ctx * d * ACC_BYTES
                                  if b.enc else act) for b in blocks)
    gather = _split_weight_elems(specs["params"], mesh) * ACC_BYTES
    if reduce_ <= gather:
        _add(out, "all-reduce", reduce_)
        if split and attn and cfg.attn_kind != "mla":
            # the new keys and values, head-split, gathered to be written
            # into the sequence-split cache
            _add(out, "all-gather", attn * 2 * tok * cfg.n_kv_heads * hd
                 * ACC_BYTES)
    else:
        _add(out, "all-gather", gather)
    if cfg.vocab_size % m == 0:
        table = cfg.vocab_size * d * ACC_BYTES
        _add(out, "all-reduce" if act <= table else "all-gather",
             min(act, table))


def collective_bytes(cfg, shape, mesh, specs: dict, fsdp: bool = False):
    """Collective bytes per device of one step, by kind, each counted as
    its result's bytes at ``ACC_BYTES`` an element (as the reference's
    HLO count reads its partitioned program). A model of the program the
    port's specs shard, held against the reference's count on a 2 x 4
    mesh for one pair per family (tests/test_torch_dryrun_mesh.py):

      * over ``model`` (|model| > 1), train: per block (``_tp_blocks``)
        one all-reduce of the activations per row-parallel product in
        the forward, again in the recompute for each the backward needs
        (all but the last, unless a norm follows it), and one per
        column-parallel product's input gradient; a block whose K/V heads
        do not split gathers them (forward, recompute) and reduces their
        gradients; MLA gathers its normalized latents at each use, the
        SSM its inner-width gradient; per step, the vocab-split
        embedding's lookup, the unembedding's input gradient and the
        chunked CE's statistics. Prefill and decode: attention over a
        sequence-split cache gathers the queries and reduces the partial
        outputs and the softmax statistics; each row-parallel product
        all-reduces its output unless gathering the split weights moves
        fewer bytes (a long prompt), and where the weights stay split
        the new keys and values are gathered into the cache;
      * over ``data`` (|data| > 1, train only), ZeRO-1: every gradient
        (this device's TP shard) reduce-scattered to its ``zero1_specs``
        shard where that spec adds ``data``, all-reduced where it does
        not; then the updated params all-gathered back. Under ``fsdp``
        the params stay split over ``data`` (ZeRO-3), so no all-gather
        follows the update; instead every split param is all-gathered
        where a remat train step uses it: in the forward, in the
        backward's recompute of that forward, and in the backward's
        products with the weight (dx = dy · Wᵀ) — three gathers of the
        param per step. That is a model of ZeRO-3's schedule, not a
        count: a compiler that keeps a gathered weight live from the
        recompute to the backward gathers it twice.

    Not counted (``NOT_COUNTED``): the collective-permutes and
    all-to-alls with which XLA's partitioner moves the halves of a split
    that falls inside a shard (rope's halves of a split head, the SSM's
    fused z|x|B|C|dt projection).
    """
    m = mesh.shape["model"]
    dp = 1
    for a in dp_axes(mesh):
        dp *= mesh.shape[a]
    B = shape.global_batch
    b_loc = B // dp if B % dp == 0 and B > 1 else B
    out = {}
    if m > 1:
        if shape.kind == "train":
            _model_axis_train(cfg, shape, b_loc, mesh, out)
        else:
            _model_axis_serve(cfg, shape, b_loc, specs, mesh, out)
    if shape.kind == "train" and dp > 1:
        params = specs["state"].params
        rs = ar = ag = 0
        for (t, tp), (_, z1) in zip(
                leaf_specs(params, param_specs(params, mesh)),
                leaf_specs(params, zero1_specs(params, mesh))):
            if z1 != tp:
                rs += _shard_elems(t, z1, mesh)
                ag += _shard_elems(t, tp, mesh) * (3 if fsdp else 1)
            else:
                ar += _shard_elems(t, tp, mesh)
        for kind, v in (("reduce-scatter", rs), ("all-reduce", ar),
                        ("all-gather", ag)):
            _add(out, kind, v * ACC_BYTES)
    return out


def _run_step(kind, model, specs, shape):
    """The step on the meta stand-ins."""
    if kind == "train":
        step = make_train_step(model, AdamConfig())
        step(specs["state"], specs["batch"])
    elif kind == "prefill":
        model.prefill(specs["params"], specs["batch"], specs["cache"])
    else:
        # the position only moves the mask; the step attends the whole
        # cache either way
        pos = shape.seq_len - 1
        model.decode(specs["params"], specs["tokens"], specs["cache"], pos)


def lower_one(arch: str, shape_name: str, multi_pod: bool = False,
              verbose: bool = True, extra_cfg=None,
              shard_map_moe: bool = False, fsdp: bool = False) -> dict:
    """Count one (arch, shape) pair's step on meta tensors; returns the
    result dict (see the module docstring)."""
    cfg = _config(arch)
    if extra_cfg:
        cfg = replace(cfg, **extra_cfg)
    shape = INPUT_SHAPES[shape_name]
    if shape_name in cfg.skip_shapes:
        return {"arch": arch, "shape": shape_name, "skipped": True}

    mesh = make_production_mesh(multi_pod=multi_pod)
    dp_total = 1
    for a in dp_axes(mesh):
        dp_total *= mesh.shape[a]
    n_chips = mesh.size

    # remat + chunked CE are the standard production baseline for training
    moe_groups = cfg.moe_groups_override or min(dp_total, shape.global_batch)
    model = build_model(cfg, moe_groups=moe_groups,
                        remat=(shape.kind == "train"),
                        ce_chunk=512 if shape.kind == "train" else None,
                        mesh=mesh if shard_map_moe else None)
    specs = input_specs(cfg, shape, model)
    arg_bytes = argument_bytes(
        specs, arg_specs(shape.kind, specs, mesh, shape.global_batch, fsdp),
        mesh)
    coll = collective_bytes(cfg, shape, mesh, specs, fsdp)
    t0 = time.perf_counter()
    with OpCost() as counter:
        _run_step(shape.kind, model, specs, shape)
    t_count = time.perf_counter() - t0
    agg = counter.aggregate()
    flops = agg["flops"] / n_chips
    bytes_acc = agg["bytes"] / n_chips
    coll_total = sum(coll.values())

    model_flops_global = (
        6 * cfg.active_param_count() * shape.global_batch * shape.seq_len
        if shape.kind == "train"
        else 2 * cfg.active_param_count() * shape.global_batch
        * (shape.seq_len if shape.kind == "prefill" else 1))

    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "kind": shape.kind,
        "shard_map_moe": shard_map_moe, "fsdp": fsdp,
        "count_s": round(t_count, 2),
        "n_ops": agg["n_ops"],
        "flops_global": agg["flops"],
        "bytes_global": agg["bytes"],
        "per_device": "global count / n_chips",
        "flops_per_device": flops,
        "bytes_per_device": bytes_acc,
        "collective_bytes_per_device": coll,
        "collective_total_per_device": coll_total,
        "memory": {"argument_size_bytes": arg_bytes},
        "card": CARD,
        "t_compute_s": flops / PEAK_FLOPS,
        "t_memory_upper_s": bytes_acc / HBM_BW,
        "t_collective_s": coll_total / LINK_BW,
        "model_flops_global": model_flops_global,
        "useful_flops_ratio": model_flops_global / max(agg["flops"], 1.0),
        "memory_term": MEMORY_TERM,
        "collectives_not_counted": NOT_COUNTED,
    }
    terms = {"compute": result["t_compute_s"],
             "collective": result["t_collective_s"]}
    result["dominant"] = max(terms, key=terms.get)
    if verbose:
        print(json.dumps(result, indent=2))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    # beside the port's figure JSON (benchmarks/common.py's EXPERIMENTS),
    # apart from the reference's experiments/dryrun, whose keys differ
    ap.add_argument("--out", default=os.path.join("experiments", "torch",
                                                  "dryrun"))
    args = ap.parse_args(argv)

    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    results = []
    for a, s in pairs:
        tag = "multipod" if args.multi_pod else "pod"
        try:
            r = lower_one(a, s, multi_pod=args.multi_pod)
        except Exception as e:      # one pair's failure is its file's entry
            r = {"arch": a, "shape": s, "error": repr(e)[:500]}
            print(f"FAILED {a} {s}: {e}")
        results.append(r)
        with open(os.path.join(args.out, f"{a}__{s}__{tag}.json"), "w") as f:
            json.dump(r, f, indent=2)
    ok = sum(1 for r in results if "error" not in r)
    print(f"\n{ok}/{len(results)} pairs counted")
    return results


if __name__ == "__main__":
    main()
