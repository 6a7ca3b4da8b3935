"""Dry run: every (architecture × input shape) on the production meshes,
counted on meta tensors, with the roofline terms of one device (the
counterpart of ``repro.launch.dryrun``; DESIGN.md §6–7).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch gemma2_9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --all [--multi-pod] [--out DIR]

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
    function of the specs and the model, not a count;
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


def _shard_bytes(t, spec, mesh) -> int:
    return (torch.Size(shard_shape(t.shape, spec, mesh)).numel()
            * t.element_size())


def argument_bytes(specs: dict, spec_tree: dict, mesh) -> int:
    """One device's bytes of the step's inputs: Σ over the leaves of the
    shard shape's elements × the leaf's item size."""
    return sum(_shard_bytes(t, s, mesh)
               for t, s in leaf_specs(specs, spec_tree))


def _tp_all_reduces(cfg) -> int:
    """All-reduces of the activations over ``model`` in one forward:
    Megatron's two per attention + MLP block (after the row-parallel
    ``wo``; a MoE layer's combine — moe_ep's one — stands for its MLP's,
    a dense residual adds one), one per SSM block (``out_proj``), three
    per encdec decoder block (self, cross, MLP)."""
    per_block = 2 + (1 if cfg.moe is not None and cfg.moe.dense_residual
                     else 0)
    if cfg.arch_type == "ssm":
        return cfg.n_layers
    if cfg.arch_type == "hybrid":
        n_groups = cfg.n_layers // cfg.attn_every
        return cfg.n_layers + 2 * n_groups
    if cfg.arch_type == "encdec":
        return 2 * cfg.n_enc_layers + 3 * cfg.n_layers
    return per_block * cfg.n_layers


def collective_bytes(cfg, shape, mesh, specs: dict, fsdp: bool = False):
    """Collective bytes per device of one step, by kind (each counted as
    its result's bytes, as the reference's HLO count does):

      * over ``model`` (|model| > 1): ``_tp_all_reduces`` all-reduces of
        the bf16 activations of one device's batch shard, per forward —
        three forwards in a remat train step (forward, recompute,
        backward's transposes), one in prefill and decode;
      * over ``data`` (|data| > 1, train only), ZeRO-1: every gradient
        (bf16, this device's TP shard) reduce-scattered to its
        ``zero1_specs`` shard where that spec adds ``data``, all-reduced
        where it does not; then the updated bf16 params all-gathered
        back. Under ``fsdp`` the bf16 params stay split over ``data``
        (ZeRO-3), so no all-gather follows the update; instead every
        split param is all-gathered where a remat train step uses it:
        in the forward, in the backward's recompute of that forward, and
        in the backward's products with the weight (dx = dy · Wᵀ) —
        three gathers of the param per step, the same three uses as the
        three forwards above. That is a model of ZeRO-3's schedule, not
        a count: a compiler that keeps a gathered weight live from the
        recompute to the backward gathers it twice.
    """
    m = mesh.shape["model"]
    dp = 1
    for a in dp_axes(mesh):
        dp *= mesh.shape[a]
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        S = 1
    b_loc = B // dp if B % dp == 0 and B > 1 else B
    out = {}
    if m > 1:
        act = b_loc * S * cfg.d_model * 2
        n_fwd = 3 if shape.kind == "train" else 1
        out["all-reduce"] = float(_tp_all_reduces(cfg) * act * n_fwd)
    if shape.kind == "train" and dp > 1:
        params = specs["state"].params
        rs = ar = ag = 0
        for (t, tp), (_, z1) in zip(
                leaf_specs(params, param_specs(params, mesh)),
                leaf_specs(params, zero1_specs(params, mesh))):
            if z1 != tp:
                rs += _shard_bytes(t, z1, mesh)
                ag += _shard_bytes(t, tp, mesh) * (3 if fsdp else 1)
            else:
                ar += _shard_bytes(t, tp, mesh)
        for kind, v in (("reduce-scatter", rs), ("all-reduce", ar),
                        ("all-gather", ag)):
            if v:
                out[kind] = out.get(kind, 0.0) + float(v)
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
    ap.add_argument("--out", default="experiments/dryrun")
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
