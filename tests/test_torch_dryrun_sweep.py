"""The dry-run sweep (``repro_torch.launch.dryrun.lower_one``) over every
(arch × input shape) pair the reference's ``--all`` sweeps, on the
16 x 16 production mesh: each pair completes on meta tensors and its
per-device argument bytes equal the sum over the reference's own input
stand-ins and specs (``jax.eval_shape`` trees, an ``AbstractMesh``, each
leaf's ``NamedSharding.shard_shape``).

The whole sweep is about 80 s of Python on one CPU core, so one pair
per family runs unmarked (on both production meshes) and the rest are
marked ``slow``. Under ``fsdp`` one train pair per family is held
against the argument bytes of the reference's own ``shardings_for``."""
import os

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro.launch.inputs import input_specs as ref_inputs
from repro.models.registry import build_model as ref_build
from repro.sharding import specs as rs
from repro_torch.launch.dryrun import lower_one

#: one (arch, shape) pair per family, unmarked
FAMILY_PAIRS = {("stablelm_1_6b", "train_4k"), ("qwen3_moe_235b",
                                                "decode_32k"),
                ("mamba2_370m", "prefill_32k"), ("zamba2_2_7b", "long_500k"),
                ("internvl2_26b", "prefill_32k"),
                ("whisper_small", "train_4k")}


def _ref_argument_bytes(arch, shape_name, multi_pod):
    """Σ over the reference's step inputs of one device's shard bytes,
    with the specs its ``shardings_for`` gives them (fsdp off)."""
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    mesh = AbstractMesh((2, 16, 16) if multi_pod else (16, 16),
                        ("pod", "data", "model") if multi_pod
                        else ("data", "model"))
    sp = ref_inputs(cfg, shape, ref_build(cfg))
    if shape.kind == "train":
        st = sp["state"]
        trees = [(st.params, rs.param_specs(st.params, mesh))] + [
            (t, rs.zero1_specs(t, mesh)) for t in (st.opt.master, st.opt.m,
                                                   st.opt.v)] + [
            (st.opt.step, P()), (sp["batch"], rs.batch_specs(sp["batch"],
                                                            mesh))]
    else:
        trees = [(sp["params"], rs.param_specs(sp["params"], mesh)),
                 (sp["cache"], rs.cache_specs(sp["cache"], mesh,
                                              shape.global_batch))]
        if shape.kind == "prefill":
            trees.append((sp["batch"], rs.batch_specs(sp["batch"], mesh)))
        else:
            trees += [(sp["tokens"], P()), (sp["pos"], P())]
    total = 0
    for tree, specs in trees:
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(specs,
                                      is_leaf=lambda x: isinstance(x, P))
        assert len(leaves) == len(spec_leaves)
        for leaf, spec in zip(leaves, spec_leaves):
            local = NamedSharding(mesh, spec).shard_shape(leaf.shape)
            total += int(np.prod(local, dtype=np.int64)) * \
                leaf.dtype.itemsize
    return total


def _reference_shardings_for():
    """The reference's ``repro.launch.dryrun.shardings_for``. That module
    sets a 512-device ``XLA_FLAGS`` when it is imported; the variable is
    put back at once, before any backend of this process reads it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import shardings_for
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return shardings_for


def _ref_fsdp_argument_bytes(arch, shape_name, multi_pod):
    """Σ over the reference's train-step inputs of one device's shard
    bytes, with the shardings its ``shardings_for(..., fsdp=True)``
    gives them."""
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    mesh = AbstractMesh((2, 16, 16) if multi_pod else (16, 16),
                        ("pod", "data", "model") if multi_pod
                        else ("data", "model"))
    sp = ref_inputs(cfg, shape, ref_build(cfg))
    shardings = _reference_shardings_for()(shape.kind, sp, cfg, mesh,
                                           shape.global_batch, fsdp=True)
    leaves = jax.tree.leaves((sp["state"], sp["batch"]))
    sh_leaves = jax.tree.leaves(shardings)
    assert len(leaves) == len(sh_leaves)
    return sum(int(np.prod(sh.shard_shape(leaf.shape), dtype=np.int64))
               * leaf.dtype.itemsize for leaf, sh in zip(leaves, sh_leaves))


def _pairs():
    out = []
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            marks = () if (arch, shape) in FAMILY_PAIRS else (
                pytest.mark.slow,)
            out.append(pytest.param(arch, shape, marks=marks,
                                    id=f"{arch}-{shape}"))
    return out


def _check(arch, shape_name, multi_pod):
    r = lower_one(arch, shape_name, multi_pod=multi_pod, verbose=False)
    if shape_name in get_config(arch).skip_shapes:
        assert r == {"arch": arch, "shape": shape_name, "skipped": True}
        return
    assert "error" not in r
    assert r["memory"]["argument_size_bytes"] == \
        _ref_argument_bytes(arch, shape_name, multi_pod)
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert 0 < r["useful_flops_ratio"] <= 1.0
    assert r["flops_per_device"] * r["n_chips"] == r["flops_global"]


@pytest.mark.parametrize("arch,shape_name", _pairs())
def test_lower_one_on_the_pod_mesh(arch, shape_name):
    _check(arch, shape_name, multi_pod=False)


@pytest.mark.parametrize("arch,shape_name", sorted(FAMILY_PAIRS))
def test_lower_one_on_the_multi_pod_mesh(arch, shape_name):
    _check(arch, shape_name, multi_pod=True)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", ["stablelm_1_6b", "qwen3_moe_235b",
                                  "mamba2_370m", "zamba2_2_7b",
                                  "internvl2_26b", "whisper_small"])
def test_lower_one_fsdp_argument_bytes(arch, multi_pod):
    """``fsdp=True`` splits the bf16 working params over ``data`` too:
    the per-device argument bytes of each family's train step equal the
    reference's ``shardings_for(..., fsdp=True)``, and are fewer than
    without it."""
    r = lower_one(arch, "train_4k", multi_pod=multi_pod, verbose=False,
                  fsdp=True)
    assert r["fsdp"] is True
    assert r["memory"]["argument_size_bytes"] == \
        _ref_fsdp_argument_bytes(arch, "train_4k", multi_pod)
    plain = lower_one(arch, "train_4k", multi_pod=multi_pod, verbose=False)
    assert r["memory"]["argument_size_bytes"] < \
        plain["memory"]["argument_size_bytes"]
    assert r["flops_global"] == plain["flops_global"]
