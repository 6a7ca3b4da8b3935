"""The port's dry-run tooling against the reference's:
``launch/op_cost.py`` against ``repro.launch.hlo_cost`` (the five
programs of tests/test_hlo_cost.py, then one reduced config per family:
its train (remat), prefill and decode steps); ``build_model(remat=)``;
``launch/inputs.py``; and ``launch/dryrun.py``'s CLI. The sweep over
every (arch × shape) pair is in tests/test_torch_dryrun_sweep.py."""
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS, INPUT_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import ShapeConfig as RefShape
from repro.launch.hlo_cost import aggregate as hlo_aggregate
from repro.launch.inputs import input_specs as ref_inputs
from repro.models.registry import build_model as ref_build
from repro.optim.adam import AdamConfig as RefAdam
from repro.train.steps import make_train_step as ref_train_step
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.op_cost import OpCost, aggregate
from repro_torch.models.registry import build_model
from repro_torch.tree import leaves as tree_leaves

META = torch.device("meta")


def _compile(f, *args):
    return jax.jit(f).lower(*args).compile().as_text()


def _m(*shape):
    return torch.empty(shape, device=META)


def _loop(ws, x):
    for w in ws:
        x = x @ w
    return x


def _nested(ws, x):
    for group in ws:
        x = _loop(group, x)
    return x


def _jax_loop(ws, x):
    y, _ = jax.lax.scan(lambda c, w: (c @ w, None), x, ws)
    return y


def _jax_nested(ws, x):
    y, _ = jax.lax.scan(lambda c, wg: (_jax_loop(wg, c), None), x, ws)
    return y


#: the five programs of tests/test_hlo_cost.py: (torch fn, jax fn, input
#: shapes, the bytes the program must move: each input read once, the
#: output written once)
PROGRAMS = {
    "matmul": (lambda a, b: a @ b, lambda a, b: a @ b,
               [(128, 256), (256, 512)], (128 * 256 + 256 * 512
                                          + 128 * 512) * 4),
    "loop": (_loop, _jax_loop, [(8, 64, 64), (32, 64)],
             (8 * 64 * 64 + 2 * 32 * 64) * 4),
    "nested_loop": (_nested, _jax_nested, [(3, 4, 64, 64), (16, 64)],
                    (12 * 64 * 64 + 2 * 16 * 64) * 4),
    "batched_einsum": (lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                       lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                       [(4, 32, 64), (4, 64, 16)],
                       (4 * 32 * 64 + 4 * 64 * 16 + 4 * 32 * 16) * 4),
    "add": (lambda a: a + 1.0, lambda a: a + 1.0, [(1024, 1024)],
            2 * 1024 * 1024 * 4),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_op_cost_matches_hlo_cost_on_its_programs(name):
    """flops within 1 % of the reference's trip-count-aware HLO count;
    bytes at least what the program must move (inputs read once, output
    written once) and at most twice it: the eager count adds each loop
    step's intermediate once (the reference bounds its own count of
    ``a + 1`` by 0.9× and 3× that)."""
    fn, jfn, shapes, must = PROGRAMS[name]
    got = aggregate(fn, *[_m(*s) for s in shapes])
    want = hlo_aggregate(_compile(jfn, *[jax.ShapeDtypeStruct(s, jnp.float32)
                                         for s in shapes]))
    assert got["flops"] == pytest.approx(want["flops"], rel=0.01, abs=0)
    assert must <= got["bytes"] <= 2 * must
    assert got["collectives"] == {}


def test_op_cost_counts_the_backward_and_skips_views():
    a = torch.randn(32, 64, requires_grad=True)
    b = torch.randn(64, 16, requires_grad=True)
    with OpCost() as c:
        y = (a @ b).t().contiguous()
        y.sum().backward()
    # forward mm + two backward mms, each 2·32·64·16
    assert c.aggregate()["flops"] == 3 * 2 * 32 * 64 * 16
    with OpCost() as v:
        a.detach().view(64, 32).t()[3:9]
    assert v.aggregate()["bytes"] == 0


#: one reduced config per family, and the batch of its steps
FAMILIES = {"dense": "stablelm_1_6b", "moe": "qwen3_moe_235b",
            "ssm": "mamba2_370m", "hybrid": "zamba2_2_7b",
            "vlm": "internvl2_26b", "encdec": "whisper_small"}
B, S = 2, 32


def _ref_step_hlo(arch, kind):
    cfg = ref_reduced(ref_config(arch))
    model = ref_build(cfg, remat=kind == "train",
                      ce_chunk=512 if kind == "train" else None)
    sp = ref_inputs(cfg, RefShape("t", S, B, kind), model)
    if kind == "train":
        return _compile(ref_train_step(model, RefAdam()), sp["state"],
                        sp["batch"])
    if kind == "prefill":
        return _compile(model.prefill, sp["params"], sp["batch"],
                        sp["cache"])
    return _compile(model.decode, sp["params"], sp["tokens"], sp["cache"],
                    sp["pos"])


def _port_step(arch, kind):
    cfg = reduced(get_config(arch))
    model = build_model(cfg, remat=kind == "train",
                        ce_chunk=512 if kind == "train" else None)
    shape = ShapeConfig("t", S, B, kind)
    specs = input_specs(cfg, shape, model)
    with OpCost() as c:
        dryrun._run_step(kind, model, specs, shape)
    return cfg, c.aggregate()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_step_flops_match_hlo_cost(family, kind):
    """The step's counted flops within 2 % of the reference's HLO count
    on one CPU device. The transformer families' prefill: the reference
    unembeds every prompt position and keeps the last (its
    transformer.py:353-355), the port only the last; that product,
    2·B·(P−1)·d·V over the P positions (vision prefix included), is
    added to the port's count before the comparison (ROADMAP C.24)."""
    arch = FAMILIES[family]
    cfg, got = _port_step(arch, kind)
    want = hlo_aggregate(_ref_step_hlo(arch, kind))
    flops = got["flops"]
    if kind == "prefill" and family in ("dense", "moe", "vlm"):
        positions = S + (cfg.n_frontend_tokens if family == "vlm" else 0)
        flops += 2 * B * (positions - 1) * cfg.d_model * cfg.vocab_size
    assert flops == pytest.approx(want["flops"], rel=0.02, abs=0)


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "qwen3_moe_235b",
                                  "whisper_small"])
def test_remat_is_bit_equal(arch):
    """The loss and every gradient are the same bits with and without
    ``remat`` (the recomputed forward repeats the same operations)."""
    from repro_torch.models.registry import make_batch
    cfg = reduced(get_config(arch))
    out = []
    for remat in (False, True):
        model = build_model(cfg, dtype=torch.float32, remat=remat)
        params = model.init(0, "cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = model.loss(params, make_batch(cfg, 2, 16, device="cpu",
                                             dtype=torch.float32))
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _named(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join("." + k.name if isinstance(k, jax.tree_util.GetAttrKey)
                        else str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[name] = leaf
    return out


def _port_named(tree, path=()):
    if isinstance(tree, torch.Tensor):
        return {"/".join(path): tree}
    out = {}
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif hasattr(tree, "_fields"):
        items = [("." + f, getattr(tree, f)) for f in tree._fields]
    else:
        items = [(str(i), v) for i, v in enumerate(tree)]
    for k, v in items:
        out.update(_port_named(v, path + (k,)))
    return out


_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
           torch.int32: "int32"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    """``input_specs`` at full size, every shape: the reference's tree,
    leaf for leaf in shape and dtype, all on meta."""
    rcfg, pcfg = ref_config(arch), get_config(arch)
    rmodel, pmodel = ref_build(rcfg), build_model(pcfg)
    for name, shape in INPUT_SHAPES.items():
        want = _named(ref_inputs(rcfg, shape, rmodel))
        got = _port_named(input_specs(pcfg, shape, pmodel))
        assert got.keys() == want.keys(), name
        for k, t in got.items():
            assert t.device == META
            assert (tuple(t.shape), _DTYPES[t.dtype]) == \
                (tuple(want[k].shape), str(want[k].dtype)), (name, k)


def test_lower_one_moe_ep_and_cli(tmp_path, capsys):
    """gpt3_1_8b_moe's train step on the 16 x 16 mesh with and without
    ``shard_map_moe``: the same arguments and collectives, the einsum
    dispatch's O(T·E·C·D) flops gone under EP; the terms at the H100's
    rates. Then the CLI writes one JSON file per pair."""
    base = dryrun.lower_one("gpt3_1_8b_moe", "train_4k", verbose=False)
    ep = dryrun.lower_one("gpt3_1_8b_moe", "train_4k", verbose=False,
                          shard_map_moe=True)
    assert base["memory"] == ep["memory"]
    assert base["collective_bytes_per_device"] == \
        ep["collective_bytes_per_device"]
    assert ep["flops_per_device"] < base["flops_per_device"] / 4
    assert base["model_flops_global"] == ep["model_flops_global"]
    for r in (base, ep):
        assert r["n_chips"] == 256 and r["card"] == dryrun.CARD
        assert r["t_compute_s"] == r["flops_per_device"] / 989e12
        assert r["t_memory_upper_s"] == r["bytes_per_device"] / 3.35e12
        assert "t_memory_s" not in r and r["memory_term"] == \
            dryrun.MEMORY_TERM
        terms = {"compute": r["t_compute_s"],
                 "collective": r["t_collective_s"]}
        assert r["dominant"] == max(terms, key=terms.get)
    out = tmp_path / "dry"
    res = dryrun.main(["--arch", "stablelm_1_6b", "--shape", "decode_32k",
                       "--out", str(out)])
    assert "1/1 pairs counted" in capsys.readouterr().out
    on_disk = json.loads((out / "stablelm_1_6b__decode_32k__pod.json")
                         .read_text())
    assert on_disk == json.loads(json.dumps(res[0]))
    assert on_disk["kind"] == "decode" and on_disk["flops_per_device"] > 0


def test_tp_and_zero1_collectives():
    """``collective_bytes`` on stablelm_1_6b's train step, each element
    at 4 bytes (f32 partial sums and master). On 1 x 16 (model only):
    per layer, the forward's all-reduce after ``wo`` and after the MLP's
    down projection, the recompute's one after ``wo`` (the backward
    needs no more), and one per column-parallel product's input gradient
    (q, k, v, gate, up): 8 activations; per step, the vocab-split
    embedding's lookup and the unembedding's input gradient, plus the
    chunked CE's three per-token scalars. On 16 x 1 (data only), ZeRO-1:
    each gradient either reduce-scattered to a 16th (and the param
    all-gathered back whole) or all-reduced whole, so the reduce-scatter
    is a 16th of the all-gather and the two kinds cover the params once
    (at 4 bytes an element)."""
    from repro_torch.launch.mesh import make_mesh
    cfg = get_config("stablelm_1_6b")
    shape = INPUT_SHAPES["train_4k"]
    specs = input_specs(cfg, shape, build_model(cfg))
    tp = dryrun.collective_bytes(cfg, shape, make_mesh(
        (1, 16), ("data", "model")), specs)
    tokens = 256 * 4096
    act = tokens * cfg.d_model * 4
    assert tp == {"all-reduce": (8 * cfg.n_layers + 2) * act
                  + 3 * tokens * 4}
    dp = dryrun.collective_bytes(cfg, shape, make_mesh(
        (16, 1), ("data", "model")), specs)
    total = sum(t.numel() * 4 for t in
                tree_leaves(specs["state"].params))
    assert dp["all-gather"] == 16 * dp["reduce-scatter"]
    assert dp["all-gather"] + dp.get("all-reduce", 0) == total


def test_fsdp_collectives():
    """``collective_bytes`` under ``fsdp`` on stablelm_1_6b's train step
    on 16 x 1 (data only): the reduce-scatter and all-reduce of the
    gradients as without it, and each split param all-gathered at its
    three uses (forward, recompute, backward) instead of once after the
    update; on 1 x 16 (model only) fsdp changes nothing."""
    from repro_torch.launch.mesh import make_mesh
    cfg = get_config("stablelm_1_6b")
    shape = INPUT_SHAPES["train_4k"]
    specs = input_specs(cfg, shape, build_model(cfg))
    dp_mesh = make_mesh((16, 1), ("data", "model"))
    zero1 = dryrun.collective_bytes(cfg, shape, dp_mesh, specs)
    fsdp = dryrun.collective_bytes(cfg, shape, dp_mesh, specs, fsdp=True)
    assert fsdp["all-gather"] == 3 * zero1["all-gather"]
    assert fsdp["reduce-scatter"] == zero1["reduce-scatter"]
    assert fsdp.get("all-reduce") == zero1.get("all-reduce")
    tp_mesh = make_mesh((1, 16), ("data", "model"))
    assert dryrun.collective_bytes(cfg, shape, tp_mesh, specs, fsdp=True) \
        == dryrun.collective_bytes(cfg, shape, tp_mesh, specs)


def test_op_cost_by_op_is_the_same_on_cpu_and_meta():
    """One forward of a reduced gpt3_1_8b_moe (einsum dispatch) counted on
    CPU tensors and on meta tensors: the same flops, and the same bytes
    op by op (``by_op`` sums to ``bytes``)."""
    from repro_torch.configs import get_paper_config
    from repro_torch.models.registry import make_batch
    from repro_torch.tree import tree_map
    cfg = reduced(get_paper_config("gpt3_1_8b_moe"))
    model = build_model(cfg)
    params = tree_map(lambda t: t.to(torch.bfloat16), model.init(0, "cpu"))
    batch = make_batch(cfg, 2, 32, seed=13, device="cpu")
    counts = []
    for p, b in ((params, batch),
                 (tree_map(lambda t: torch.empty_like(t, device="meta"),
                           params),
                  {k: torch.empty_like(v, device="meta")
                   for k, v in batch.items()})):
        with torch.inference_mode(), OpCost() as c:
            model.forward(p, b)
        assert sum(c.by_op.values()) == c.bytes > 0
        counts.append(c)
    cpu, meta = counts
    assert cpu.flops == meta.flops > 0
    assert cpu.by_op == meta.by_op
