"""Expert parallelism across processes (``repro_torch.sharding.moe_ep``)
on the CPU: ``gloo`` ranks started by ``launch.mesh.run_ranks`` (each
world on a free port, with its own timeout, so a hung rendezvous fails)
on the meshes 1 x 2, 2 x 2 and 1 x 4 (data x model).

* Against the reference: the EP layer on reduced qwen3_moe_235b and
  reduced arctic_480b (dense residual), in f32 at the configs' own
  capacity factor (tokens dropped), against the reference's
  ``make_shard_map_moe`` run in a subprocess on 8 forced host devices at
  the same mesh shape, on the same seeded numpy inputs.
* Against a single process: the layer's output against the port's
  ``moe_apply_sorted`` with one router group per data shard (the same
  capacity and drop policy), and the gradients of x, the router and the
  expert slices.
* Model level: ``build_model(mesh=...)`` on each rank's data shard with
  its ``local_params``, against the single-process einsum forward at
  ``capacity_factor = n_experts`` (no drops). The reference's own
  model-level EP test fails on this jax (ROADMAP C.1), so it is not the
  oracle there.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import layers as ly

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3_moe_235b", "arctic_480b")
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
B, L = 4, 16
TIMEOUT = 180


def _cfg(arch, no_drops=False):
    cfg = reduced(get_config(arch))
    if no_drops:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    return cfg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *head, leaf = k.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[leaf] = v
    return out


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    """One MoE layer's f32 params (normal, scaled by 1/sqrt(fan-in) as
    the models' init scales them) and x (B, L, d) from seeded numpy."""
    cfg = _cfg(arch)
    shapes = _flat(ly.moe_init(cfg, None, torch.device("meta")))
    rng = np.random.default_rng(7)
    params = {k: (rng.standard_normal(tuple(v.shape))
                  / np.sqrt(v.shape[-2])).astype(np.float32)
              for k, v in shapes.items()}
    x = rng.standard_normal((B, L, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, L, cfg.d_model)).astype(np.float32)
    return params, x, w


@pytest.fixture(scope="module")
def data_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_ep") / "inputs.npz"
    arrays = {}
    for arch in ARCHS:
        params, x, w = _inputs(arch)
        arrays.update({f"{arch}/p/{k}": v for k, v in params.items()})
        arrays[f"{arch}/x"], arrays[f"{arch}/w"] = x, w
    np.savez(path, **arrays)
    return path


_REF_SCRIPT = r"""
import os, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.sharding.moe_ep import make_shard_map_moe
data = np.load(sys.argv[1])
out = {}
for arch in %(archs)r:
    cfg = reduced(get_config(arch))
    p = {}
    for k in data.files:
        if k.startswith(arch + '/p/'):
            *head, leaf = k[len(arch) + 3:].split('/')
            d = p
            for h in head:
                d = d.setdefault(h, {})
            d[leaf] = jnp.asarray(data[k])
    x = jnp.asarray(data[arch + '/x'])
    for name, shape in %(meshes)r.items():
        n = shape[0] * shape[1]
        mesh = jax.make_mesh(shape, ('data', 'model'),
                             devices=jax.devices()[:n])
        kern = make_shard_map_moe(mesh)
        o, aux = jax.jit(lambda p, x: kern(p, x, cfg))(p, x)
        out[f'{arch}/{name}/out'] = np.asarray(o)
        out[f'{arch}/{name}/aux'] = np.asarray(aux)
np.savez(sys.argv[2], **out)
print('REF-OK')
"""


@pytest.fixture(scope="module")
def reference(data_file):
    """The reference's shard_map layer on every mesh, in a subprocess
    (JAX fixes its device count when it starts)."""
    out = data_file.parent / "reference.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    script = _REF_SCRIPT % {"archs": ARCHS, "meshes": MESHES}
    r = subprocess.run([sys.executable, "-c", script, str(data_file),
                        str(out)], env=env, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0 and "REF-OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(out))


def _rank(rank, shape, path):
    """One rank: the EP layer (value and gradients of Σ out·w over its
    data shard) for each arch, then the reduced model's EP forward at
    capacity_factor = n_experts. Returns numpy arrays."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.moe_ep import (EXPERT_SPEC, local_params,
                                             make_moe_ep)
    from repro_torch.sharding.specs import local_slice
    data = np.load(path)
    mesh = init_process_mesh(shape, ("data", "model"), backend="gloo",
                             device="cpu")
    d, b_loc = mesh.coords["data"], B // shape[0]
    rows = slice(d * b_loc, (d + 1) * b_loc)
    res = {"coords": mesh.coords}
    for arch in ARCHS:
        cfg = _cfg(arch)
        flat = {k[len(arch) + 3:]: torch.from_numpy(data[k])
                for k in data.files if k.startswith(arch + "/p/")}
        flat = {k: (local_slice(v, EXPERT_SPEC, mesh).clone()
                    if k in ("wi", "wg", "wo") else v).requires_grad_(True)
                for k, v in flat.items()}
        x = torch.from_numpy(data[arch + "/x"][rows]).requires_grad_(True)
        w = torch.from_numpy(data[arch + "/w"][rows])
        out, aux = make_moe_ep(mesh)(_nest(flat), x, cfg)
        (out * w).sum().backward()
        res[arch] = {"out": out.detach().numpy(), "aux": float(aux.detach()),
                     "grad_x": x.grad.numpy(),
                     **{f"grad_{k}": v.grad.numpy() for k, v in flat.items()}}

        mcfg = _cfg(arch, no_drops=True)
        model = build_model(mcfg, dtype=torch.float32, mesh=mesh)
        full = model.init(3, "cpu")
        params = local_params(full, mesh)
        del full
        tokens = torch.from_numpy(
            np.random.default_rng(11).integers(0, mcfg.vocab_size, (B, L))
            .astype(np.int64)[rows])
        with torch.no_grad():
            logits, maux = model.forward(params, {"tokens": tokens})
        res[arch]["logits"] = logits.numpy()
        res[arch]["model_aux"] = float(maux)
    return res


@functools.lru_cache(maxsize=None)
def _ranks(mesh_name, path):
    shape = MESHES[mesh_name]
    return run_ranks(_rank, shape[0] * shape[1], (shape, str(path)),
                     backend="gloo", timeout=TIMEOUT)


def _single(arch, n_data):
    """The single-process sorted layer with one router group per data
    shard: output, aux, and the gradients of Σ out·w."""
    params, x, w = _inputs(arch)
    flat = {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = ly.moe_apply_sorted(_nest(flat), xt, _cfg(arch),
                                   n_groups=n_data)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), float(aux.detach()), xt.grad.numpy(), \
        {k: v.grad.numpy() for k, v in flat.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_ep_layer_matches_reference_shard_map(mesh_name, data_file,
                                              reference):
    shape = MESHES[mesh_name]
    b_loc = B // shape[0]
    for r in _ranks(mesh_name, data_file):
        rows = slice(r["coords"]["data"] * b_loc,
                     (r["coords"]["data"] + 1) * b_loc)
        for arch in ARCHS:
            want = reference[f"{arch}/{mesh_name}/out"][rows]
            np.testing.assert_allclose(r[arch]["out"], want, rtol=0,
                                       atol=1e-5)
            assert abs(r[arch]["aux"] - float(
                reference[f"{arch}/{mesh_name}/aux"])) <= 1e-6


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_ep_layer_and_gradients_match_single_process(mesh_name, data_file):
    """Output (within 1e-5), x's gradient (per data shard), the router's
    (on every rank, summed over the data ranks) and each expert slice's
    (summed over the data ranks) against one process, within 1e-5 +
    1e-5·|want| (the router's gradient sums 64 tokens' terms of ~20: f32
    order alone moves it by ~1e-5); the aux of each data shard averaged
    over the shards."""
    shape = MESHES[mesh_name]
    n_data, b_loc = shape[0], B // shape[0]
    ranks = _ranks(mesh_name, data_file)
    for arch in ARCHS:
        out, _, gx, grads = _single(arch, n_data)
        e_loc = _cfg(arch).moe.n_experts // shape[1]
        summed = {k: np.zeros_like(v) for k, v in grads.items()}
        for r in ranks:
            d, m = r["coords"]["data"], r["coords"]["model"]
            rows = slice(d * b_loc, (d + 1) * b_loc)
            np.testing.assert_allclose(r[arch]["out"], out[rows], rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(r[arch]["grad_x"], gx[rows],
                                       rtol=1e-5, atol=1e-5)
            for k in grads:
                g = r[arch][f"grad_{k}"]
                if k in ("wi", "wg", "wo"):
                    summed[k][m * e_loc:(m + 1) * e_loc] += g
                elif m == 0:
                    summed[k] += g
        for k, v in grads.items():
            np.testing.assert_allclose(summed[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{arch} {k}")
        shard_aux = np.mean([_single_aux(arch, d, b_loc)
                             for d in range(n_data)])
        for r in ranks:
            assert abs(r[arch]["aux"] - shard_aux) <= 1e-6


def _single_aux(arch, d, b_loc):
    params, x, _ = _inputs(arch)
    p = _nest({k: torch.from_numpy(v) for k, v in params.items()})
    _, aux = ly.moe_apply_sorted(
        p, torch.from_numpy(x[d * b_loc:(d + 1) * b_loc]), _cfg(arch))
    return float(aux)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_model_with_mesh_matches_single_process_einsum(mesh_name,
                                                       data_file):
    """``build_model(mesh=...)``'s forward on each rank's shard against
    the single-process einsum forward (capacity_factor = n_experts); the
    aux against the mean over data shards of each shard's own aux."""
    from repro_torch.models.registry import build_model
    shape = MESHES[mesh_name]
    b_loc = B // shape[0]
    ranks = _ranks(mesh_name, data_file)
    for arch in ARCHS:
        cfg = _cfg(arch, no_drops=True)
        model = build_model(cfg, dtype=torch.float32)
        params = model.init(3, "cpu")
        tokens = torch.from_numpy(np.random.default_rng(11).integers(
            0, cfg.vocab_size, (B, L)).astype(np.int64))
        with torch.no_grad():
            want, _ = model.forward(params, {"tokens": tokens})
            shard_aux = np.mean([float(model.forward(params, {
                "tokens": tokens[d * b_loc:(d + 1) * b_loc]})[1])
                for d in range(shape[0])])
        for r in ranks:
            rows = slice(r["coords"]["data"] * b_loc,
                         (r["coords"]["data"] + 1) * b_loc)
            np.testing.assert_allclose(r[arch]["logits"],
                                       want[rows].numpy(), rtol=1e-5,
                                       atol=1e-5)
            assert abs(r[arch]["model_aux"] - shard_aux) <= 1e-6


def test_local_params_keeps_the_rank_slices():
    """``local_params`` cuts each (L, E, ...) expert stack to the rank's
    experts (new storage) and keeps every other leaf, the dense
    residual's (L, d, ff) MLP included."""
    from repro_torch.launch.mesh import ProcessMesh, make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.moe_ep import local_params
    cfg = _cfg("arctic_480b")
    full = build_model(cfg).init(0, "cpu")
    base = make_mesh((1, 2), ("data", "model"))
    mesh = ProcessMesh(base.axis_names, base.shape,
                       coords={"data": 0, "model": 1})
    loc = local_params(full, mesh)
    moe, got = full["layers"]["mlp"], loc["layers"]["mlp"]
    for k in ("wi", "wg", "wo"):
        assert torch.equal(got[k], moe[k][:, 2:4])
        assert got[k].untyped_storage().data_ptr() != \
            moe[k].untyped_storage().data_ptr()
    assert got["router"] is moe["router"]
    assert got["dense"]["wi"] is moe["dense"]["wi"]
    assert loc["embed"] is full["embed"]


def test_moe_ep_refuses_what_it_cannot_run():
    """A mesh description runs meta tensors only (the dry run), and a
    rank given the full expert stack instead of its slice raises: no
    layer falls back to one process."""
    from repro_torch.launch.mesh import ProcessMesh, make_mesh
    from repro_torch.sharding.moe_ep import make_moe_ep
    cfg = _cfg("qwen3_moe_235b")
    params, x, _ = _inputs("qwen3_moe_235b")
    p = _nest({k: torch.from_numpy(v) for k, v in params.items()})
    mesh = make_mesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="meta tensors only"):
        make_moe_ep(mesh)(p, torch.from_numpy(x), cfg)
    rank = ProcessMesh(mesh.axis_names, mesh.shape,
                       coords={"data": 0, "model": 0}, groups={})
    with pytest.raises(ValueError, match="local_params"):
        make_moe_ep(rank)(p, torch.from_numpy(x), cfg)
    meta = {k: torch.empty_like(v, device="meta") for k, v in p.items()}
    out, aux = make_moe_ep(mesh)(meta, torch.empty(x.shape, device="meta"),
                                 cfg)
    assert out.shape == x.shape and out.is_meta and aux.shape == ()


def test_run_ranks_fails_a_failed_rank():
    """A rank that raises fails the run, with its traceback, instead of
    leaving the others waiting."""
    with pytest.raises(RuntimeError, match="rank 1"):
        run_ranks(_failing_rank, 2, backend="gloo", timeout=60)


def _failing_rank(rank):
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank 1 gives up")
    dist.barrier()


def test_run_ranks_fails_a_hung_world():
    """A world that outlasts its timeout is terminated and fails."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="0 of 2 ranks finished"):
        run_ranks(_hanging_rank, 2, backend="gloo", timeout=8)
    assert time.monotonic() - t0 < 40


def _hanging_rank(rank):
    import time
    time.sleep(120)
