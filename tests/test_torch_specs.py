"""The port's sharding rules (``repro_torch.sharding.specs``) against the
reference's (``repro.sharding.specs``), leaf for leaf, for every
``ARCH_IDS`` config at full size on the production meshes (16 x 16 and
2 x 16 x 16): the port's on meta tensors, the reference's on
``jax.eval_shape`` trees with an ``AbstractMesh``; and ``shard_shape`` /
``local_slice`` against JAX's own shard shapes and a reassembly."""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro.models.registry import build_model as ref_build
from repro.sharding import specs as ref_specs
from repro_torch.configs import get_config as port_config
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.registry import build_model as port_build
from repro_torch.sharding import specs as port_specs

MESHES = {"16x16": False, "2x16x16": True}


def _abstract(multi_pod):
    m = make_production_mesh(multi_pod=multi_pod)
    return AbstractMesh(tuple(m.shape.values()), m.axis_names)


def _ref_named(tree):
    """{path: spec tuple} of a reference spec tree."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                        if not isinstance(k, jax.tree_util.GetAttrKey)
                        else "." + k.name for k in path)
        out[name] = tuple(spec)
    return out


def _port_named(tree):
    out = {}

    def one(path, spec):
        out["/".join(path)] = tuple(spec)
        return spec
    is_spec = (lambda x: isinstance(x, tuple) and not hasattr(x, "_fields")
               and all(e is None or isinstance(e, (str, tuple)) for e in x))

    def walk(t, path):
        if is_spec(t):
            one(path, t)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (str(k),))
        elif hasattr(t, "_fields"):
            for f in t._fields:
                walk(getattr(t, f), path + ("." + f,))
        else:
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
    walk(tree, ())
    return out


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    model = ref_build(get_config(arch))
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return port_build(port_config(arch)).init(0, "meta")


def _ref_cache(arch, shape):
    cfg = get_config(arch)
    n_prefix = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    model = ref_build(cfg)
    return jax.eval_shape(lambda: model.init_cache(
        shape.global_batch, shape.seq_len + n_prefix))


def _port_cache(arch, shape):
    cfg = port_config(arch)
    n_prefix = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    return port_build(cfg).init_cache(shape.global_batch,
                                      shape.seq_len + n_prefix, "meta")


def _same(got, want):
    assert got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_zero1_specs_match_reference(arch, mesh_name):
    multi = MESHES[mesh_name]
    am, pm = _abstract(multi), make_production_mesh(multi_pod=multi)
    rp, pp = _ref_params(arch), _port_params(arch)
    sharded = _port_named(port_specs.param_specs(pp, pm))
    _same(sharded, _ref_named(ref_specs.param_specs(rp, am)))
    _same(_port_named(port_specs.zero1_specs(pp, pm)),
          _ref_named(ref_specs.zero1_specs(rp, am)))
    _same(_port_named(port_specs.replicated_specs(pp)),
          _ref_named(ref_specs.replicated_specs(rp)))
    assert any(any(e is not None for e in s) for s in sharded.values())


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_reference(arch, shape_name):
    from repro.launch.inputs import batch_structs as ref_batch
    from repro_torch.launch.inputs import batch_structs as port_batch
    shape = INPUT_SHAPES[shape_name]
    rc, pc = _ref_cache(arch, shape), _port_cache(arch, shape)
    B, S = shape.global_batch, shape.seq_len
    rb, pb = ref_batch(get_config(arch), B, S), port_batch(port_config(arch),
                                                           B, S)
    for multi in MESHES.values():
        am, pm = _abstract(multi), make_production_mesh(multi_pod=multi)
        _same(_port_named(port_specs.cache_specs(pc, pm, B)),
              _ref_named(ref_specs.cache_specs(rc, am, B)))
        _same(_port_named(port_specs.batch_specs(pb, pm)),
              _ref_named(ref_specs.batch_specs(rb, am)))
    assert port_specs.dp_axes(make_production_mesh(multi_pod=True)) == \
        ref_specs.dp_axes(_abstract(True))


@pytest.mark.parametrize("spec", [
    (("pod", "data"), None, "model"), ("data", "model", None),
    (None, None, None), ("model", ("pod", "data"), None)])
def test_shard_shape_matches_jax(spec):
    am, pm = _abstract(True), make_production_mesh(multi_pod=True)
    shape = (64, 32, 48)
    want = NamedSharding(am, P(*spec)).shard_shape(shape)
    assert port_specs.shard_shape(shape, spec, pm) == tuple(want)


def test_local_slices_reassemble_the_tensor():
    """Every device's ``local_slice`` under a spec that splits dim 0 over
    (pod, data) and dim 2 over model, on a 2 x 2 x 2 mesh: the shards
    tile the tensor exactly, shard (p, d, m) at rows (p·2 + d)·4 and
    columns m·3, as JAX's row-major order over the axes puts it."""
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    spec = (("pod", "data"), None, "model")
    t = torch.arange(16 * 5 * 6).reshape(16, 5, 6)
    seen = torch.zeros_like(t)
    for p in range(2):
        for d in range(2):
            for m in range(2):
                s = port_specs.local_slice(t, spec, mesh,
                                           {"pod": p, "data": d, "model": m})
                assert tuple(s.shape) == port_specs.shard_shape(t.shape, spec,
                                                                mesh)
                r0, c0 = (p * 2 + d) * 4, m * 3
                np.testing.assert_array_equal(
                    s.numpy(), t[r0:r0 + 4, :, c0:c0 + 3].numpy())
                seen[r0:r0 + 4, :, c0:c0 + 3] += 1
    assert bool((seen == 1).all())
    with pytest.raises(ValueError):
        port_specs.shard_shape((6, 4), ("data", None), make_mesh((4, 1), (
            "data", "model")))
