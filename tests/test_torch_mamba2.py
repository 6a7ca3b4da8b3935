"""The port's Mamba2 (SSD) path and its kernel (B4), and the kernel
forward path (``use_kernels``) of both ported families, against the JAX
package, with the reference's weights carried across
(``repro_torch.convert``) and inputs made with numpy from a seed.

Tolerances, and why:
  * ``ssd_intra_chunk`` plain version vs the Pallas kernel (interpret
    mode) and ``ref.ssd_intra_chunk_ref``: 1e-4, as tests/test_kernels.py
    (float32 sums in another order; the Pallas kernel takes the decay as
    a difference of two prefix sums, the plain version as segment sums).
  * ``ssd_chunked`` with and without the hook, against the reference's
    and against the step-by-step recurrence: 2e-4, as test_kernels.py.
  * the reduced mamba2_370m forward: float32 logits within 1e-5 (the
    same math, float32 sums in another order); bfloat16 within 0.05 (both
    round every product to bfloat16, at different points — as
    tests/test_torch_model.py).
  * ``use_kernels`` against the reference's ``use_pallas``: 1e-3, as
    tests/test_use_pallas.py.
  * decode against forward: 2e-3, as tests/test_archs.py.
  * checkpoints: bit-exact (a byte format).

The tests marked ``gpu`` hold the CUDA kernel against the plain version
on the card and skip without one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core.engine import CheckpointEngine as RefEngine
from repro.core.engine import CheckpointSpec as RefSpec
from repro.data.pipeline import DataConfig as RefData
from repro.data.pipeline import TokenStream as RefStream
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.layers import ssd_chunked as ref_ssd_chunked
from repro.models.registry import build_model as ref_build
from repro.models.registry import make_batch as ref_make_batch
from repro_torch import configs as pconfigs
from repro_torch.convert import to_numpy, train_state_from_numpy
from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
from repro_torch.data.pipeline import prng_key, randint, split
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_intra_chunk_plain
from repro_torch.launch import serve_decode
from repro_torch.models.layers import ssd_chunked
from repro_torch.models.registry import build_model
from repro_torch.train.steps import make_decode_step
from repro_torch.tree import flatten


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _cfgs(arch="mamba2_370m"):
    return (rconfigs.reduced(rconfigs.get_config(arch)),
            pconfigs.reduced(pconfigs.get_config(arch)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(vocab, batch=2, seq=40):
    b = RefStream(RefData(vocab, seq, batch, seed=0)).peek(0)
    return b, {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


# ------------------------------------------------------ ssd_intra_chunk
@pytest.mark.parametrize("b,nc,cl,h,p,n", [
    (1, 2, 64, 2, 32, 16),
    (2, 4, 128, 4, 64, 32),
    (1, 1, 256, 8, 64, 64),
])
def test_ssd_plain_matches_reference(b, nc, cl, h, p, n):
    rng = np.random.default_rng(cl + n)
    xc = _rand(rng, (b, nc, cl, h, p))
    dAc = -np.abs(_rand(rng, (b, nc, cl, h))) * 0.1
    Bc, Cc = _rand(rng, (b, nc, cl, h, n)), _rand(rng, (b, nc, cl, h, n))
    j, t = _both(xc, dAc, Bc, Cc)
    got = ops.ssd_intra_chunk(*t)
    assert got.dtype == torch.float32 and got.shape == xc.shape
    for want in (jops.ssd_intra_chunk(*j), jref.ssd_intra_chunk_ref(*j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def _ssd_inputs(rng, b, l, h, p, n, D=True):
    x = _rand(rng, (b, l, h, p))
    dt = np.abs(_rand(rng, (b, l, h))) * 0.1 + 0.01
    A = -np.abs(_rand(rng, (h,)))
    B_, C_ = _rand(rng, (b, l, 1, n)), _rand(rng, (b, l, 1, n))
    Dv = _rand(rng, (h,)) if D else np.zeros((h,), np.float32)
    return x, dt, A, B_, C_, Dv


@pytest.mark.parametrize("l", [64, 40])         # 40: the padding path
@pytest.mark.parametrize("hook", [False, True])
def test_ssd_chunked_matches_reference(l, hook):
    j, t = _both(*_ssd_inputs(np.random.default_rng(l), 1, l, 2, 32, 16))
    y0, s0 = ref_ssd_chunked(*j, 16)
    y1, s1 = ssd_chunked(*t, 16,
                         ssd_kernel=ops.ssd_intra_chunk if hook else None)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y0), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s0), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("hook", [False, True])
def test_ssd_chunked_matches_naive_recurrence(hook):
    b, l, h, p, n, chunk = 1, 32, 2, 8, 4, 8
    xn, dtn, An, Bn, Cn, Dn = _ssd_inputs(np.random.default_rng(1), b, l, h,
                                          p, n, D=False)
    _, t = _both(xn, dtn, An, Bn, Cn, Dn)
    y, final = ssd_chunked(*t, chunk,
                           ssd_kernel=ops.ssd_intra_chunk if hook else None)
    state = np.zeros((b, h, p, n), np.float32)
    ys = []
    for i in range(l):
        dA = np.exp(dtn[:, i] * An[None])
        xb = xn[:, i] * dtn[:, i][..., None]
        state = state * dA[..., None, None] + \
            np.einsum("bhp,bn->bhpn", xb, Bn[:, i, 0])
        ys.append(np.einsum("bhpn,bn->bhp", state, Cn[:, i, 0]))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, axis=1), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(final.numpy(), state, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("shape,dtype,err", [
    ((1, 1, 16, 2, 32), torch.float16, TypeError),
    ((1, 1, 16, 2, 48), torch.float32, ValueError),
])
def test_ssd_kernel_refuses_what_it_does_not_take(shape, dtype, err):
    """Off the CPU (``meta`` here), arguments the CUDA kernel does not
    take raise before any launch."""
    b, nc, cl, h, _ = shape
    x = torch.empty(shape, dtype=dtype, device="meta")
    dA = torch.empty((b, nc, cl, h), dtype=dtype, device="meta")
    Bc = torch.empty((b, nc, cl, h, 16), dtype=dtype, device="meta")
    with pytest.raises(err, match="ssd_intra_chunk"):
        ops.ssd_intra_chunk(x, dA, Bc, Bc)


# ---------------------------------------------------------------- model
def test_init_has_the_reference_tree():
    ref_cfg, cfg = _cfgs()
    want = flatten(_np(ref_build(ref_cfg).init(jax.random.PRNGKey(0))))
    got = flatten(build_model(cfg).init(0, "meta"))
    assert [(n, tuple(a.shape)) for n, a in want] == \
        [(n, tuple(t.shape)) for n, t in got]
    assert all(t.dtype == torch.float32 for _, t in got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    ref_cfg, cfg = _cfgs()
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = ref_build(ref_cfg, dtype=jdt)
    params = jax.tree.map(lambda a: a.astype(jdt),
                          jm.init(jax.random.PRNGKey(1)))
    jb, tb = _batch(cfg.vocab_size)
    pm = build_model(cfg, dtype=tdt)
    tparams = train_state_from_numpy(_np(params), device="cpu")
    # the params dict crosses unchanged, both ways
    for (_, a), (_, b) in zip(flatten(to_numpy(tparams)),
                              flatten(_np(params))):
        assert a.tobytes() == np.ascontiguousarray(b).tobytes()
    jl, _ = jm.forward(params, jb)
    tl, aux = pm.forward(tparams, tb)
    assert tl.dtype == tdt and float(aux) == 0.0
    tol = 1e-5 if dtype == "float32" else 0.05
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl, np.float32), atol=tol, rtol=0)
    assert float(pm.loss(tparams, tb)) == pytest.approx(
        float(jm.loss(params, jb)), rel=1e-6 if dtype == "float32" else 1e-3)


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "mamba2_370m"])
def test_use_kernels_matches_reference_use_pallas(arch):
    """The kernel forward path of each ported family (plain versions on
    the CPU) against the reference's Pallas one, on the reference's
    weights (tests/test_use_pallas.py)."""
    ref_cfg, cfg = _cfgs(arch)
    seq = 64 if cfg.arch_type == "dense" else 32
    jb = ref_make_batch(ref_cfg, 1, seq)
    jm = ref_build(ref_cfg, dtype=jnp.float32, use_pallas=True)
    params = jm.init(jax.random.PRNGKey(0))
    jl, _ = jax.jit(jm.forward)(params, jb)
    pm = build_model(cfg, dtype=torch.float32, use_kernels=True)
    n_attn, n_ssd = ops.flash_attention.launches, ops.ssd_intra_chunk.launches
    tl, _ = pm.forward(train_state_from_numpy(_np(params), device="cpu"),
                       {k: torch.from_numpy(np.array(v))
                        for k, v in jb.items()})
    assert (ops.flash_attention.launches,
            ops.ssd_intra_chunk.launches) == (n_attn, n_ssd)
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < 1e-3


def test_decode_matches_forward_and_reference():
    ref_cfg, cfg = _cfgs()
    jm = ref_build(ref_cfg, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    B, L = 2, 16
    jb = ref_make_batch(ref_cfg, B, L)
    jcache = jm.init_cache(B, L + 4)
    _, jcache = jm.prefill(params, {"tokens": jb["tokens"][:, :L - 1]},
                           jcache)
    jdec, _ = jm.decode(params, jb["tokens"][:, L - 1:], jcache,
                        jnp.int32(L - 1))

    pm = build_model(cfg, dtype=torch.float32)
    tp = train_state_from_numpy(_np(params), device="cpu")
    tokens = torch.from_numpy(np.array(jb["tokens"]))
    logits, _ = pm.forward(tp, {"tokens": tokens})
    cache = pm.init_cache(B, L + 4, "cpu")
    last, cache = pm.prefill(tp, {"tokens": tokens[:, :L - 1]}, cache)
    assert last.shape == (B, 1, cfg.vocab_size)
    assert cache["ssm"].dtype == torch.float32
    dec, new_cache = pm.decode(tp, tokens[:, L - 1:], cache, L - 1)
    assert float((dec[:, 0] - logits[:, -1]).abs().max()) < 2e-3
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=1e-5,
                               rtol=0)
    tok, _ = make_decode_step(pm)(tp, tokens[:, L - 1:], cache, L - 1)
    assert tok.dtype == torch.int32 and torch.equal(tok, dec.argmax(-1))
    assert new_cache["conv"].shape == cache["conv"].shape


def test_dense_prefill_and_decode_raise():
    _, cfg = _cfgs("stablelm_1_6b")
    pm = build_model(cfg)
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        pm.init_cache(1, 8, "cpu")
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        pm.decode({}, None, None, 0)


def test_serve_decode_on_the_cpu():
    ref_cfg, cfg = _cfgs()
    seq = serve_decode.main(["--arch", "mamba2_370m", "--reduced",
                             "--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--new-tokens", "4"])
    assert seq.shape == (2, 4) and seq.dtype == torch.int32
    assert ((0 <= seq) & (seq < cfg.vocab_size)).all()
    # the prompt is the example's make_batch token ids
    k1, _ = split(prng_key(0))
    np.testing.assert_array_equal(
        randint(k1, (2, 8), 0, cfg.vocab_size),
        np.asarray(ref_make_batch(ref_cfg, 2, 8)["tokens"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            serve_decode.main(["--arch", "mamba2_370m", "--reduced"])


# ---------------------------------------------------------- checkpoints
def _same_bits(loaded: dict, tree):
    want = dict(flatten(tree))
    assert sorted(loaded) == sorted(want)
    for name, a in loaded.items():
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        w = want[name]
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert a.tobytes() == np.ascontiguousarray(w).tobytes(), name


def test_mamba2_checkpoints_cross_load(tmp_path):
    """Params written by the port load bit-exact through the reference's
    engine, and the reverse."""
    ref_cfg, cfg = _cfgs()
    port_params = build_model(cfg).init(3, "cpu")
    d = str(tmp_path / "port")
    CheckpointEngine(CheckpointSpec(d, backend="fastpersist")).save(
        port_params, 1, {"step": 1}).wait()
    got, _ = RefEngine(RefSpec(d)).load()
    _same_bits(got, port_params)

    ref_params = _np(ref_build(ref_cfg).init(jax.random.PRNGKey(4)))
    d = str(tmp_path / "ref")
    RefEngine(RefSpec(d, backend="fastpersist")).save(
        ref_params, 2, {"step": 2}).wait()
    like = build_model(cfg).init(0, "meta")
    got, _ = CheckpointEngine(CheckpointSpec(d)).load(like=like,
                                                      device="cpu")
    _same_bits(dict(flatten(got)), ref_params)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,nc,cl,h,p,n", [
    (1, 2, 64, 2, 32, 16),
    (2, 4, 128, 4, 64, 32),
    (1, 1, 256, 8, 64, 64),
    (1, 2, 256, 32, 64, 128),          # mamba2_370m's chunk and widths
    (2, 3, 16, 4, 32, 16),             # reduced config: a partial tile
])
def test_ssd_kernel_matches_plain_on_card(cuda, b, nc, cl, h, p, n):
    g = torch.Generator(device=cuda).manual_seed(cl + n)
    xc = torch.randn((b, nc, cl, h, p), generator=g, device=cuda)
    dAc = -torch.randn((b, nc, cl, h), generator=g, device=cuda).abs() * 0.1
    Bc, Cc = (torch.randn((b, nc, cl, h, n), generator=g, device=cuda)
              for _ in range(2))
    n0 = ops.ssd_intra_chunk.launches
    got = ops.ssd_intra_chunk(xc, dAc, Bc, Cc)
    want = ssd_intra_chunk_plain(xc, dAc, Bc, Cc)
    torch.cuda.synchronize()
    assert ops.ssd_intra_chunk.launches == n0 + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm_1_6b", "mamba2_370m"])
def test_use_kernels_matches_plain_hooks_on_card(cuda, arch):
    _, cfg = _cfgs(arch)
    cfg = dataclasses.replace(cfg, n_layers=3)
    params = build_model(cfg).init(0, cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 80),
                                     device=cuda)}
    want, _ = build_model(cfg, dtype=torch.float32).forward(params, batch)
    counts = (ops.flash_attention.launches, ops.ssd_intra_chunk.launches)
    got, _ = build_model(cfg, dtype=torch.float32,
                         use_kernels=True).forward(params, batch)
    torch.cuda.synchronize()
    launched = (ops.flash_attention.launches - counts[0],
                ops.ssd_intra_chunk.launches - counts[1])
    assert launched == ((3, 0) if arch == "stablelm_1_6b" else (0, 3))
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
