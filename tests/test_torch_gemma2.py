"""gemma2's features in the port's transformer (local and global layers,
the attention and final soft-caps, the post-norms, gelu under the
soft-cap, the embedding scale, and the paired ring decode cache) against
the JAX package, on the reference's weights carried across
(``repro_torch.convert``) and its ``make_batch`` tokens, with
``reduced(gemma2_9b)`` (window 8) at 2 and at 4 layers; and an unpaired
windowed config (``global_every`` 3, 3 layers) on the plain cache.

Tolerances, and why:
  * the forward, f32 compute: logits within 1e-5 absolute, the loss
    within 1e-6 relative (the same math, f32 sums in another order, as
    tests/test_torch_model.py); bf16: logits within 0.05, the loss
    within 1e-3 relative (both round every product to bf16, at
    different points).
  * the bf16 embedding (scale sqrt(d_model) cast to bf16 first, as the
    reference does): bit for bit.
  * decode against the forward over the same tokens: 2e-3, as
    tests/test_archs.py and tests/test_perf_variants.py (whose ring tests
    these are on the port); the port's decode logits and every cache
    entry (the rings included) against the reference's: 1e-5 (f32).

The test marked ``gpu`` runs the decode on the card and skips without
one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import transformer as ref_transformer
from repro.models.registry import build_model as ref_build
from repro.models.registry import make_batch as ref_make_batch
from repro_torch import configs as pconfigs
from repro_torch.convert import train_state_from_numpy
from repro_torch.launch import serve_decode
from repro_torch.models import transformer
from repro_torch.models.registry import build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.tree import flatten

#: 2 layers (one local/global pair), 4 (two pairs), and an unpaired
#: windowed config: global_every 3 over 3 layers (local, local, global)
SHAPES = {"L2": {}, "L4": {"n_layers": 4},
          "unpaired": {"n_layers": 3, "global_every": 3}}


def _cfgs(shape="L2"):
    ch = SHAPES[shape]
    return (dataclasses.replace(
                rconfigs.reduced(rconfigs.get_config("gemma2_9b")), **ch),
            dataclasses.replace(
                pconfigs.reduced(pconfigs.get_config("gemma2_9b")), **ch))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _setup(shape, dtype="float32", B=2, L=30, seed=0):
    ref_cfg, cfg = _cfgs(shape)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = ref_build(ref_cfg, dtype=jdt)
    params = jax.tree.map(lambda a: a.astype(jdt),
                          jm.init(jax.random.PRNGKey(seed)))
    jb = ref_make_batch(ref_cfg, B, L)
    tp = train_state_from_numpy(_np(params), device="cpu")
    return jm, params, jb, build_model(cfg, dtype=tdt), tp


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


def test_init_has_the_reference_tree():
    ref_cfg, cfg = _cfgs("L4")
    want = flatten(_np(ref_build(ref_cfg).init(jax.random.PRNGKey(0))))
    got = flatten(build_model(cfg).init(0, "meta"))
    assert [(n, tuple(a.shape)) for n, a in want] == \
        [(n, tuple(t.shape)) for n, t in got]
    names = [n for n, _ in got]
    assert "layers/ln1b" in names and "layers/ln2b" in names


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_matches_reference(shape, dtype):
    """30 tokens, past the window of 8: the local layers' mask bites.
    The logits come back f32 in both dtypes (the final soft-cap is taken
    in f32)."""
    jm, params, jb, pm, tp = _setup(shape, dtype, seed=1)
    jl, _ = jm.forward(params, jb)
    tl, aux = pm.forward(tp, _torch(jb))
    assert jl.dtype == jnp.float32 and tl.dtype == torch.float32
    assert float(aux) == 0.0
    assert float(tl.abs().max()) <= pm.cfg.final_softcap
    _close(tl, jl, 1e-5 if dtype == "float32" else 0.05)
    assert float(pm.loss(tp, _torch(jb))) == pytest.approx(
        float(jm.loss(params, jb)), rel=1e-6 if dtype == "float32" else 1e-3)


def test_bf16_embedding_is_bit_exact():
    """At gemma2's published width (3584) the scale sqrt(3584) = 59.866
    is 59.75 in bf16; the reference casts it before the multiply. The
    port's bf16 embedding equals the reference's bit for bit, and the
    same embedding scaled by the Python float does not."""
    ref_cfg, cfg = (dataclasses.replace(c, d_model=3584) for c in _cfgs())
    rng = np.random.default_rng(0)
    table = rng.standard_normal((cfg.vocab_size, 3584)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want, n_prefix = ref_transformer.embed_inputs(
        {"embed": jnp.asarray(table)}, ref_cfg,
        {"tokens": jnp.asarray(tokens)}, jnp.bfloat16)
    assert n_prefix == 0
    want = np.asarray(want).view(np.uint16)
    got = transformer._embed({"embed": torch.from_numpy(table)}, cfg,
                             torch.from_numpy(tokens), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy()
                                  .view(np.uint16), want)
    by_float = (torch.from_numpy(table).to(torch.bfloat16)[
        torch.from_numpy(tokens)] * 3584 ** 0.5)
    assert (by_float.view(torch.int16).numpy().view(np.uint16)
            != want).any()


def test_logits_are_f32_in_bf16():
    _, _, jb, pm, tp = _setup("L2", "bfloat16", L=12)
    tokens = _torch(jb)["tokens"]
    logits, _ = pm.forward(tp, {"tokens": tokens})
    cache = pm.init_cache(2, 16, "cpu")
    assert cache["k_loc"].dtype == torch.bfloat16
    last, cache = pm.prefill(tp, {"tokens": tokens[:, :11]}, cache)
    dec, _ = pm.decode(tp, tokens[:, 11:], cache, 11)
    assert {t.dtype for t in (logits, last, dec)} == {torch.float32}


@pytest.mark.parametrize("shape", ["L2", "L4"])
def test_ring_cache_long_decode(shape):
    """tests/test_perf_variants.py::test_gemma2_ring_cache_long_decode on
    the port: a decode position far past the window (more than three
    wraps) against the forward."""
    _, _, jb, pm, tp = _setup(shape)
    B, L = jb["tokens"].shape
    tokens = _torch(jb)["tokens"]
    logits, _ = pm.forward(tp, {"tokens": tokens})
    cache = pm.init_cache(B, L + 2, "cpu")
    W = pm.cfg.window_size
    P = pm.cfg.n_layers // 2
    assert cache["k_loc"].shape == (P, B, W, pm.cfg.n_kv_heads,
                                    pm.cfg.resolved_head_dim)  # a ring
    assert cache["k"].shape[:3] == (P, B, L + 2)
    last, cache = pm.prefill(tp, {"tokens": tokens[:, :L - 1]}, cache)
    assert float((last[:, 0] - logits[:, L - 2]).abs().max()) < 2e-3
    dec, _ = pm.decode(tp, tokens[:, L - 1:], cache, L - 1)
    assert float((dec[:, 0] - logits[:, -1]).abs().max()) < 2e-3


@pytest.mark.parametrize("shape", ["L2", "L4"])
def test_sequential_ring_decode_matches_reference(shape):
    """tests/test_perf_variants.py::test_gemma2_sequential_ring_decode on
    the port: a 12-token prompt, then 6 decode steps through the ring's
    wrap-around, each against the forward and against the reference's
    decode; the rings (``k_loc``/``v_loc``) and the global layers' cache
    against the reference's after the prefill and after each step."""
    jm, params, jb, pm, tp = _setup(shape, B=1, L=18)
    P, extra = 12, 6
    tokens = _torch(jb)["tokens"]
    full, _ = pm.forward(tp, {"tokens": tokens})
    jcache = jm.init_cache(1, P + extra + 2)
    jlast, jcache = jm.prefill(params, {"tokens": jb["tokens"][:, :P]},
                               jcache)
    cache = pm.init_cache(1, P + extra + 2, "cpu")
    rings = cache["k_loc"], cache["v_loc"]
    last, cache = pm.prefill(tp, {"tokens": tokens[:, :P]}, cache)
    assert cache["k_loc"] is rings[0] and cache["v_loc"] is rings[1]
    _close(last, jlast, 1e-5)

    def same_cache():
        assert sorted(cache) == sorted(jcache) == ["k", "k_loc", "v",
                                                   "v_loc"]
        for name in cache:
            assert tuple(cache[name].shape) == jcache[name].shape
            _close(cache[name], jcache[name], 1e-5)

    same_cache()
    decode = jax.jit(jm.decode)
    for i in range(extra):
        dec, cache = pm.decode(tp, tokens[:, P + i:P + i + 1], cache, P + i)
        jdec, jcache = decode(params, jb["tokens"][:, P + i:P + i + 1],
                              jcache, jnp.int32(P + i))
        assert float((dec[:, 0] - full[:, P + i]).abs().max()) < 2e-3, i
        _close(dec, jdec, 1e-5)
        same_cache()


def test_ring_prefill_shorter_than_the_window():
    """A prompt shorter than the ring: the slots past it hold position 0
    (clipped) and decode masks them."""
    jm, params, jb, pm, tp = _setup("L2", B=2, L=8)
    tokens = _torch(jb)["tokens"]
    full, _ = pm.forward(tp, {"tokens": tokens})
    jcache = jm.init_cache(2, 12)
    _, jcache = jm.prefill(params, {"tokens": jb["tokens"][:, :5]}, jcache)
    cache = pm.init_cache(2, 12, "cpu")
    _, cache = pm.prefill(tp, {"tokens": tokens[:, :5]}, cache)
    for name in ("k_loc", "v_loc"):
        _close(cache[name], jcache[name], 1e-5)
    for i in range(3):
        dec, cache = pm.decode(tp, tokens[:, 5 + i:6 + i], cache, 5 + i)
        assert float((dec[:, 0] - full[:, 5 + i]).abs().max()) < 2e-3


def test_unpaired_windowed_config_matches_reference():
    """global_every 3 is not the pair layout: the plain stacked cache,
    with each layer's window and the soft-cap, against the reference's
    prefill and decode and against the forward."""
    jm, params, jb, pm, tp = _setup("unpaired", L=16)
    B, L = jb["tokens"].shape
    tokens = _torch(jb)["tokens"]
    full, _ = pm.forward(tp, {"tokens": tokens})
    cache = pm.init_cache(B, L + 4, "cpu")
    assert sorted(cache) == ["k", "v"] and cache["k"].shape[0] == 3
    jcache = jm.init_cache(B, L + 4)
    jlast, jcache = jm.prefill(params, {"tokens": jb["tokens"][:, :L - 1]},
                               jcache)
    jdec, jcache = jm.decode(params, jb["tokens"][:, L - 1:], jcache,
                             jnp.int32(L - 1))
    last, cache = pm.prefill(tp, {"tokens": tokens[:, :L - 1]}, cache)
    dec, cache = pm.decode(tp, tokens[:, L - 1:], cache, L - 1)
    for got, want in ((last, jlast), (dec, jdec), (cache["k"], jcache["k"]),
                      (cache["v"], jcache["v"])):
        _close(got, want, 1e-5)
    assert float((dec[:, 0] - full[:, -1]).abs().max()) < 2e-3


def test_is_global_matches_reference():
    for shape in SHAPES:
        ref_cfg, cfg = _cfgs(shape)
        assert transformer._is_global(cfg) == \
            np.asarray(ref_transformer._is_global(ref_cfg)).tolist()


def test_train_step():
    ref_cfg, cfg = _cfgs("L4")
    m = build_model(cfg)
    state = init_train_state(m, 0, "cpu")
    before = state.opt.master["layers"]["ln1b"].clone()
    batch = _torch(ref_make_batch(ref_cfg, 2, 16))
    _, metrics = make_train_step(m, AdamConfig(warmup_steps=1))(state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert not torch.equal(state.opt.master["layers"]["ln1b"], before)
    assert all(bool(torch.isfinite(t).all())
               for _, t in flatten(state.opt.master))


def test_serve_decode_on_the_cpu():
    seq = serve_decode.main(["--arch", "gemma2_9b", "--reduced",
                             "--device", "cpu", "--batch", "2",
                             "--prompt-len", "12", "--new-tokens", "4"])
    assert seq.shape == (2, 4) and seq.dtype == torch.int32


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_ring_decode_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, cfg = _cfgs("L4")
    pm = build_model(cfg, dtype=torch.float32)
    params = pm.init(0, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device="cuda")
    full, _ = pm.forward(params, {"tokens": tokens})
    cache = pm.init_cache(2, 40, "cuda")
    last, cache = pm.prefill(params, {"tokens": tokens[:, :30]}, cache)
    dec = [last[:, 0]]
    for i in range(9):
        lg, cache = pm.decode(params, tokens[:, 30 + i:31 + i], cache,
                              30 + i)
        dec.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(dec, 1), full[:, 29:39],
                               atol=2e-3, rtol=0)
