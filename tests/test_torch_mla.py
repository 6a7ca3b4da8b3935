"""Multi-head latent attention in the port (``layers.mla_init`` /
``layers.mla_attention``, its naive and absorbed paths, the latent decode
cache normalised at write) against the JAX package, on the reference's
weights carried across (``repro_torch.convert``) and its ``make_batch``
tokens, with ``reduced(minicpm3_4b)``.

Tolerances, and why:
  * the forward, f32 compute: logits within 1e-5 absolute, the loss
    within 1e-6 relative (the same math, f32 sums in another order, as
    tests/test_torch_model.py); bf16: logits within 0.05, the loss
    within 1e-3 relative (both round every product to bf16, at
    different points).
  * decode against the forward over the same tokens: 2e-3, as
    tests/test_archs.py and tests/test_perf_variants.py; absorbed
    against naive decode: 2e-4, as test_perf_variants.py (whose MLA
    tests these are on the port).
  * the port's decode logits and latent cache against the reference's:
    1e-5 in f32, 0.05 in bf16 (the absorbed path's score and latent
    products take bf16 operands summed in f32 on both sides). The
    reference's absorbed path does not run in bf16 on the CPU (XLA's CPU
    dot has no bf16 x bf16 = f32; ROADMAP C.21), so the port's bf16
    absorbed path is held against the reference's bf16 naive one: the
    same function, rounded at other points.

The test marked ``gpu`` runs the decode on the card and skips without
one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import layers as ref_layers
from repro.models.registry import build_model as ref_build
from repro.models.registry import make_batch as ref_make_batch
from repro_torch import configs as pconfigs
from repro_torch.convert import train_state_from_numpy
from repro_torch.launch import serve_decode
from repro_torch.models import layers as ly
from repro_torch.models.registry import build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.tree import flatten


def _cfgs(absorb=False):
    return tuple(dataclasses.replace(
        c.reduced(c.get_config("minicpm3_4b")), mla_absorb=absorb)
        for c in (rconfigs, pconfigs))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _setup(dtype="float32", absorb=False, B=2, L=16, seed=0):
    ref_cfg, cfg = _cfgs(absorb)
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
    ref_cfg, cfg = _cfgs()
    want = flatten(_np(ref_build(ref_cfg).init(jax.random.PRNGKey(0))))
    got = flatten(build_model(cfg).init(0, "meta"))
    assert [(n, tuple(a.shape)) for n, a in want] == \
        [(n, tuple(t.shape)) for n, t in got]
    assert "layers/attn/wkv_b" in dict(got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    jm, params, jb, pm, tp = _setup(dtype, L=32, seed=1)
    jl, _ = jm.forward(params, jb)
    tl, aux = pm.forward(tp, _torch(jb))
    assert tl.dtype == tp["embed"].dtype and float(aux) == 0.0
    _close(tl, jl, 1e-5 if dtype == "float32" else 0.05)
    assert float(pm.loss(tp, _torch(jb))) == pytest.approx(
        float(jm.loss(params, jb)), rel=1e-6 if dtype == "float32" else 1e-3)


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_matches_reference(dtype, absorb):
    """One layer's attention on a cache of 12 slots holding 7 entries,
    with 2 new queries: the output and the written cache."""
    ref_cfg, cfg = _cfgs()
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    p = jax.tree.map(lambda a: a.astype(jdt), ref_layers.mla_init(
        jax.random.PRNGKey(3), ref_cfg))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, cfg.d_model)).astype(np.float32)
    width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    cache = rng.standard_normal((2, 12, width)).astype(np.float32)
    pos = np.arange(7, 9, dtype=np.int32)
    want, wcache = ref_layers.mla_attention(
        p, jnp.asarray(x, jdt), ref_cfg, jnp.asarray(pos),
        cache=jnp.asarray(cache, jdt), cache_pos=7,
        absorb=absorb and dtype == "float32")             # C.21
    tcache = torch.from_numpy(cache).to(tdt)
    got, gcache = ly.mla_attention(
        {k: torch.from_numpy(np.array(v, np.float32)).to(tdt)
         for k, v in p.items()}, torch.from_numpy(x).to(tdt), cfg,
        torch.from_numpy(pos), cache=tcache, cache_pos=7, absorb=absorb)
    assert gcache is tcache and got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 0.05
    _close(got, want, tol)
    _close(gcache, wcache, tol)


@pytest.mark.parametrize("absorb", [False, True])
def test_decode_matches_forward(absorb):
    """tests/test_perf_variants.py::test_mla_absorbed_decode_equals_naive
    on the port: prefill 15 tokens, decode the 16th, against the forward."""
    _, _, jb, pm, tp = _setup(absorb=absorb)
    B, L = jb["tokens"].shape
    tokens = _torch(jb)["tokens"]
    logits, _ = pm.forward(tp, {"tokens": tokens})
    cache = pm.init_cache(B, L + 4, "cpu")
    last, cache = pm.prefill(tp, {"tokens": tokens[:, :L - 1]}, cache)
    assert float((last[:, 0] - logits[:, L - 2]).abs().max()) < 2e-3
    dec, _ = pm.decode(tp, tokens[:, L - 1:], cache, L - 1)
    assert float((dec[:, 0] - logits[:, -1]).abs().max()) < 2e-3


def test_absorbed_same_logits_as_naive():
    """tests/test_perf_variants.py::test_mla_absorbed_same_logits_as_naive
    on the port."""
    outs = []
    for absorb in (False, True):
        _, _, jb, pm, tp = _setup(absorb=absorb, L=12)
        tokens = _torch(jb)["tokens"]
        cache = pm.init_cache(2, 16, "cpu")
        _, cache = pm.prefill(tp, {"tokens": tokens[:, :11]}, cache)
        dec, _ = pm.decode(tp, tokens[:, 11:12], cache, 11)
        outs.append(dec.numpy())
    np.testing.assert_allclose(outs[0], outs[1], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_reference_decode(dtype, absorb):
    """Prefill 10 tokens, then 4 decode steps: the logits and the latent
    cache against the reference's after each (written in place: the
    cache the port returns is the one it was given)."""
    jm, params, jb, pm, tp = _setup(dtype, absorb)
    if dtype == "bfloat16":                               # C.21
        jm = ref_build(_cfgs()[0], dtype=jnp.bfloat16)
    B, L = jb["tokens"].shape
    tokens = _torch(jb)["tokens"]
    P = 10
    tol = 1e-5 if dtype == "float32" else 0.05
    jcache = jm.init_cache(B, L)
    jlast, jcache = jm.prefill(params, {"tokens": jb["tokens"][:, :P]},
                               jcache)
    cache = pm.init_cache(B, L, "cpu")
    latent = cache["latent"]
    assert tuple(latent.shape) == jcache["latent"].shape == (
        pm.cfg.n_layers, B, L,
        pm.cfg.mla.kv_lora_rank + pm.cfg.mla.qk_rope_head_dim)
    last, cache = pm.prefill(tp, {"tokens": tokens[:, :P]}, cache)
    assert cache["latent"] is latent and sorted(cache) == ["latent"]
    _close(last, jlast, tol)
    _close(cache["latent"], jcache["latent"], tol)
    decode = jax.jit(jm.decode)
    for i in range(4):
        dec, cache = pm.decode(tp, tokens[:, P + i:P + i + 1], cache, P + i)
        jdec, jcache = decode(params, jb["tokens"][:, P + i:P + i + 1],
                              jcache, jnp.int32(P + i))
        _close(dec, jdec, tol)
        _close(cache["latent"], jcache["latent"], tol)
    assert not cache["latent"][:, :, P + 4:].any()


def test_train_step():
    ref_cfg, cfg = _cfgs()
    m = build_model(cfg)
    state = init_train_state(m, 0, "cpu")
    before = state.opt.master["layers"]["attn"]["wkv_b"].clone()
    batch = _torch(ref_make_batch(ref_cfg, 2, 16))
    _, metrics = make_train_step(m, AdamConfig(warmup_steps=1))(state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert not torch.equal(state.opt.master["layers"]["attn"]["wkv_b"],
                           before)
    assert all(bool(torch.isfinite(t).all())
               for _, t in flatten(state.opt.master))


def test_serve_decode_on_the_cpu():
    seq = serve_decode.main(["--arch", "minicpm3_4b", "--reduced",
                             "--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--new-tokens", "4"])
    assert seq.shape == (2, 4) and seq.dtype == torch.int32


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
@pytest.mark.parametrize("absorb", [False, True])
def test_mla_decode_on_card(absorb):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, cfg = _cfgs(absorb)
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
