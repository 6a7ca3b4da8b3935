"""The port's dense transformer, loss and Adam step against the
reference's, with the reference's weights carried across
(``repro_torch.convert``) and the same token batch.

Tolerances, and why:
  * fp32 compute (``dtype=float32`` on both sides): the math is the same,
    only the order of float32 sums differs (XLA's CPU dots vs PyTorch's)
    — logits within 1e-5 absolute, the loss within 1e-6 relative.
  * bf16 compute: every matmul output is rounded to bf16 (8 bits of
    mantissa) and the two libraries round at different points of the
    accumulation, so one-ulp differences (0.4 %) compound over the
    layers — logits within 0.05 absolute, the loss within 1e-3 relative.
  * one Adam step (fp32 compute, bf16 params and grads): a gradient
    element may round to the neighbouring bf16 value on one side, which
    moves that element's m by 0.1·ulp and v by 0.05·(g²)'s ulp; the
    update m/(sqrt(v)+eps) is ±1-sized at step 1, so where a gradient is
    near zero its direction can differ: m, v within 2 % relative (+1e-9
    absolute); master within 2·lr everywhere and within 1e-6 for all but
    0.1 % of the elements; the bf16 params within one bf16 ulp plus the
    master's 2·lr of each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data.pipeline import DataConfig as RefData
from repro.data.pipeline import TokenStream as RefStream
from repro.models.registry import build_model as ref_build
from repro.optim.adam import AdamConfig as RefAdam
from repro.train.steps import init_train_state as ref_init_state
from repro.train.steps import make_train_step as ref_make_step
from repro_torch import configs as pconfigs
from repro_torch.convert import to_numpy, train_state_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.steps import TrainState, make_train_step
from repro_torch.tree import flatten

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256)


def _cfgs(**kw):
    kw = {**TINY, **kw}
    ref = dataclasses.replace(
        rconfigs.reduced(rconfigs.get_config("stablelm_1_6b")), **kw)
    port = dataclasses.replace(
        pconfigs.reduced(pconfigs.get_config("stablelm_1_6b")), **kw)
    return ref, port


def _batch(vocab, batch=2, seq=16, index=0):
    b = RefStream(RefData(vocab, seq, batch, seed=0)).peek(index)
    return b, {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(a):
    a = np.asarray(a)
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


@pytest.mark.parametrize("kw", [{}, {"n_kv_heads": 4}, {"qkv_bias": True},
                                {"tie_embeddings": True}])
def test_forward_fp32_matches_reference(kw):
    ref_cfg, cfg = _cfgs(**kw)
    jm = ref_build(ref_cfg, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    jb, tb = _batch(cfg.vocab_size)
    jl, _ = jm.forward(params, jb)
    pm = build_model(cfg, dtype=torch.float32)
    tparams = train_state_from_numpy(_np(params), device="cpu")
    tl, aux = pm.forward(tparams, tb)
    assert tl.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)
    jloss = float(jm.loss(params, jb))
    tloss = float(pm.loss(tparams, tb))
    assert tloss == pytest.approx(jloss, rel=1e-6)


def test_forward_bf16_matches_reference():
    ref_cfg, cfg = _cfgs()
    jm = ref_build(ref_cfg)                      # bf16 compute
    params = jax.tree.map(lambda p: p.astype(jnp.bfloat16),
                          jm.init(jax.random.PRNGKey(1)))
    jb, tb = _batch(cfg.vocab_size)
    pm = build_model(cfg)
    tparams = train_state_from_numpy(_np(params), device="cpu")
    assert all(t.dtype == torch.bfloat16 for _, t in flatten(tparams))
    jl, _ = jm.forward(params, jb)
    tl, _ = pm.forward(tparams, tb)
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl, np.float32), atol=0.05,
                               rtol=0)
    assert float(pm.loss(tparams, tb)) == pytest.approx(
        float(jm.loss(params, jb)), rel=1e-3)


@pytest.mark.parametrize("gas", [1, 2])
def test_train_step_matches_reference(gas):
    ref_cfg, cfg = _cfgs()
    jm = ref_build(ref_cfg, dtype=jnp.float32)
    state = ref_init_state(jm, jax.random.PRNGKey(2))
    np_state = _np(state)
    jb, tb = _batch(cfg.vocab_size, batch=4)
    opt = dict(lr=1e-2, warmup_steps=1)          # a step that moves weights
    new_state, jmet = jax.jit(ref_make_step(jm, RefAdam(**opt), gas))(
        state, jb)
    pstate = train_state_from_numpy(np_state, device="cpu")
    assert isinstance(pstate, TrainState)
    pm = build_model(cfg, dtype=torch.float32)
    out, pmet = make_train_step(pm, AdamConfig(**opt), gas)(pstate, tb)
    assert out is pstate                         # updated in place
    assert float(pmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                rel=1e-6)
    assert int(out.opt.step) == int(new_state.opt.step) == 1
    got, want = to_numpy(out), _np(new_state)
    for field, tol in (("master", dict(atol=2 * opt["lr"], rtol=0)),
                       ("m", dict(atol=1e-9, rtol=2e-2)),
                       ("v", dict(atol=1e-9, rtol=2e-2))):
        for (name, g), (_, w) in zip(flatten(getattr(got.opt, field)),
                                     flatten(getattr(want.opt, field))):
            np.testing.assert_allclose(g, w, err_msg=f"{field}/{name}",
                                       **tol)
            if field == "master":
                assert (np.abs(g - w) > 1e-6).mean() < 1e-3, name
    for (name, g), (_, w) in zip(flatten(got.params), flatten(want.params)):
        g, w = _f32(g), _f32(w)
        bad = np.abs(g - w) > (np.maximum(np.abs(g), np.abs(w))
                               * 2.0 ** -7 + 2 * opt["lr"])
        assert not bad.any(), (name, g[bad][:5], w[bad][:5])
    before = flatten(_np(state.params))
    assert any((_f32(g) != _f32(b)).any() for (_, g), (_, b)
               in zip(flatten(got.params), before))
