"""The port's MoE layer (``moe_init``, ``moe_route``, ``moe_apply`` in both
implementations) against the reference's ``repro.models.layers.moe_apply``
on the reference's weights and the same inputs (made with numpy from a
seed), and one Adam step of the reduced GPT-3-1.8B-MoE against the
reference's. The port is never held against ``moe_ep`` (ROADMAP C.1).

Tolerances, and why:
  * f32 layer output within 1e-5 absolute and the aux loss within 1e-6
    relative: the same math, f32 sums in another order; routing is equal
    exactly (asserted), since the router's f32 logits differ by far less
    than any gap between two experts' probabilities in these inputs.
  * bf16 layer output within 0.05 absolute (both round every product to
    bf16, at different points), routing equal exactly.
  * ties and drops: equal routing and drops, outputs as in f32.
  * the Adam step: as tests/test_torch_model.py (m, v within 2 %
    relative; master within 2·lr; bf16 params within one ulp + 2·lr).
  * gradients: every leaf's f32 gradient within 1e-5 absolute + 1e-4
    relative of ``jax.grad``'s (the gate values are differentiable
    through the top-k on both sides)."""
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
from repro.optim.adam import AdamConfig as RefAdam
from repro.train.steps import init_train_state as ref_init_state
from repro.train.steps import make_train_step as ref_make_step
from repro_torch import configs as pconfigs
from repro_torch.convert import to_numpy, train_state_from_numpy
from repro_torch.models import layers as ly
from repro_torch.models.registry import build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.steps import make_train_step
from repro_torch.tree import flatten
from test_torch_model import _f32

KEYS = {"gpt3_1_8b_moe": "paper", "qwen3_moe_235b": "arch",
        "arctic_480b": "arch"}


def _cfgs(key, **moe):
    """(reference, port) reduced MoE configs; ``moe`` replaces MoEConfig
    fields on both."""
    get = {"paper": (rconfigs.get_paper_config, pconfigs.get_paper_config),
           "arch": (rconfigs.get_config, pconfigs.get_config)}[KEYS[key]]
    ref = rconfigs.reduced(get[0](key))
    port = pconfigs.reduced(get[1](key))
    return (dataclasses.replace(ref, moe=dataclasses.replace(ref.moe, **moe)),
            dataclasses.replace(port, moe=dataclasses.replace(port.moe,
                                                              **moe)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _layer(ref_cfg, seed=0, B=2, L=16, dtype=np.float32, positive=False):
    """The reference's MoE parameters and an input x, as numpy."""
    p = _np(ref_layers.moe_init(jax.random.PRNGKey(seed), ref_cfg))
    x = np.random.default_rng(seed).standard_normal(
        (B, L, ref_cfg.d_model)).astype(np.float32)
    return p, (np.abs(x) if positive else x).astype(dtype)


def _both(ref_cfg, cfg, p, x, *, impl="einsum", n_groups=1,
          capacity_factor=None, jdt=jnp.float32, tdt=torch.float32):
    jp = jax.tree.map(jnp.asarray, p)
    jout, jaux = ref_layers.moe_apply(
        jp, jnp.asarray(x, jdt), ref_cfg, n_groups=n_groups,
        capacity_factor=capacity_factor, impl=impl)
    tp = train_state_from_numpy(p, device="cpu")
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(tdt)
    tout, taux = ly.moe_apply(tp, tx, cfg, n_groups=n_groups,
                              capacity_factor=capacity_factor, impl=impl)
    assert tout.dtype == tdt and tout.shape == x.shape
    return (np.asarray(jout, np.float32), float(jaux),
            tout.float().numpy(), float(taux), tp, tx)


def _ref_route(ref_cfg, p, x, n_groups=1):
    """lax.top_k of the reference's router on the same grouping."""
    B, L, D = x.shape
    G = min(n_groups, B) if B * L % min(n_groups, B * L) == 0 else 1
    xt = jnp.asarray(x, jnp.float32).reshape(max(G, 1), -1, D)
    probs = jax.nn.softmax(xt @ jnp.asarray(p["router"], jnp.float32), -1)
    return np.asarray(jax.lax.top_k(probs, ref_cfg.moe.top_k)[1])


@pytest.mark.parametrize("n_groups", [1, 2, 3])
@pytest.mark.parametrize("impl", ["einsum", "sorted"])
@pytest.mark.parametrize("key", list(KEYS))
def test_moe_apply_matches_reference(key, impl, n_groups):
    """top-1 (gpt3_1_8b_moe), top-2 (qwen3_moe_235b) and the dense
    residual branch (arctic_480b); 3 groups of 32 tokens is not a divisor
    of the tokens, so both fall back to one group."""
    ref_cfg, cfg = _cfgs(key)
    p, x = _layer(ref_cfg)
    jout, jaux, tout, taux, tp, tx = _both(ref_cfg, cfg, p, x, impl=impl,
                                           n_groups=n_groups)
    r = ly.moe_route(tp, tx, cfg, n_groups=n_groups)
    np.testing.assert_array_equal(r.gate_i.numpy(),
                                  _ref_route(ref_cfg, p, x, n_groups))
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=0)
    assert taux > 0 and taux == pytest.approx(jaux, rel=1e-6)


@pytest.mark.parametrize("impl", ["einsum", "sorted"])
def test_moe_apply_bf16_matches_reference(impl):
    ref_cfg, cfg = _cfgs("qwen3_moe_235b")
    p, x = _layer(ref_cfg, seed=1)
    x = x.astype(jnp.bfloat16).astype(np.float32)     # bf16-exact input
    p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), p)
    jout, jaux, tout, taux, tp, tx = _both(ref_cfg, cfg, p, x, impl=impl,
                                           jdt=jnp.bfloat16,
                                           tdt=torch.bfloat16)
    np.testing.assert_allclose(tout, jout, atol=0.05, rtol=0)
    assert taux == pytest.approx(jaux, rel=1e-6)


@pytest.mark.parametrize("impl", ["einsum", "sorted"])
def test_ties_route_to_the_lower_index(impl):
    """Experts 2 and 3 share one router column, which wins every token:
    both packages route every token to expert 2 first (``lax.top_k``'s
    order on ties), and with top 2 to expert 3 second."""
    ref_cfg, cfg = _cfgs("qwen3_moe_235b", capacity_factor=4.0)
    p, x = _layer(ref_cfg, seed=2, positive=True)
    router = np.zeros_like(p["router"])
    router[:, 2] = router[:, 3] = np.abs(p["router"][:, 2]) + 0.1
    p["router"] = router
    jout, jaux, tout, taux, tp, tx = _both(ref_cfg, cfg, p, x, impl=impl)
    r = ly.moe_route(tp, tx, cfg)
    want = _ref_route(ref_cfg, p, x)
    assert (want[..., 0] == 2).all() and (want[..., 1] == 3).all()
    np.testing.assert_array_equal(r.gate_i.numpy(), want)
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=0)
    assert taux == pytest.approx(jaux, rel=1e-6)


@pytest.mark.parametrize("impl", ["einsum", "sorted"])
@pytest.mark.parametrize("key", ["gpt3_1_8b_moe", "qwen3_moe_235b"])
def test_capacity_drops_agree(key, impl):
    """More tokens than capacity (capacity factor 0.5): the same tokens
    are dropped (einsum: by arrival order; sorted: by token index within
    an expert), so the outputs agree, dropped rows included."""
    ref_cfg, cfg = _cfgs(key, capacity_factor=0.5)
    p, x = _layer(ref_cfg, seed=3)
    jout, jaux, tout, taux, tp, tx = _both(ref_cfg, cfg, p, x, impl=impl)
    r = ly.moe_route(tp, tx, cfg)
    counts = np.bincount(r.gate_i.numpy().ravel(),
                         minlength=cfg.moe.n_experts)
    assert r.C == int(32 * cfg.moe.top_k / cfg.moe.n_experts * 0.5)
    assert (counts > r.C).any()                  # some (token, k) dropped
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=0)
    assert taux == pytest.approx(jaux, rel=1e-6)
    if cfg.moe.top_k == 1:                       # a dropped token gives 0
        assert (np.abs(tout).max(-1) == 0).sum() == (counts - r.C).clip(
            0).sum()


def test_moe_groups_through_build_model():
    """``build_model(moe_groups=2)`` routes each half of the batch on its
    own (capacity per group) in the forward, the loss and the decode
    path, as the reference's does; with drops that is another function
    than one group."""
    ref_cfg, cfg = _cfgs("gpt3_1_8b_moe")
    jb = ref_make_batch(ref_cfg, 4, 16)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    params = ref_build(ref_cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(6))
    tp = train_state_from_numpy(_np(params), device="cpu")
    got = {}
    for groups in (1, 2):
        jm = ref_build(ref_cfg, dtype=jnp.float32, moe_groups=groups)
        pm = build_model(cfg, dtype=torch.float32, moe_groups=groups)
        jl, jaux = jm.forward(params, jb)
        tl, taux = pm.forward(tp, tb)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=0)
        assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
        assert float(pm.loss(tp, tb)) == pytest.approx(
            float(jm.loss(params, jb)), rel=1e-6)
        jc = jm.init_cache(4, 20)
        jlast, _ = jm.prefill(params, {"tokens": jb["tokens"]}, jc)
        last, _ = pm.prefill(tp, {"tokens": tb["tokens"]},
                             pm.init_cache(4, 20, "cpu"))
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                                   atol=1e-5, rtol=0)
        got[groups] = tl
    assert not torch.allclose(got[1], got[2], atol=1e-3)


def test_gradients_match_reference():
    """The reduced MoE's loss gradient, leaf by leaf, in f32, against
    ``jax.grad`` (router included: the gates carry it)."""
    ref_cfg, cfg = _cfgs("gpt3_1_8b_moe")
    jm = ref_build(ref_cfg, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(5))
    jb = ref_make_batch(ref_cfg, 2, 16)
    jg = _np(jax.grad(jm.loss)(params, jb))
    tp = train_state_from_numpy(_np(params), device="cpu")
    leaves = [t.requires_grad_(True) for _, t in flatten(tp)]
    pm = build_model(cfg, dtype=torch.float32)
    loss = pm.loss(tp, {k: torch.from_numpy(np.array(v))
                        for k, v in jb.items()})
    grads = torch.autograd.grad(loss, leaves)
    for (name, want), got in zip(flatten(jg), grads):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    router = dict(zip([n for n, _ in flatten(tp)], grads))[
        "layers/mlp/router"]
    assert float(router.abs().max()) > 0


def test_adam_step_matches_reference():
    """One train step (f32 compute; bf16 params, f32 Adam state) of the
    reduced MoE against the reference's."""
    ref_cfg, cfg = _cfgs("gpt3_1_8b_moe")
    jm = ref_build(ref_cfg, dtype=jnp.float32)
    state = ref_init_state(jm, jax.random.PRNGKey(2))
    np_state = _np(state)
    jb = ref_make_batch(ref_cfg, 4, 16)
    opt = dict(lr=1e-2, warmup_steps=1)
    new_state, jmet = jax.jit(ref_make_step(jm, RefAdam(**opt)))(state, jb)
    pstate = train_state_from_numpy(np_state, device="cpu")
    pm = build_model(cfg, dtype=torch.float32)
    out, pmet = make_train_step(pm, AdamConfig(**opt))(
        pstate, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()})
    assert float(pmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                rel=1e-6)
    got, want = to_numpy(out), _np(new_state)
    for field, tol in (("master", dict(atol=2 * opt["lr"], rtol=0)),
                       ("m", dict(atol=1e-9, rtol=2e-2)),
                       ("v", dict(atol=1e-9, rtol=2e-2))):
        for (name, g), (_, w) in zip(flatten(getattr(got.opt, field)),
                                     flatten(getattr(want.opt, field))):
            np.testing.assert_allclose(g, w, err_msg=f"{field}/{name}",
                                       **tol)
    for (name, g), (_, w) in zip(flatten(got.params), flatten(want.params)):
        g, w = _f32(g), _f32(w)
        bad = np.abs(g - w) > (np.maximum(np.abs(g), np.abs(w))
                               * 2.0 ** -7 + 2 * opt["lr"])
        assert not bad.any(), (name, g[bad][:5], w[bad][:5])
    names = [n for n, _ in flatten(got.params)]
    assert "layers/mlp/router" in names and "layers/mlp/wg" in names


def test_moe_init_tree_matches_reference():
    """The port's init gives the reference's tree: names, shapes, f32."""
    ref_cfg, cfg = _cfgs("arctic_480b")
    want = flatten(_np(ref_build(ref_cfg).init(jax.random.PRNGKey(0))))
    got = flatten(build_model(cfg).init(0, "cpu"))
    assert [(n, tuple(t.shape), str(t.dtype)) for n, t in got] == [
        (n, a.shape, "torch.float32") for n, a in want]
