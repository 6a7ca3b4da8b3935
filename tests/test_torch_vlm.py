"""The port's vlm family (``internvl2_26b``: the dense transformer with the
stubbed vision frontend's patch embeddings projected through
``vis_proj`` and attended causally before the text) against the JAX
package, on the reference's weights carried across
(``repro_torch.convert``), its ``make_batch`` tokens and random patch
embeddings from a numpy seed, with ``reduced(internvl2_26b)`` (2 layers,
d_model 256, 4/1 heads of 64, 16 patch tokens).

Tolerances, and why:
  * the forward, f32 compute: logits within 1e-4, the loss (over the
    text, the prefix's logits dropped) within 1e-6 relative (the same
    math, f32 sums in another order); bf16: logits within 0.05, the loss
    within 1e-3 relative (both round every product to bf16, at different
    points), as tests/test_torch_model.py.
  * ``use_kernels`` (B3's plain version on the CPU) against the unhooked
    forward: 1e-5 (f32; the plain kernel and ``ly.attention`` sum in
    another order), and against the reference's ``use_pallas``: 1e-3, as
    tests/test_use_pallas.py.
  * decode against the forward: 2e-3, as tests/test_archs.py; the port's
    decode logits and cache against the reference's: 1e-5 (f32).

The test marked ``gpu`` runs the kernel path on the card and skips
without one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models.registry import build_model as ref_build
from repro.models.registry import make_batch as ref_make_batch
from repro_torch import configs as pconfigs
from repro_torch.convert import train_state_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.models.registry import build_model, make_batch
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.tree import flatten

KEY = "internvl2_26b"


def _cfgs():
    return (rconfigs.reduced(rconfigs.get_config(KEY)),
            pconfigs.reduced(pconfigs.get_config(KEY)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(batch):
    return {k: torch.from_numpy(np.array(v, np.float32)
                                if v.dtype == jnp.bfloat16 else np.array(v))
            for k, v in batch.items()}


def _setup(dtype="float32", B=2, L=16, seed=0):
    """(reference model, its params, its batch with random patch
    embeddings, the port's model, the params carried across)."""
    ref_cfg, cfg = _cfgs()
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = ref_build(ref_cfg, dtype=jdt)
    params = jax.tree.map(lambda a: a.astype(jdt),
                          jm.init(jax.random.PRNGKey(seed)))
    jb = ref_make_batch(ref_cfg, B, L)
    rng = np.random.default_rng(seed)
    jb["patch_embeds"] = jnp.asarray(rng.standard_normal(
        jb["patch_embeds"].shape).astype(np.float32))
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
    assert ("vis_proj", (cfg.d_model, cfg.d_model)) in \
        [(n, tuple(t.shape)) for n, t in got]


def test_make_batch_matches_reference():
    """The token and label ids equal the reference's draws from the same
    seed, the patch embeddings its constant 0.01 in the given dtype."""
    ref_cfg, cfg = _cfgs()
    for seed in (0, 3):
        want = ref_make_batch(ref_cfg, 2, 12, jax.random.PRNGKey(seed))
        got = make_batch(cfg, 2, 12, seed=seed, device="cpu")
        assert sorted(got) == sorted(want)
        for name in ("tokens", "labels"):
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
        assert got["patch_embeds"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got["patch_embeds"].float().numpy(),
            np.asarray(want["patch_embeds"], np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    """Logits over the prefix and the text, and the loss over the text."""
    jm, params, jb, pm, tp = _setup(dtype, seed=1)
    jl, _ = jm.forward(params, jb)
    tl, aux = pm.forward(tp, _torch(jb))
    n_prefix = pm.cfg.n_frontend_tokens
    assert tl.shape == (2, n_prefix + 16, pm.cfg.vocab_size)
    assert float(aux) == 0.0
    _close(tl, jl, 1e-4 if dtype == "float32" else 0.05)
    assert float(pm.loss(tp, _torch(jb))) == pytest.approx(
        float(jm.loss(params, jb)), rel=1e-6 if dtype == "float32" else 1e-3)


def test_loss_drops_the_prefix():
    """The loss is the CE of the text positions alone: the first
    ``n_prefix`` logits are dropped, as the reference's loss drops them."""
    from repro_torch.models.registry import cross_entropy
    _, _, jb, pm, tp = _setup()
    batch = _torch(jb)
    logits, _ = pm.forward(tp, batch)
    n_prefix = batch["patch_embeds"].shape[1]
    want = cross_entropy(logits[:, n_prefix:], batch["labels"])
    assert float(pm.loss(tp, batch)) == pytest.approx(float(want), rel=1e-6)
    assert float(pm.loss(tp, batch)) != pytest.approx(
        float(cross_entropy(logits[:, :16], batch["labels"])), rel=1e-3)


def test_vis_proj_reaches_the_logits():
    """Other patch embeddings change the text's logits (the prefix is
    attended), and a batch without them is the text alone."""
    _, _, jb, pm, tp = _setup()
    batch = _torch(jb)
    a, _ = pm.forward(tp, batch)
    b, _ = pm.forward(tp, {**batch, "patch_embeds":
                           batch["patch_embeds"] * 2})
    n_prefix = pm.cfg.n_frontend_tokens
    assert float((a[:, n_prefix:] - b[:, n_prefix:]).abs().max()) > 1e-3
    text, _ = pm.forward(tp, {"tokens": batch["tokens"]})
    assert text.shape[1] == batch["tokens"].shape[1]


def test_use_kernels_matches_forward_and_reference_use_pallas():
    """The kernel path (B3's plain version on the CPU) reaches every
    layer and matches the unhooked forward and the reference's Pallas
    path (interpret mode) on the reference's weights."""
    ref_cfg, cfg = _cfgs()
    jb = ref_make_batch(ref_cfg, 1, 48)
    rng = np.random.default_rng(2)
    jb["patch_embeds"] = jnp.asarray(rng.standard_normal(
        jb["patch_embeds"].shape).astype(np.float32))
    jm = ref_build(ref_cfg, dtype=jnp.float32, use_pallas=True)
    params = jm.init(jax.random.PRNGKey(0))
    jl, _ = jax.jit(jm.forward)(params, jb)
    tp = train_state_from_numpy(_np(params), device="cpu")
    n = ops.flash_attention.launches
    tl, _ = build_model(cfg, dtype=torch.float32,
                        use_kernels=True).forward(tp, _torch(jb))
    assert ops.flash_attention.launches == n        # CPU: the plain version
    want, _ = build_model(cfg, dtype=torch.float32).forward(tp, _torch(jb))
    torch.testing.assert_close(tl, want, atol=1e-5, rtol=0)
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < 1e-3
    seen = []

    def spy(q, k, v, cap=None):
        seen.append((tuple(q.shape), tuple(k.shape)))
        return ops.flash_attention(q, k, v, causal=True, cap=cap)
    transformer.forward(tp, cfg, _torch(jb), dtype=torch.float32,
                        attn_kernel=spy)
    L = cfg.n_frontend_tokens + 48
    assert seen == [((1, cfg.n_heads, L, 64), (1, cfg.n_kv_heads, L, 64))] \
        * cfg.n_layers


def test_decode_matches_forward_and_reference():
    """tests/test_archs.py::test_decode_matches_forward on the port:
    prefill the prefix and L-1 tokens into a cache of prefix + L + 4,
    decode the last token at position prefix + L - 1; the logits against
    the forward's last and against the reference's decode, the cache
    against the reference's."""
    jm, params, jb, pm, tp = _setup()
    batch = _torch(jb)
    B, L = batch["tokens"].shape
    npfx = pm.cfg.n_frontend_tokens
    full, _ = pm.forward(tp, batch)
    pre = {**batch, "tokens": batch["tokens"][:, :L - 1]}
    pre.pop("labels")
    cache = pm.init_cache(B, npfx + L + 4, "cpu")
    k_buf = cache["k"]
    last, cache = pm.prefill(tp, pre, cache)
    assert cache["k"] is k_buf                    # written in place
    dec, cache = pm.decode(tp, batch["tokens"][:, L - 1:], cache,
                           npfx + L - 1)
    assert float((last[:, 0] - full[:, npfx + L - 2]).abs().max()) < 2e-3
    assert float((dec[:, 0] - full[:, -1]).abs().max()) < 2e-3

    jpre = {k: v for k, v in jb.items() if k != "labels"}
    jpre["tokens"] = jb["tokens"][:, :L - 1]
    jcache = jm.init_cache(B, npfx + L + 4)
    jlast, jcache = jm.prefill(params, jpre, jcache)
    jdec, jcache = jm.decode(params, jb["tokens"][:, L - 1:], jcache,
                             jnp.int32(npfx + L - 1))
    for got, want in ((last, jlast), (dec, jdec), (cache["k"], jcache["k"]),
                      (cache["v"], jcache["v"])):
        _close(got, want, 1e-5)
    assert not cache["k"][:, :, npfx + L:].any()


def test_train_step_has_finite_gradients():
    """One step of the port's train step on ``make_batch``: finite
    gradients (``vis_proj`` among them), finite loss, and the master
    weights moved."""
    _, cfg = _cfgs()
    m = build_model(cfg)
    state = init_train_state(m, 0, "cpu")
    batch = make_batch(cfg, 2, 16, device="cpu")
    ps = flatten(state.params)
    for _, p in ps:
        p.requires_grad_(True)
    grads = dict(zip([n for n, _ in ps], torch.autograd.grad(
        m.loss(state.params, batch), [p for _, p in ps])))
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads.values())
    assert float(grads["vis_proj"].float().abs().max()) > 0
    for _, p in ps:
        p.requires_grad_(False)
    before = state.opt.master["vis_proj"].clone()
    _, metrics = make_train_step(m, AdamConfig(warmup_steps=1))(state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert not torch.equal(state.opt.master["vis_proj"], before)


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_use_kernels_matches_plain_on_card():
    """B3 at the reduced config's GQA 4:1 over a 16-token prefix + 64
    tokens: the bf16 loss through the kernel against the plain forward's
    (1e-3 relative), one launch per layer, and the f32 logits (1e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, cfg = _cfgs()
    params = build_model(cfg).init(0, "cuda")
    batch = make_batch(cfg, 2, 64, device="cuda")
    batch["patch_embeds"] = torch.randn(
        batch["patch_embeds"].shape, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    n = ops.flash_attention.launches
    got = build_model(cfg, use_kernels=True).loss(params, batch)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches - n == cfg.n_layers
    want = build_model(cfg).loss(params, batch)
    assert float(got) == pytest.approx(float(want), rel=1e-3)
    f32, _ = build_model(cfg, dtype=torch.float32,
                         use_kernels=True).forward(params, batch)
    plain, _ = build_model(cfg, dtype=torch.float32).forward(params, batch)
    torch.testing.assert_close(f32, plain, atol=1e-3, rtol=0)
