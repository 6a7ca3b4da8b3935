"""The port's encdec family (``whisper_small``: the Whisper-style
encoder-decoder with the stubbed audio frontend) against the JAX
package, on the reference's weights carried across
(``repro_torch.convert``), its ``make_batch`` tokens and random audio
frames from a numpy seed, with ``reduced(whisper_small)`` (2 + 2 layers,
d_model 256, 4 heads of 64, 32 frames).

Tolerances, and why:
  * the sinusoid: 1e-5 at 32 frames, 5e-4 at Whisper's 1500 (f32 angles
    up to 1500 rad, where one ulp of the angle is 1.2e-4; both sides
    compute them in f32 with their own exp and sin).
  * the encoder output and the forward, f32 compute: 1e-4, the loss
    within 1e-6 relative (the same math, f32 sums in another order);
    bf16: logits within 0.05, the loss within 1e-3 relative, as
    tests/test_torch_model.py.
  * decode against the forward over the same tokens: 2e-3, as
    tests/test_archs.py; the port's decode logits and cache (k, v and
    the encoder output) against the reference's: 1e-5 in f32, 0.05 in
    bf16.

The test marked ``gpu`` runs the model on the card and skips without
one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import encdec as ref_encdec
from repro.models.registry import build_model as ref_build
from repro.models.registry import make_batch as ref_make_batch
from repro_torch import configs as pconfigs
from repro_torch.convert import train_state_from_numpy
from repro_torch.models import encdec
from repro_torch.models.registry import build_model, make_batch
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.tree import flatten

KEY = "whisper_small"


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
    """(reference model, its params, its batch with random audio frames,
    the port's model, the params carried across)."""
    ref_cfg, cfg = _cfgs()
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = ref_build(ref_cfg, dtype=jdt)
    params = jax.tree.map(lambda a: a.astype(jdt),
                          jm.init(jax.random.PRNGKey(seed)))
    jb = ref_make_batch(ref_cfg, B, L)
    rng = np.random.default_rng(seed)
    jb["audio_frames"] = jnp.asarray(rng.standard_normal(
        jb["audio_frames"].shape).astype(np.float32))
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
    names = {n for n, _ in got}
    assert {"enc_norm", "enc_layers/attn/wq", "dec_layers/cross_attn/wq",
            "dec_layers/ln_x", "dec_layers/self_attn/wo"} <= names


def test_make_batch_matches_reference():
    ref_cfg, cfg = _cfgs()
    want = ref_make_batch(ref_cfg, 2, 12)
    got = make_batch(cfg, 2, 12, device="cpu")
    assert sorted(got) == sorted(want)
    for name in ("tokens", "labels"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    assert got["audio_frames"].shape == (2, cfg.n_enc_ctx, cfg.d_model)
    np.testing.assert_array_equal(got["audio_frames"].float().numpy(),
                                  np.asarray(want["audio_frames"], np.float32))


@pytest.mark.parametrize("n,d,tol", [(32, 256, 1e-5), (1500, 768, 5e-4)])
def test_sinusoid_matches_reference(n, d, tol):
    """f32 angles, the sin half then the cos half, cast last."""
    got = encdec._sinusoid(n, d, torch.float32, "cpu")
    want = ref_encdec._sinusoid(n, d, jnp.float32)
    _close(got, want, tol)
    half = d // 2
    np.testing.assert_allclose(got[:, :half].numpy() ** 2
                               + got[:, half:].numpy() ** 2, 1.0, atol=1e-5)
    bf = encdec._sinusoid(n, d, torch.bfloat16, "cpu")
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf, got.to(torch.bfloat16), atol=0, rtol=0)


def test_encoder_matches_reference():
    """Non-causal self-attention without RoPE, then ``enc_norm``."""
    jm, params, jb, pm, tp = _setup(seed=2)
    want = ref_encdec.encode(params, jm.cfg, jb["audio_frames"])
    got = encdec.encode(tp, pm.cfg, _torch(jb)["audio_frames"])
    _close(got, want, 1e-4)
    # non-causal: the first frame's output depends on the last frame
    frames = _torch(jb)["audio_frames"].clone()
    frames[:, -1] += 1.0
    moved = encdec.encode(tp, pm.cfg, frames)
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    jm, params, jb, pm, tp = _setup(dtype, seed=1)
    jl, _ = jm.forward(params, jb)
    tl, aux = pm.forward(tp, _torch(jb))
    assert tl.shape == (2, 16, pm.cfg.vocab_size)
    assert tl.dtype == (torch.float32 if dtype == "float32"
                        else torch.bfloat16)
    assert float(aux) == 0.0 and aux.dtype == torch.float32
    _close(tl, jl, 1e-4 if dtype == "float32" else 0.05)
    assert float(pm.loss(tp, _torch(jb))) == pytest.approx(
        float(jm.loss(params, jb)), rel=1e-6 if dtype == "float32" else 1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_forward_and_reference(dtype):
    """Prefill of the frames and 10 tokens, then 5 decode steps one after
    the other: each step's logits against the forward at its position
    (f32) and against the reference's decode, and the cache (k, v and
    the encoder output) against the reference's after each step."""
    jm, params, jb, pm, tp = _setup(dtype)
    batch = _torch(jb)
    B, L = batch["tokens"].shape
    P = 10
    full, _ = pm.forward(tp, batch)
    tol = 1e-5 if dtype == "float32" else 0.05
    jcache = jm.init_cache(B, L + 2)
    jlast, jcache = jm.prefill(params, {"tokens": jb["tokens"][:, :P],
                                        "audio_frames": jb["audio_frames"]},
                               jcache)
    cache = pm.init_cache(B, L + 2, "cpu")
    assert cache["enc_out"].shape == (B, pm.cfg.n_enc_ctx, pm.cfg.d_model)
    k_buf = cache["k"]
    last, cache = pm.prefill(tp, {"tokens": batch["tokens"][:, :P],
                                  "audio_frames": batch["audio_frames"]},
                             cache)
    assert cache["k"] is k_buf                    # written in place
    _close(last, jlast, tol)

    def same_cache():
        for name in ("k", "v", "enc_out"):
            assert tuple(cache[name].shape) == jcache[name].shape
            assert cache[name].dtype == tp["embed"].dtype
            _close(cache[name], jcache[name], tol)

    same_cache()
    if dtype == "float32":
        assert float((last[:, 0] - full[:, P - 1]).abs().max()) < 2e-3
    decode = jax.jit(jm.decode)
    for i in range(5):
        dec, cache = pm.decode(tp, batch["tokens"][:, P + i:P + i + 1],
                               cache, P + i)
        jdec, jcache = decode(params, jb["tokens"][:, P + i:P + i + 1],
                              jcache, jnp.int32(P + i))
        if dtype == "float32":
            assert float((dec[:, 0] - full[:, P + i]).abs().max()) < 2e-3
        _close(dec, jdec, tol)
        same_cache()
    assert not cache["k"][:, :, P + 5:].any()


def test_train_step_has_finite_gradients():
    """One step of the port's train step on ``make_batch``: finite
    gradients (the encoder's and the cross-attention's among them),
    finite loss, and the master weights moved."""
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
    for name in ("enc_layers/attn/wq", "dec_layers/cross_attn/wk"):
        assert float(grads[name].float().abs().max()) > 0, name
    for _, p in ps:
        p.requires_grad_(False)
    before = state.opt.master["enc_layers"]["mlp"]["wi"].clone()
    _, metrics = make_train_step(m, AdamConfig(warmup_steps=1))(state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert not torch.equal(state.opt.master["enc_layers"]["mlp"]["wi"],
                           before)


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_decode_on_card():
    """The reduced model on the card: its f32 forward against the same
    weights' forward on the CPU (1e-4), and a prefill + 8 decode steps
    against the forward (2e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, cfg = _cfgs()
    pm = build_model(cfg, dtype=torch.float32)
    params = pm.init(0, "cuda")
    batch = make_batch(cfg, 2, 24, device="cuda")
    batch["audio_frames"] = torch.randn(
        batch["audio_frames"].shape, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    full, _ = pm.forward(params, batch)
    cpu, _ = pm.forward(_to_cpu(params), _to_cpu(batch))
    torch.testing.assert_close(full.cpu(), cpu, atol=1e-4, rtol=0)
    cache = pm.init_cache(2, 24, "cuda")
    last, cache = pm.prefill(params, {"tokens": batch["tokens"][:, :16],
                                      "audio_frames": batch["audio_frames"]},
                             cache)
    dec = [last[:, 0]]
    for i in range(8):
        lg, cache = pm.decode(params, batch["tokens"][:, 16 + i:17 + i],
                              cache, 16 + i)
        dec.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(dec, 1), full[:, 15:24],
                               atol=2e-3, rtol=0)


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}
