"""The port's Zamba2 hybrid (``repro_torch.models.hybrid``: a Mamba2
backbone, SSM blocks stacked (G, attn_every, ...), one shared attention
block with norms per invocation) against the JAX package, on the
reference's weights carried across (``repro_torch.convert``) and its
``make_batch`` tokens. Two configs: ``reduced(zamba2_2_7b)`` (attn_every
1: G = 2 groups of one block) and the same at 6 layers, attn_every 3
(G = 2 groups of three), so that the regrouping is really exercised.

Tolerances, and why:
  * the forward, f32 compute: logits within 1e-5 absolute, the loss
    within 1e-6 relative (the same math, f32 sums in another order, as
    tests/test_torch_mamba2.py); bf16: logits within 0.05, the loss
    within 1e-3 relative (both round every product to bf16, at
    different points).
  * ``use_kernels`` against the reference's ``use_pallas``: 1e-3, as
    tests/test_use_pallas.py (whose zamba2 case this is on the port).
  * decode against the forward over the same tokens: 2e-3, as
    tests/test_archs.py; the port's decode logits and cache against the
    reference's: 1e-5 (f32).
  * checkpoints: bit-exact (a byte format).

The test marked ``gpu`` runs the kernel path on the card and skips
without one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core.engine import CheckpointEngine as RefEngine
from repro.core.engine import CheckpointSpec as RefSpec
from repro.models.registry import build_model as ref_build
from repro.models.registry import make_batch as ref_make_batch
from repro.train.trainer import CheckpointPolicy as RefPolicy
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch import configs as pconfigs
from repro_torch.convert import to_numpy, train_state_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_intra_chunk_plain
from repro_torch.launch import serve_decode
from repro_torch.models import hybrid
from repro_torch.models.registry import build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.train.trainer import CheckpointPolicy, Trainer, TrainerConfig
from repro_torch.tree import flatten

#: "reduced": attn_every 1; "grouped": 6 layers as 2 groups of 3
SHAPES = {"reduced": {}, "grouped": {"n_layers": 6, "attn_every": 3}}


def _cfgs(shape="reduced"):
    ch = SHAPES[shape]
    return (dataclasses.replace(
                rconfigs.reduced(rconfigs.get_config("zamba2_2_7b")), **ch),
            dataclasses.replace(
                pconfigs.reduced(pconfigs.get_config("zamba2_2_7b")), **ch))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _setup(shape, dtype="float32", B=2, L=16, seed=0):
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


@pytest.mark.parametrize("shape", list(SHAPES))
def test_init_has_the_reference_tree(shape):
    ref_cfg, cfg = _cfgs(shape)
    want = flatten(_np(ref_build(ref_cfg).init(jax.random.PRNGKey(0))))
    got = flatten(build_model(cfg).init(0, "meta"))
    assert [(n, tuple(a.shape)) for n, a in want] == \
        [(n, tuple(t.shape)) for n, t in got]
    assert all(t.dtype == torch.float32 for _, t in got)
    G = cfg.n_layers // cfg.attn_every
    lead = dict(got)["ssm_layers/mixer/in_proj"].shape[:2]
    assert tuple(lead) == (G, cfg.attn_every)
    assert tuple(dict(got)["inv_norms/ln1"].shape) == (G, cfg.d_model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_matches_reference(shape, dtype):
    """bf16 at 6 layers: the two packages' bf16 logits drift apart by
    0.05–0.07 there (each rounds every product at its own points), and
    the reference's own bf16 logits lie as far from its f32 ones. So the
    grouped config's bf16 logits are held against the reference's f32
    logits, no farther than 1.25 times the reference's bf16 logits are."""
    jm, params, jb, pm, tp = _setup(shape, dtype, L=40, seed=1)
    # the (G, A, ...) leaves cross unchanged, both ways
    for (na, a), (_, b) in zip(flatten(to_numpy(tp)), flatten(_np(params))):
        assert a.tobytes() == np.ascontiguousarray(b).tobytes(), na
    jl, _ = jm.forward(params, jb)
    tl, aux = pm.forward(tp, _torch(jb))
    assert tl.dtype == tp["embed"].dtype and float(aux) == 0.0
    if dtype == "float32" or shape == "reduced":
        _close(tl, jl, 1e-5 if dtype == "float32" else 0.05)
    else:
        jm32 = ref_build(_cfgs(shape)[0], dtype=jnp.float32)
        f32 = np.asarray(jm32.forward(jax.tree.map(
            lambda a: a.astype(jnp.float32), params), jb)[0])
        ref_err = np.abs(np.asarray(jl, np.float32) - f32).max()
        assert np.abs(tl.float().numpy() - f32).max() <= 1.25 * ref_err
    assert float(pm.loss(tp, _torch(jb))) == pytest.approx(
        float(jm.loss(params, jb)), rel=1e-6 if dtype == "float32" else 1e-3)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_use_kernels_matches_reference_use_pallas(shape):
    """B4 in the hybrid stack (its plain version on the CPU) against the
    reference's Pallas kernel in interpret mode, on the reference's
    weights; the hook reaches every SSM block."""
    ref_cfg, cfg = _cfgs(shape)
    jb = ref_make_batch(ref_cfg, 1, 32)
    jm = ref_build(ref_cfg, dtype=jnp.float32, use_pallas=True)
    params = jm.init(jax.random.PRNGKey(0))
    jl, _ = jax.jit(jm.forward)(params, jb)
    tp = train_state_from_numpy(_np(params), device="cpu")
    seen = []

    def spy(*args):
        seen.append(args[0].shape)
        return ops.ssd_intra_chunk(*args)

    n = ops.ssd_intra_chunk.launches
    tl, _ = hybrid.forward(tp, cfg, _torch(jb), dtype=torch.float32,
                           ssd_kernel=spy)
    assert ops.ssd_intra_chunk.launches == n        # CPU: the plain version
    assert len(seen) == cfg.n_layers
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < 1e-3
    pm = build_model(cfg, dtype=torch.float32, use_kernels=True)
    got, _ = pm.forward(tp, _torch(jb))
    torch.testing.assert_close(got, tl, atol=0, rtol=0)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_decode_matches_forward_and_reference(shape):
    """Prefill of 10 tokens, then 5 decode steps one after the other:
    each step's logits against the forward at its position and against
    the reference's decode, and the whole cache (SSM conv and state, the
    shared block's k and v) against the reference's after each step."""
    jm, params, jb, pm, tp = _setup(shape)
    B, L = jb["tokens"].shape
    P = 10
    tokens = _torch(jb)["tokens"]
    full, _ = pm.forward(tp, {"tokens": tokens})
    jcache = jm.init_cache(B, L + 2)
    jlast, jcache = jm.prefill(params, {"tokens": jb["tokens"][:, :P]},
                               jcache)
    cache = pm.init_cache(B, L + 2, "cpu")
    k_buf = cache["k"]
    last, cache = pm.prefill(tp, {"tokens": tokens[:, :P]}, cache)
    assert cache["k"] is k_buf                    # written in place
    assert cache["ssm"]["ssm"].dtype == torch.float32
    G = pm.cfg.n_layers // pm.cfg.attn_every
    assert cache["ssm"]["conv"].shape[:2] == (G, pm.cfg.attn_every)
    assert cache["k"].shape[0] == G
    _close(last, jlast, 1e-5)
    assert float((last[:, 0] - full[:, P - 1]).abs().max()) < 2e-3

    def same_cache():
        for got, want in ((cache["ssm"]["conv"], jcache["ssm"]["conv"]),
                          (cache["ssm"]["ssm"], jcache["ssm"]["ssm"]),
                          (cache["k"], jcache["k"]),
                          (cache["v"], jcache["v"])):
            assert tuple(got.shape) == want.shape
            _close(got, want, 1e-5)

    same_cache()
    decode = jax.jit(jm.decode)
    for i in range(5):
        tok = tokens[:, P + i:P + i + 1]
        dec, cache = pm.decode(tp, tok, cache, P + i)
        jdec, jcache = decode(params, jb["tokens"][:, P + i:P + i + 1],
                              jcache, jnp.int32(P + i))
        assert float((dec[:, 0] - full[:, P + i]).abs().max()) < 2e-3
        _close(dec, jdec, 1e-5)
        same_cache()
    # positions past the last token were never written
    assert not cache["k"][:, :, P + 5:].any()


def test_train_step_has_finite_gradients():
    _, cfg = _cfgs("grouped")
    m = build_model(cfg)
    state = init_train_state(m, 0, "cpu")
    batch = _torch(ref_make_batch(_cfgs("grouped")[0], 2, 16))
    ps = flatten(state.params)
    for _, p in ps:
        p.requires_grad_(True)
    grads = torch.autograd.grad(m.loss(state.params, batch),
                                [p for _, p in ps])
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)
    for _, p in ps:
        p.requires_grad_(False)
    before = state.opt.master["ssm_layers"]["mixer"]["in_proj"].clone()
    _, metrics = make_train_step(m, AdamConfig(warmup_steps=1))(state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert not torch.equal(state.opt.master["ssm_layers"]["mixer"]
                           ["in_proj"], before)


def _same_bits(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, a in got.items():
        assert np.ascontiguousarray(np.asarray(a)).tobytes() == \
            np.ascontiguousarray(np.asarray(want[name])).tobytes(), name


def test_trainer_checkpoints_cross_load(tmp_path):
    """The port's Trainer checkpoints the grouped hybrid and the
    reference's engine and Trainer read it bit for bit; the reference's
    Trainer checkpoints it and the port's Trainer restores it bit for
    bit, at the same data position."""
    ref_cfg, cfg = _cfgs("grouped")
    d = str(tmp_path / "port")
    tcfg = TrainerConfig(model=cfg, steps=2, global_batch=2, seq_len=16,
                         log_every=100, checkpoint=CheckpointPolicy(
                             directory=d, every=2,
                             backend="fastpersist-pipelined"))
    tr = Trainer(tcfg, device="cpu")
    _, metrics = tr.run()
    assert bool(torch.isfinite(metrics["loss"]))
    live = dict(flatten(to_numpy(tr.state)))
    tr.engine.close()
    assert ".params/ssm_layers/mixer/in_proj" in live
    got, man = RefEngine(RefSpec(d)).load()
    _same_bits(got, live)
    assert man.extras["data"]["position"] == 2

    rd = str(tmp_path / "ref")
    rt = RefTrainer(RefTrainerConfig(
        model=ref_cfg, steps=1, global_batch=2, seq_len=16, log_every=100,
        checkpoint=RefPolicy(directory=rd, every=1)))
    rt.run()
    rt.engine.close()
    want = dict(flatten(_np(rt.state)))
    tr2 = Trainer(dataclasses.replace(tcfg, checkpoint=CheckpointPolicy(
        directory=rd, every=100)), device="cpu")
    assert tr2.restore() == 1 and tr2.data.position == 1
    _same_bits(dict(flatten(to_numpy(tr2.state))), want)
    tr2.engine.close()


def test_serve_decode_on_the_cpu():
    seq = serve_decode.main(["--arch", "zamba2_2_7b", "--reduced",
                             "--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--new-tokens", "4"])
    _, cfg = _cfgs()
    assert seq.shape == (2, 4) and seq.dtype == torch.int32
    assert ((0 <= seq) & (seq < cfg.vocab_size)).all()


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_ssd_kernel_at_zamba2_widths_on_card(cuda):
    """B4 at zamba2_2_7b's state size n 64 and 80 heads (head_dim 64,
    chunk 256), B and C from one group expanded over the heads as
    ``ssd_chunked`` passes them, against its plain version (1e-4)."""
    b, nc, cl, h, p, n = 1, 2, 256, 80, 64, 64
    g = torch.Generator(device=cuda).manual_seed(64)
    xc = torch.randn((b, nc, cl, h, p), generator=g, device=cuda)
    dAc = -torch.randn((b, nc, cl, h), generator=g, device=cuda).abs() * 0.1
    Bc, Cc = (torch.randn((b, nc, cl, 1, n), generator=g,
                          device=cuda).expand(b, nc, cl, h, n)
              for _ in range(2))
    n0 = ops.ssd_intra_chunk.launches
    got = ops.ssd_intra_chunk(xc, dAc, Bc, Cc)
    want = ssd_intra_chunk_plain(xc, dAc, Bc, Cc)
    torch.cuda.synchronize()
    assert ops.ssd_intra_chunk.launches == n0 + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(SHAPES))
def test_use_kernels_matches_plain_hooks_on_card(cuda, shape):
    _, cfg = _cfgs(shape)
    params = build_model(cfg).init(0, cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 80),
                                     device=cuda)}
    want, _ = build_model(cfg, dtype=torch.float32).forward(params, batch)
    n = ops.ssd_intra_chunk.launches
    got, _ = build_model(cfg, dtype=torch.float32,
                         use_kernels=True).forward(params, batch)
    torch.cuda.synchronize()
    assert ops.ssd_intra_chunk.launches - n == cfg.n_layers
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
