"""The paper's own models (the GPT-3 family and GPT-3-1.8B-MoE, the
paper's Table 2) and the configs of the port, against the JAX package:
``tests/test_paper_models.py``'s cases on the port, the forward of each
model family on the reference's weights (``repro_torch.convert``), the
kernel forward path against the reference's Pallas one, and a Trainer
checkpoint round trip of the MoE.

Tolerances, and why:
  * config sizes: exact (the same integer arithmetic).
  * the forward, f32 compute: logits within 1e-5 absolute, the loss
    within 1e-6 relative (the same math, f32 sums in another order, as
    tests/test_torch_model.py); bf16 compute: logits within 0.05
    absolute, the loss within 1e-3 relative (both round every product to
    bf16, at different points); the MoE's aux loss within 1e-5 relative
    in f32 and 1e-2 in bf16 (a token routed to another expert moves that
    expert's routed fraction by 1/T). bf16 MoE routing: see
    test_forward_matches_reference.
  * gradient accumulation: the reference's own test (GAS 2 against one
    batch): loss within 1e-4 relative, updated masters within 2e-3
    (Adam's first step amplifies f32 summation-order noise; lr 3e-4).
  * chunked cross-entropy against the full one: 1e-5 relative, as the
    reference's test.
  * ``use_kernels`` against the reference's ``use_pallas``: 1e-3, as
    tests/test_use_pallas.py.
  * checkpoints: bit-exact (a byte format).

The tests marked ``gpu`` run the kernel path on the card and skip
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
from repro.models import layers as ref_layers
from repro.models import transformer as ref_transformer
from repro.models.registry import build_model as ref_build
from repro.models.registry import make_batch as ref_make_batch
from repro.optim.adam import AdamConfig as RefAdam
from repro.train.steps import init_train_state as ref_init_state
from repro.train.steps import make_train_step as ref_make_step
from repro_torch import configs as pconfigs
from repro_torch.convert import to_numpy, train_state_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.models.layers import moe_apply, moe_route
from repro_torch.models.registry import build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.train.trainer import CheckpointPolicy, Trainer, TrainerConfig
from repro_torch.tree import flatten

PAPER = ["gpt3_0_7b", "gpt3_1_3b", "gpt3_2_7b", "gpt3_6_7b", "gpt3_13b",
         "gpt3_1_8b_moe"]


def _cfgs(key):
    """(reference, port) reduced configs of an ARCH_ID or a paper key."""
    if key in PAPER:
        return (rconfigs.reduced(rconfigs.get_paper_config(key)),
                pconfigs.reduced(pconfigs.get_paper_config(key)))
    return (rconfigs.reduced(rconfigs.get_config(key)),
            pconfigs.reduced(pconfigs.get_config(key)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ------------------------------------------------------------- configs
def test_id_lists_match_reference():
    from repro.configs import base as rbase
    assert pconfigs.ARCH_IDS == rconfigs.ARCH_IDS
    assert pconfigs.PAPER_ARCH_IDS == rbase.PAPER_ARCH_IDS == PAPER
    assert pconfigs.PAPER_TABLE2 == rconfigs.PAPER_TABLE2
    assert ({k: dataclasses.asdict(v)
             for k, v in pconfigs.INPUT_SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in rconfigs.INPUT_SHAPES.items()})


@pytest.mark.parametrize("key", rconfigs.ARCH_IDS + PAPER)
def test_config_matches_reference(key):
    """Every config, full and reduced, field for field; ``all_configs``
    and ``get_paper_config`` resolve as the reference's do."""
    if key in PAPER:
        ref = rconfigs.get_paper_config(key.replace("_", "-"))
        port = pconfigs.get_paper_config(key.replace("_", "-"))
    else:
        ref, port = rconfigs.get_config(key), pconfigs.all_configs()[key]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(pconfigs.reduced(port))
            == dataclasses.asdict(rconfigs.reduced(ref)))


@pytest.mark.parametrize("key", PAPER)
def test_table2_checkpoint_sizes(key):
    """S_C ≈ 14·N reproduces the paper's Table 2 within 15 %, with the
    reference's byte count exactly."""
    cfg = pconfigs.get_paper_config(key)
    assert cfg.checkpoint_bytes() == \
        rconfigs.get_paper_config(key).checkpoint_bytes()
    got = cfg.checkpoint_bytes() / 1e9
    want = pconfigs.PAPER_TABLE2[key]["ckpt_gb"]
    assert abs(got - want) / want < 0.15, (key, got, want)


@pytest.mark.parametrize("key,item", [
    ("zamba2_2_7b", "6d"), ("gemma2_9b", "6e"), ("minicpm3_4b", "6f"),
    ("internvl2_26b", "6g"), ("whisper_small", "6h")])
def test_unported_families_and_features_raise(key, item):
    """Items 6d–6h are ported: each family's full and reduced configs
    build, and its reduced one initialises with the reference's tree."""
    cfg = pconfigs.get_config(key)
    for c in (cfg, pconfigs.reduced(cfg)):
        m = build_model(c)
        assert m.cfg is c
        assert flatten(m.init(0, "meta"))
    small = pconfigs.reduced(cfg)
    want = flatten(_np(ref_build(rconfigs.reduced(
        rconfigs.get_config(key))).init(jax.random.PRNGKey(0))))
    assert [(n, tuple(a.shape)) for n, a in want] == \
        [(n, tuple(t.shape)) for n, t in flatten(
            build_model(small).init(0, "meta"))]


@pytest.mark.parametrize("key", ["zamba2_2_7b", "gemma2_9b", "minicpm3_4b"])
def test_ported_families_build_at_published_size(key):
    """The full config of each newly ported family initialises on
    ``meta`` with the reference's tree at its published size (the
    reference's shapes from ``jax.eval_shape``, no storage on either
    side)."""
    params = flatten(build_model(pconfigs.get_config(key)).init(0, "meta"))
    shapes = jax.eval_shape(ref_build(rconfigs.get_config(key)).init,
                            jax.random.PRNGKey(0))
    want = flatten(jax.tree.map(
        lambda s: np.lib.stride_tricks.as_strided(
            np.zeros((), np.float32), s.shape, [0] * len(s.shape)),
        shapes))
    assert [(n, tuple(a.shape)) for n, a in want] == \
        [(n, tuple(t.shape)) for n, t in params]


# ------------------------------------------------- tests/test_paper_models
def test_gpt3_reduced_trains():
    _, cfg = _cfgs("gpt3_1_3b")
    m = build_model(cfg)
    state = init_train_state(m, 0, "cpu")
    before = state.opt.master["embed"].clone()
    batch = _torch(ref_make_batch(rconfigs.reduced(
        rconfigs.get_paper_config("gpt3_1_3b")), 2, 32))
    _, metrics = make_train_step(m, AdamConfig(warmup_steps=1))(state,
                                                                batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert int(metrics["step"]) == 1
    assert not torch.equal(state.opt.master["embed"], before)


def test_gradient_accumulation_matches_large_batch():
    """§2.1.2: GAS 2 over microbatches equals one large batch (the same
    grads), on the port, and both losses equal the reference's."""
    ref_cfg, cfg = _cfgs("gpt3_0_7b")
    jm = ref_build(ref_cfg, dtype=jnp.float32)
    jstate = _np(ref_init_state(jm, jax.random.PRNGKey(0)))
    jb = ref_make_batch(ref_cfg, 4, 16)
    _, jmet = jax.jit(ref_make_step(jm, RefAdam(warmup_steps=1), gas=2))(
        ref_init_state(jm, jax.random.PRNGKey(0)), jb)
    pm = build_model(cfg, dtype=torch.float32)
    opt = AdamConfig(warmup_steps=1)
    s1, m1 = make_train_step(pm, opt, gas=1)(
        train_state_from_numpy(jstate, device="cpu"), _torch(jb))
    s2, m2 = make_train_step(pm, opt, gas=2)(
        train_state_from_numpy(jstate, device="cpu"), _torch(jb))
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    assert float(m2["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-4)
    a = flatten(s1.opt.master)[0][1]
    b = flatten(s2.opt.master)[0][1]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3)


def test_ce_chunking_equals_full():
    ref_cfg, cfg = _cfgs("gpt3_0_7b")
    jb = ref_make_batch(ref_cfg, 2, 32)
    jm = ref_build(ref_cfg, dtype=jnp.float32, ce_chunk=8)
    params = jm.init(jax.random.PRNGKey(0))
    tp = train_state_from_numpy(_np(params), device="cpu")
    full = float(build_model(cfg, dtype=torch.float32).loss(tp, _torch(jb)))
    chunked = float(build_model(cfg, dtype=torch.float32,
                                ce_chunk=8).loss(tp, _torch(jb)))
    assert chunked == pytest.approx(full, rel=1e-5)
    assert chunked == pytest.approx(float(jm.loss(params, jb)), rel=1e-5)


# ------------------------------------------------------ forward parity
def _routes(ref_cfg, cfg, params, tp, jb, dtype):
    """Each layer's expert choice (G, T, K) and the reference's router
    probabilities, from the reference's forward (run eagerly, so its
    layer scan hands concrete arrays to the hook) and the port's."""
    ref_rec, port_rec = [], []

    def ref_hook(p, h, c):
        x = h.reshape(1, -1, h.shape[-1]).astype(jnp.float32)
        probs = jax.nn.softmax(x @ p["router"].astype(jnp.float32), -1)
        ref_rec.append((np.asarray(jax.lax.top_k(probs, c.moe.top_k)[1]),
                        np.asarray(probs)))
        return ref_layers.moe_apply(p, h, c)

    def port_hook(p, h, c):
        port_rec.append(moe_route(p, h, c).gate_i.numpy())
        return moe_apply(p, h, c)

    with jax.disable_jit():
        ref_transformer.forward(params, ref_cfg, jb, dtype=dtype,
                                moe_kernel=ref_hook)
    transformer.forward(tp, cfg, _torch(jb), dtype=torch.bfloat16,
                        moe_kernel=port_hook)
    return ref_rec, port_rec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("key", ["gpt3_0_7b", "qwen1_5_4b", "gpt3_1_8b_moe"])
def test_forward_matches_reference(key, dtype):
    """qwen1_5_4b carries the qkv bias; gpt3_1_8b_moe the MoE layer (its
    aux loss held too).

    bf16 MoE: the two packages round the hidden state to bf16 at
    different points, so a token whose two best experts are nearly tied
    can be routed to the other one, and with an expert at capacity that
    also moves which later arrival is dropped. Each layer's routing is
    recorded on both sides: a token routed differently must be a near
    tie (the reference's probability margin under 1e-2), and the logits
    are held at 0.05 on every token before the first such token in the
    router's arrival order (flattened batch × sequence; causal attention
    and the capacity count only look back). The loss is held over every
    token."""
    ref_cfg, cfg = _cfgs(key)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = ref_build(ref_cfg, dtype=jdt)
    params = jax.tree.map(lambda a: a.astype(jdt),
                          jm.init(jax.random.PRNGKey(1)))
    jb = ref_make_batch(ref_cfg, 2, 32)
    pm = build_model(cfg, dtype=tdt)
    tp = train_state_from_numpy(_np(params), device="cpu")
    for (_, a), (_, b) in zip(flatten(to_numpy(tp)), flatten(_np(params))):
        assert a.tobytes() == np.ascontiguousarray(b).tobytes()
    jl, jaux = jm.forward(params, jb)
    tl, aux = pm.forward(tp, _torch(jb))
    assert tl.dtype == tdt
    n_tokens = tl.shape[0] * tl.shape[1]
    held = n_tokens
    if cfg.moe is not None and tdt == torch.bfloat16:
        ref_rec, port_rec = _routes(ref_cfg, cfg, params, tp, jb, jdt)
        assert len(ref_rec) == len(port_rec) == cfg.n_layers
        for (gi, probs), pi in zip(ref_rec, port_rec):
            flipped = np.flatnonzero((gi != pi).any(-1).reshape(-1))
            top = np.sort(probs.reshape(n_tokens, -1), -1)[:, ::-1]
            margin = top[:, cfg.moe.top_k - 1] - top[:, cfg.moe.top_k]
            assert (margin[flipped] < 1e-2).all(), margin[flipped]
            if flipped.size:
                held = min(held, int(flipped[0]))
        assert held >= n_tokens // 2
    tol = 1e-5 if dtype == "float32" else 0.05
    np.testing.assert_allclose(
        tl.float().numpy().reshape(n_tokens, -1)[:held],
        np.asarray(jl, np.float32).reshape(n_tokens, -1)[:held],
        atol=tol, rtol=0)
    rel = 1e-6 if dtype == "float32" else 1e-3
    if cfg.moe is None:
        assert float(aux) == 0.0
    else:
        assert float(aux) > 0
        assert float(aux) == pytest.approx(float(jaux), rel=rel * 10)
    assert float(pm.loss(tp, _torch(jb))) == pytest.approx(
        float(jm.loss(params, jb)), rel=rel)


@pytest.mark.parametrize("key", ["qwen1_5_4b", "gpt3_1_8b_moe"])
def test_use_kernels_matches_reference_use_pallas(key):
    """The kernel forward path (B3's plain version on the CPU) against
    the reference's Pallas one, on the reference's weights: the
    counterpart of tests/test_use_pallas.py for the dense and moe
    families."""
    ref_cfg, cfg = _cfgs(key)
    jb = ref_make_batch(ref_cfg, 1, 64)
    jm = ref_build(ref_cfg, dtype=jnp.float32, use_pallas=True)
    params = jm.init(jax.random.PRNGKey(0))
    jl, _ = jax.jit(jm.forward)(params, jb)
    pm = build_model(cfg, dtype=torch.float32, use_kernels=True)
    n = ops.flash_attention.launches
    tl, _ = pm.forward(train_state_from_numpy(_np(params), device="cpu"),
                       _torch(jb))
    assert ops.flash_attention.launches == n        # CPU: the plain version
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < 1e-3


# ------------------------------------------------------------- trainer
def test_moe_trainer_checkpoints_and_restores(tmp_path):
    """The MoE trains through the port's Trainer, checkpoints
    (fastpersist-pipelined, every 2), restores bit-equal with its data
    position, and the reference's engine reads the port's keyframe bit
    for bit."""
    _, cfg = _cfgs("gpt3_1_8b_moe")
    pol = CheckpointPolicy(directory=str(tmp_path), every=2,
                           backend="fastpersist-pipelined")
    tcfg = TrainerConfig(model=cfg, steps=2, global_batch=2, seq_len=16,
                         checkpoint=pol, log_every=100)
    tr = Trainer(tcfg, device="cpu")
    _, metrics = tr.run()
    assert bool(torch.isfinite(metrics["loss"]))
    assert [h.result().step for h in tr.saves] == [2]
    live, position = to_numpy(tr.state), tr.data.position
    tr.engine.close()
    tr2 = Trainer(tcfg, device="cpu")
    assert tr2.restore() == 2 and tr2.data.position == position
    got = flatten(to_numpy(tr2.state))
    names = [n for n, _ in got]
    assert ".params/layers/mlp/router" in names
    assert ".params/layers/mlp/wi" in names
    for (name, a), (_, b) in zip(got, flatten(live)):
        assert a.tobytes() == b.tobytes(), name
    tr2.engine.close()
    ref, _ = RefEngine(RefSpec(str(tmp_path))).load()
    want = dict(flatten(live))
    assert sorted(ref) == sorted(want)
    for name, a in ref.items():
        assert np.asarray(a).tobytes() == want[name].tobytes(), name
    wi = dict(got)[".params/layers/mlp/wi"]
    assert wi.shape == (cfg.n_layers, cfg.moe.n_experts, cfg.d_model,
                        cfg.d_ff)


# --------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("key,head_dim", [("gpt3_0_7b", 96),
                                          ("gpt3_2_7b", 80),
                                          ("gpt3_1_8b_moe", 64)])
def test_paper_models_use_kernels_on_card(cuda, key, head_dim):
    """The kernel forward of each family at the paper models' head dims
    against the plain attention, with one B3 launch a layer, and the
    cached decode against the forward (2e-3)."""
    _, cfg = _cfgs(key)
    cfg = dataclasses.replace(cfg, n_layers=3, head_dim=head_dim)
    if cfg.moe is not None:           # no drops: decode equals forward
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    params = build_model(cfg).init(0, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 80), device=cuda)
    plain = build_model(cfg, dtype=torch.float32)
    want, _ = plain.forward(params, {"tokens": tokens})
    n = ops.flash_attention.launches
    got, _ = build_model(cfg, dtype=torch.float32,
                         use_kernels=True).forward(params,
                                                   {"tokens": tokens})
    torch.cuda.synchronize()
    assert ops.flash_attention.launches - n == 3
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    cache = plain.init_cache(2, 80, cuda)
    _, cache = plain.prefill(params, {"tokens": tokens[:, :79]}, cache)
    dec, _ = plain.decode(params, tokens[:, 79:], cache, 79)
    torch.testing.assert_close(dec[:, 0], want[:, -1], atol=2e-3, rtol=0)
