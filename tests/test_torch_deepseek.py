"""DeepSeek-V2's parts in the port: the flash kernels' plain versions at
MLA's head dims (q and k 192, v 128), the route of MLA's training
attention to the kernels, the dropless MoE layer over held experts
(``layers.moe_apply_dropless``) against a dense loop over the experts,
the YaRN rotary of MLA, and the configuration's sizes.

Tolerances, as a share of the largest magnitude: the plain backward as
in ``test_torch_attention_grad.py`` (float32 1e-5 against autograd of
``layers.attention``; bfloat16 2e-2 against it and 1e-2 against
float64); the dropless layer in float32 against a float64 loop 1e-5 (the
same sums in another order). The tests marked ``gpu`` hold the CUDA
kernels at MLA's head dims against the plain versions and skip without a
card."""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.configs.base import DeepSeekMoEConfig, MLAConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (flash_attention_bwd_plain,
                                     flash_attention_plain)
from repro_torch.models import layers as ly
from repro_torch.models import transformer
from repro_torch.models.registry import build_model
from repro_torch.train.steps import init_train_state
from repro_torch.tree import flatten

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TOL_BF16_TRUTH = 1e-2
HD, HDV = fa.MLA_DIMS[0]


def _inputs(B, L, H, hd, hdv, dtype, seed, device="cpu"):
    """q, k (B, L, H, hd), v (B, L, H, hdv) and dO (B, L, H, hdv)."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k = (torch.randn((B, L, H, hd), generator=g, device=device)
            for _ in range(2))
    v, do = (torch.randn((B, L, H, hdv), generator=g, device=device)
             for _ in range(2))
    return [t.to(dtype) for t in (q, k, v, do)]


def _autograd(q, k, v, do, dtype=None):
    xs = [(t if dtype is None else t.to(dtype)).detach().requires_grad_()
          for t in (q, k, v)]
    pos = torch.arange(q.shape[1], device=q.device)
    ly.attention(*xs, q_pos=pos, kv_pos=pos).backward(
        do if dtype is None else do.to(dtype))
    return [x.grad for x in xs]


def _share(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_at_mla_head_dims(dtype):
    """The plain forward and backward at q, k 192 and v 128, L 70 (a
    ragged tile), causal: the output against ``layers.attention``, the
    gradients against its autograd and float64."""
    q, k, v, do = _inputs(2, 70, 2, HD, HDV, dtype, seed=7)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    out, lse = flash_attention_plain(qt, kt, vt, lse=True)
    pos = torch.arange(70)
    want = ly.attention(q, k, v, q_pos=pos, kv_pos=pos)
    assert out.shape == (2, 2, 70, HDV)
    assert _share(out.transpose(1, 2), want) <= TOL[dtype]
    got = [g.transpose(1, 2) for g in flash_attention_bwd_plain(
        qt, kt, vt, out, lse, dot)]
    auto = _autograd(q, k, v, do)
    truth = _autograd(q, k, v, do, torch.float64)
    for g, a, t, x in zip(got, auto, truth, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        assert _share(g, a) <= TOL[dtype]
        if dtype == torch.bfloat16:
            assert _share(g, t) <= TOL_BF16_TRUTH


def test_function_carries_the_plain_backward_at_mla_dims():
    """``_Attention`` on CPU tensors at (192, 128): the plain forward's
    output in v's head dim and the plain backward's gradients bit for
    bit."""
    q, k, v, do = _inputs(1, 70, 2, HD, HDV, torch.bfloat16, seed=3)
    views = [t.transpose(1, 2).requires_grad_() for t in (q, k, v)]
    out = fa._Attention.apply(*views, True, None, None)
    out.backward(do.transpose(1, 2))
    assert torch.equal(out, flash_attention_plain(*views))
    qt, kt, vt, dot = (t.detach().transpose(1, 2) for t in (q, k, v, do))
    o, lse = flash_attention_plain(qt, kt, vt, lse=True)
    for got, want in zip(views, flash_attention_bwd_plain(
            qt, kt, vt, o, lse, dot)):
        assert torch.equal(got.grad, want)


def _on_card(q):
    return SimpleNamespace(is_cuda=True, dtype=q.dtype, shape=q.shape)


@pytest.mark.parametrize("hd,hdv,dtype,takes", [
    (192, 128, torch.bfloat16, True),
    (192, 128, torch.float32, False),    # MLA's pair is bf16 only
    (192, 192, torch.bfloat16, False),
    (96, 64, torch.bfloat16, False),     # minicpm3_4b's MLA
    (128, 128, torch.bfloat16, True),
    (128, 64, torch.bfloat16, False)])
def test_kernel_takes_mla_pairs(hd, hdv, dtype, takes):
    q = torch.empty((1, 8, 2, hd), dtype=dtype)
    assert fa.kernel_takes(_on_card(q), hd_v=hdv) is takes
    assert not fa.kernel_takes(q, hd_v=hdv)          # a CPU tensor


def _tiny(q_lora=None, **moe):
    """A tiny DeepSeek-V2: 1 dense + 2 MoE layers, 16 router experts,
    top 3, experts 4-7 held, 2 shared."""
    cfg = get_config("deepseek_v2_lite")
    m = dict(n_experts=16, top_k=3, moe_intermediate_size=24,
             first_held_expert=4, n_held_experts=4)
    m.update(moe)
    return dataclasses.replace(
        cfg, n_layers=3, d_model=48, n_heads=2, n_kv_heads=2, d_ff=80,
        vocab_size=64,
        mla=MLAConfig(q_lora_rank=q_lora, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
        moe=dataclasses.replace(cfg.moe, **m))


def test_route_sends_mla_to_the_kernel_where_it_takes(monkeypatch):
    """Where ``kernel_takes`` sees a card, every layer's MLA attention,
    the dense layer's too, goes to ``fa.flash_attention`` in (B, H, L, ·)
    views with v at its own head dim, and gives (here, as its CPU
    version) what ``layers.attention`` gives, within the bf16 tolerance.
    Without the card the route keeps ``layers.attention``."""
    cfg = _tiny()
    model = build_model(cfg)
    params = model.init(0, "cpu")
    tok = torch.randint(0, 64, (2, 20), generator=torch.Generator()
                        .manual_seed(0))
    real, kernel = fa.kernel_takes, fa.flash_attention
    calls = []

    def counted(q, k, v, **kw):
        calls.append((q.shape, v.shape))
        out = kernel(q, k, v, **kw)
        pos = torch.arange(q.shape[2])
        want = ly.attention(*(t.transpose(1, 2) for t in (q, k, v)),
                            q_pos=pos, kv_pos=pos)
        assert _share(out.transpose(1, 2), want) <= TOL[torch.bfloat16]
        return out
    monkeypatch.setattr(fa, "flash_attention", counted)
    model.forward(params, {"tokens": tok})
    assert calls == []
    monkeypatch.setattr(fa, "kernel_takes", lambda q, window=None, cap=None,
                        hd_v=None: real(_on_card(q), window, cap, hd_v))
    monkeypatch.setattr(fa, "MLA_DIMS", ((24, 16),))
    monkeypatch.setattr(fa, "SHAPES", ((24, 16),))
    model.forward(params, {"tokens": tok})
    assert calls == [((2, 2, 20, 24), (2, 2, 20, 16))] * cfg.n_layers


def _dense_loop(p, x, cfg):
    """The held experts' part of the layer in float64, every token through
    every held expert, times its gate where it routed there (0 elsewhere),
    plus the shared experts; the reference's routing rule."""
    m = cfg.moe
    xd = x.double().reshape(-1, x.shape[-1])
    s = torch.softmax(xd @ p["router"].double(), -1)
    top = torch.sort(s, dim=-1, descending=True, stable=True).indices
    top = top[:, :m.top_k]
    gate = s.gather(-1, top)
    out = torch.zeros_like(xd)
    for j, e in enumerate(m.held):
        w = (gate * (top == e)).sum(-1, keepdim=True)
        h = F.silu(xd @ p["wg"][j].double()) * (xd @ p["wi"][j].double())
        out = out + w * (h @ p["wo"][j].double())
    sh = p["shared"]
    out = out + (F.silu(xd @ sh["wg"].double()) * (xd @ sh["wi"].double())
                 ) @ sh["wo"].double()
    return out.reshape(x.shape)


def test_dropless_matches_a_dense_loop():
    """Uneven routing (the router biased to two of the held experts, one
    held expert all but unreached): the layer's output and its gradients
    in float32 against a float64 loop over every held expert; every
    (token, k) pair on a held expert is computed (dropless); the pair
    counts add to the device counter's row of the layer."""
    cfg = _tiny()
    g = torch.Generator().manual_seed(5)
    p = ly.moe_init(cfg, g, "cpu")
    # inputs with a positive mean, so a column's shift moves its logit
    # the same way for every token
    x = torch.randn((3, 40, cfg.d_model), generator=g) + 1.0
    p["router"][:, 4] += 0.03
    p["router"][:, 6] += 0.02
    p["router"][:, 7] -= 0.2
    p = {k: ({kk: vv.requires_grad_() for kk, vv in v.items()}
             if isinstance(v, dict) else v.requires_grad_())
         for k, v in p.items()}
    x.requires_grad_()
    ly.moe_apply_dropless.pairs = None
    out, aux = ly.moe_apply_dropless(p, x, cfg)
    want = _dense_loop(p, x, cfg)
    assert _share(out, want) <= 1e-5
    ins = [x, *[t for _, t in flatten(p)]]
    g_out = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, ins, g_out)
    ref = torch.autograd.grad(want, ins, g_out.double())
    for a, b in zip(got, ref):
        assert _share(a, b) <= 1e-5
    assert ly.moe_apply_dropless.pairs.shape == (2, 4)   # 2 MoE layers
    counts = ly.moe_apply_dropless.pairs[0].clone()
    top = torch.sort(torch.softmax(x.detach().reshape(-1, cfg.d_model)
                                   @ p["router"].detach(), -1), dim=-1,
                     descending=True, stable=True).indices[:, :cfg.moe.top_k]
    assert counts.tolist() == [int((top == e).sum()) for e in cfg.moe.held]
    assert max(counts) > 2 * min(counts) and min(counts) <= 2
    assert not ly.moe_apply_dropless.pairs[1].any()
    ly.moe_apply_dropless(p, x, cfg, layer=1)
    ly.moe_apply_dropless(p, x, cfg)
    assert torch.equal(ly.moe_apply_dropless.pairs,
                       torch.stack([2 * counts, counts]))
    assert ly.grouped_matmul.launches == 0          # no card, no launch
    assert float(aux) > 0


def test_each_moe_layer_counts_in_its_own_row(monkeypatch):
    """A forward of the tiny model (1 dense + 2 MoE layers): the MoE
    layers count their pairs in rows 0 and 1 of the counter, in order;
    a second forward doubles it."""
    cfg = _tiny()
    model = build_model(cfg)
    params = model.init(0, "cpu")
    tok = torch.randint(0, 64, (2, 20), generator=torch.Generator()
                        .manual_seed(4))
    ly.moe_apply_dropless.pairs = None
    model.forward(params, {"tokens": tok})
    pairs = ly.moe_apply_dropless.pairs.clone()
    assert pairs.shape == (2, 4) and bool((pairs.sum(1) > 0).all())
    assert int(pairs.sum()) <= 2 * 2 * 20 * cfg.moe.top_k
    rows, real = [], ly._count_pairs

    def count(counts, layer, n_layers):
        rows.append((layer, n_layers))
        real(counts, layer, n_layers)
    monkeypatch.setattr(ly, "_count_pairs", count)
    model.forward(params, {"tokens": tok})
    assert rows == [(0, 2), (1, 2)]
    assert torch.equal(ly.moe_apply_dropless.pairs, 2 * pairs)


def test_balance_aux_per_sequence_by_hand():
    """f_{b,i} = E / (K S) times the pairs of sequence b on expert i,
    P_{b,i} the mean probability; alpha times the mean over b of
    sum_i f P."""
    m = DeepSeekMoEConfig(n_experts=4, top_k=2, aux_loss_coef=0.5)
    probs = torch.tensor([[.4, .3, .2, .1], [.1, .2, .3, .4],
                          [.25, .25, .25, .25], [.7, .1, .1, .1]])
    top = torch.tensor([[0, 1], [3, 2], [0, 1], [0, 1]])
    # sequence 0: tokens 0, 1; sequence 1: tokens 2, 3
    f0 = torch.tensor([1., 1., 1., 1.])              # 4 / (2 * 2) x counts
    f1 = torch.tensor([2., 2., 0., 0.])
    p0, p1 = probs[:2].mean(0), probs[2:].mean(0)
    want = 0.5 * ((f0 * p0).sum() + (f1 * p1).sum()) / 2
    assert torch.allclose(ly.balance_aux(m, probs, top, 2), want)
    whole = 0.5 * ((torch.tensor([3., 3., 1., 1.]) * 4 / 8)
                   * probs.mean(0)).sum()
    assert torch.allclose(ly.balance_aux(m, probs, top, 1), whole)


def test_tree_and_sizes():
    """The leading dense layer's own stack, a direct ``wq`` without a
    query LoRA, the held experts stacked, the shared experts; the
    analytic count at the cell's share: 1 dense layer of 81,007,104
    parameters, each MoE layer 100,405,760, embedding, head and final
    norm 419,432,448 (norms' 512-wide kv_norm left out of the analytic
    count, as for every MLA config)."""
    cfg = dataclasses.replace(
        get_config("deepseek_v2_lite"), n_layers=16,
        moe=dataclasses.replace(get_config("deepseek_v2_lite").moe,
                                n_held_experts=8))
    state = init_train_state(build_model(cfg), 0, "meta")
    shapes = {n: tuple(t.shape) for n, t in flatten(state.params)}
    assert shapes["dense_layers/attn/wq"] == (1, 2048, 16 * 192)
    assert shapes["dense_layers/mlp/wi"] == (1, 2048, 10944)
    assert shapes["layers/mlp/wi"] == (15, 8, 2048, 1408)
    assert shapes["layers/mlp/shared/wo"] == (15, 2816, 2048)
    assert shapes["layers/mlp/router"] == (15, 2048, 64)
    assert "layers/attn/wq_a" not in shapes and "lm_head" in shapes
    n = sum(torch.Size(s).numel() for s in shapes.values())
    assert n == 500_439_552 + 15 * 100_405_760
    assert cfg.param_count() == n - 16 * 512
    assert transformer.n_dense_layers(cfg) == 1


def test_existing_mla_keeps_its_query_lora():
    """minicpm3_4b's MLA keeps ``wq_a``, ``q_norm`` and ``wq_b``."""
    cfg = get_config("minicpm3_4b")
    from repro_torch.configs import reduced
    p = ly.mla_init(reduced(cfg), None, "meta", (2,))
    assert {"wq_a", "q_norm", "wq_b"} <= set(p) and "wq" not in p


def test_yarn_rotary_at_v2_lites_config():
    """DeepSeek-V2-Lite's YaRN (factor 40 over 4,096 positions, beta 32
    and 1, rotary dims 64): the correction range is dims 10 to 23, so the
    first 10 frequencies are the plain ones, those from 23 on the plain
    ones over 40, and those between blend along the ramp; cos and sin
    take mscale(0.707) / mscale(0.707) = 1, the scores (0.1 x 0.707 x
    ln 40 + 1)^2. Held in float64 at every position of a 4K row (1e-3
    absolute: float32 angles up to 4,096 rad; a ramp one dim off moves
    an angle by radians)."""
    pos = torch.arange(4096)
    cos, sin, scale = ly.mla_rope(pos, get_config("deepseek_v2_lite"))
    i = torch.arange(32, dtype=torch.float64)
    plain = 10000.0 ** (-2 * i / 64)
    ramp = ((i - 10) / 13).clamp(0, 1)
    ang = pos.double()[:, None] * (plain / 40 * ramp + plain * (1 - ramp))
    assert torch.allclose(cos.double(), ang.cos(), atol=1e-3, rtol=0)
    assert torch.allclose(sin.double(), ang.sin(), atol=1e-3, rtol=0)
    assert math.isclose(scale, (0.1 * 0.707 * math.log(40) + 1) ** 2,
                        rel_tol=1e-12)


def test_mla_without_yarn_keeps_the_plain_rotary():
    """An ``MLAConfig`` (minicpm3_4b's, the tiny one here) takes
    ``rope_tables`` as before and no scale on q."""
    pos = torch.arange(64)
    for cfg in (get_config("minicpm3_4b"), _tiny()):
        cos, sin, scale = ly.mla_rope(pos, cfg)
        want = ly.rope_tables(pos, cfg.mla.qk_rope_head_dim, cfg.rope_theta)
        assert torch.equal(cos, want[0]) and torch.equal(sin, want[1])
        assert scale == 1.0


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,L", [(2, 16, 4096), (1, 4, 200), (1, 2, 77)])
def test_mla_kernels_match_plain_on_card(cuda, B, H, L):
    """The forward, dq, dk and dv at (192, 128) against the plain versions
    (from the kernel's own output and log-sum-exp), within the bf16
    tolerance of the largest magnitude; one launch each way."""
    q, k, v, do = _inputs(B, L, H, HD, HDV, torch.bfloat16, seed=L,
                          device=cuda)
    views = [t.transpose(1, 2).requires_grad_() for t in (q, k, v)]
    n = (ops.flash_attention.launches, ops.flash_attention.backward_launches)
    out = ops.flash_attention(*views)
    out.backward(do.transpose(1, 2))
    assert (ops.flash_attention.launches - n[0],
            ops.flash_attention.backward_launches - n[1]) == (1, 1)
    qt, kt, vt = (x.detach() for x in views)
    o2, lse = fa._forward(qt, kt, vt, True, None, None, want_lse=True)
    assert out.shape == (B, H, L, HDV)
    assert _share(out, flash_attention_plain(qt, kt, vt)) <= TOL[
        torch.bfloat16]
    plain = flash_attention_bwd_plain(qt, kt, vt, o2, lse,
                                      do.transpose(1, 2))
    for x, want in zip(views, plain):
        assert _share(x.grad, want) <= TOL[torch.bfloat16]


@pytest.mark.gpu
def test_dropless_grouped_product_on_card(cuda):
    """The layer on the card (one ``torch._grouped_mm`` a matrix, three
    launches a forward) against its plain version on the CPU."""
    cfg = _tiny()
    g = torch.Generator().manual_seed(1)
    p = ly.moe_init(cfg, g, "cpu")
    x = torch.randn((2, 64, cfg.d_model), generator=g).bfloat16()
    bf = {k: ({kk: vv.bfloat16() for kk, vv in v.items()}
              if isinstance(v, dict) else v.bfloat16()) for k, v in p.items()}
    want, _ = ly.moe_apply_dropless(bf, x, cfg)
    n = ly.grouped_matmul.launches
    on = {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
              if isinstance(v, dict) else v.to(cuda)) for k, v in bf.items()}
    got, _ = ly.moe_apply_dropless(on, x.to(cuda), cfg)
    assert ly.grouped_matmul.launches - n == 3
    assert _share(got.cpu(), want) <= TOL[torch.bfloat16]


@pytest.mark.gpu
def test_train_step_launches_the_kernels_once_a_layer(cuda):
    """A DeepSeek-V2 train step of 2 micro-batches on the card, at MLA's
    head dims (q and k 192, v 128): the flash forward and backward launch
    once a layer and micro-batch each (the dense layer's too), the
    grouped product 3 times a MoE layer and micro-batch; the counter
    holds each MoE layer's pairs, all on held experts."""
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.steps import make_train_step
    cfg = dataclasses.replace(
        _tiny(), d_model=256, n_heads=2, n_kv_heads=2, d_ff=512,
        vocab_size=256,
        mla=MLAConfig(q_lora_rank=None, kv_lora_rank=64,
                      qk_nope_head_dim=HD - 64, qk_rope_head_dim=64,
                      v_head_dim=HDV))
    gas, n_moe = 2, cfg.n_layers - cfg.moe.first_k_dense_replace
    model = build_model(cfg)
    state = init_train_state(model, 0, cuda)
    step = make_train_step(model, AdamConfig(warmup_steps=1), gas=gas)
    tok = torch.randint(0, 256, (4, 129), generator=torch.Generator()
                        .manual_seed(0)).to(cuda)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    ops.flash_attention.launches = 0
    ops.flash_attention.backward_launches = 0
    ly.grouped_matmul.launches = 0
    ly.moe_apply_dropless.pairs = None
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(metrics["loss"]))
    assert ops.flash_attention.launches == cfg.n_layers * gas
    assert ops.flash_attention.backward_launches == cfg.n_layers * gas
    assert ly.grouped_matmul.launches == 3 * n_moe * gas
    pairs = ly.moe_apply_dropless.pairs
    assert pairs.shape == (n_moe, len(cfg.moe.held))
    assert int(pairs.sum()) <= n_moe * 4 * 128 * cfg.moe.top_k
