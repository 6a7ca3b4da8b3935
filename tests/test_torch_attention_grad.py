"""The gradient of the port's flash attention, and the train step's route
to it.

On the CPU: the plain version of the backward kernels' arithmetic
(``ref.flash_attention_bwd_plain``: P recomputed from the forward's
base-2 log-sum-exp, D = rowsum(dO ∘ O), dS taken as a bf16 hi + lo pair
for bf16 inputs) against autograd of the model's plain attention
(``layers.attention``), and both against float64; the autograd Function
of the wrapper carrying that backward; and the route of
``transformer._block``, which sends a cacheless attention to the kernels
only for a bf16 CUDA tensor without a window or a soft-cap, so that every
CPU run, and on the card every other case, keeps ``layers.attention``.

Tolerances, as a share of the largest magnitude of the gradient:
float32 1e-5 (the same function summed in another order, D taken from
dO ∘ O where autograd sums dP ∘ P; read 1.2e-6 at most); bfloat16 1e-2
against float64 (each side rounds its output to bf16, 2^-9 relative,
and autograd of the plain attention rounds P and dP to bf16 as well:
both read 2e-3 to 5e-3) and 2e-2, the repo's bf16 kernel tolerance,
between the two.

The tests marked ``gpu`` hold the CUDA kernels against the plain
versions and against autograd of ``layers.attention`` on the card, and
skip without one."""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from repro_torch import configs as pconfigs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (flash_attention_bwd_plain,
                                     flash_attention_plain)
from repro_torch.models import layers as ly
from repro_torch.models.registry import build_model, make_batch
from repro_torch.tree import leaves, tree_map

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TOL_BF16_TRUTH = 1e-2


def _inputs(B, L, H, KV, hd, dtype, seed, device="cpu"):
    """q (B, L, H, hd), k, v (B, L, KV, hd) and dO, the model's layout."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, L, H, hd), generator=g, device=device)
    k, v = (torch.randn((B, L, KV, hd), generator=g, device=device)
            for _ in range(2))
    do = torch.randn((B, L, H, hd), generator=g, device=device)
    return [t.to(dtype) for t in (q, k, v, do)]


def _autograd(q, k, v, do, dtype=None):
    """(dq, dk, dv) of ``layers.attention`` (causal), in ``dtype`` if
    given (the inputs upcast first), the model's layout."""
    xs = [(t if dtype is None else t.to(dtype)).detach().requires_grad_()
          for t in (q, k, v)]
    pos = torch.arange(q.shape[1], device=q.device)
    ly.attention(*xs, q_pos=pos, kv_pos=pos).backward(
        do if dtype is None else do.to(dtype))
    return [x.grad for x in xs]


def _plain(q, k, v, do):
    """(dq, dk, dv) of the plain backward, the model's layout."""
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    out, lse = flash_attention_plain(qt, kt, vt, lse=True)
    return [g.transpose(1, 2) for g in flash_attention_bwd_plain(
        qt, kt, vt, out, lse, dot)]


def _share(got, want) -> float:
    """The largest |got - want| over the largest |want|."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("rep", [1, 4])
def test_plain_backward_matches_autograd(dtype, hd, rep):
    """The plain backward from the log-sum-exp, at L 70 (a ragged tile),
    2 KV heads of ``rep`` query heads each, causal."""
    q, k, v, do = _inputs(2, 70, 2 * rep, 2, hd, dtype, seed=hd + rep)
    got = _plain(q, k, v, do)
    auto = _autograd(q, k, v, do)
    truth = _autograd(q, k, v, do, torch.float64)
    for g, a, t, x in zip(got, auto, truth, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        assert _share(g, a) <= TOL[dtype]
        if dtype == torch.bfloat16:
            assert _share(g, t) <= TOL_BF16_TRUTH


@pytest.mark.parametrize("rep", [1, 3])
def test_function_carries_the_plain_backward_on_cpu(rep):
    """``_Attention`` on CPU tensors (the model's strided views): the
    plain forward's output, the plain backward's gradients bit for bit,
    and nothing of size L × L saved for the backward."""
    q, k, v, do = _inputs(2, 70, 2 * rep, 2, 64, torch.bfloat16, seed=rep)
    views = [t.transpose(1, 2).requires_grad_() for t in (q, k, v)]
    out = fa._Attention.apply(*views, True, None, None)
    saved = {tuple(t.shape) for t in out.grad_fn.saved_tensors}
    assert saved == {tuple(x.shape) for x in views} | {(2, 2 * rep, 70)}
    out.backward(do.transpose(1, 2))
    assert torch.equal(out, flash_attention_plain(*views))
    for got, want in zip(views, _plain(q, k, v, do)):
        assert torch.equal(got.grad, want.transpose(1, 2))


@pytest.mark.parametrize("kw", [{"window": 16}, {"cap": 30.0},
                                {"dtype": torch.float32}])
def test_backward_refuses_what_its_kernels_do_not_take(kw):
    """A window, a soft-cap or float32 inputs: the forward runs, the
    backward raises (no fallback)."""
    dtype = kw.pop("dtype", torch.bfloat16)
    q, k, v, do = _inputs(1, 40, 2, 2, 64, dtype, seed=1)
    views = [t.transpose(1, 2).requires_grad_() for t in (q, k, v)]
    out = fa._Attention.apply(*views, True, kw.get("window"), kw.get("cap"))
    with pytest.raises(RuntimeError, match="no backward"):
        out.backward(do.transpose(1, 2))


def _on_card(q):
    """``q`` as ``kernel_takes`` would see it on the card."""
    return SimpleNamespace(is_cuda=True, dtype=q.dtype, shape=q.shape)


@pytest.mark.parametrize("case,takes", [
    ({}, True), ({"hd": 80}, True), ({"hd": 128}, True),
    ({"window": 8}, False), ({"cap": 50.0}, False),
    ({"dtype": torch.float32}, False), ({"hd": 72}, False),
    ({"cpu": True}, False)])
def test_kernel_takes(case, takes):
    """What the route reads off the input: a CUDA tensor, bf16, a head
    dim in ``HEAD_DIMS``, no window and no soft-cap."""
    q = torch.empty((1, 8, 2, case.get("hd", 64)),
                    dtype=case.get("dtype", torch.bfloat16))
    x = q if case.get("cpu") else _on_card(q)
    assert fa.kernel_takes(x, case.get("window"), case.get("cap")) is takes


#: the route's cases: (config changes, compute dtype, prefill with a cache)
ROUTE = {
    "cpu": ({}, torch.bfloat16, False),
    "window": ({"window_size": 8, "global_every": 2}, torch.bfloat16, False),
    "cap": ({"attn_softcap": 30.0}, torch.bfloat16, False),
    "cache": ({}, torch.bfloat16, True),
    "f32": ({}, torch.float32, False),
}


def _route_run(cfg, dtype, cache):
    """Logits and (without a cache) the gradients of the loss, with the
    model's current route."""
    model = build_model(cfg, dtype=dtype)
    params = tree_map(lambda t: t.clone().requires_grad_(),
                      model.init(0, "cpu"))
    batch = make_batch(cfg, 2, 24, device="cpu")
    if cache:
        with torch.no_grad():
            kv = model.init_cache(2, 24, "cpu")
            return [model.prefill(params, batch, kv)[0]]
    logits, _ = model.forward(params, batch)
    grads = torch.autograd.grad(model.loss(params, batch), leaves(params))
    return [logits, *grads]


@pytest.mark.parametrize("case", list(ROUTE))
def test_route_keeps_the_plain_attention(case, monkeypatch):
    """With a window, a soft-cap, a cache or f32 compute, the route takes
    ``layers.attention`` even where ``kernel_takes`` sees a card; on CPU
    tensors (``cpu``) it does so by itself. Logits and gradients are
    bit-equal to a run with the route closed."""
    changes, dtype, cache = ROUTE[case]
    cfg = dataclasses.replace(
        pconfigs.reduced(pconfigs.get_config("stablelm_1_6b")), **changes)
    closed = None
    with monkeypatch.context() as m:
        m.setattr(fa, "kernel_takes", lambda *a, **k: False)
        closed = _route_run(cfg, dtype, cache)
    real = fa.kernel_takes
    if case != "cpu":
        monkeypatch.setattr(fa, "kernel_takes", lambda q, window=None,
                            cap=None: real(_on_card(q), window, cap))

    def refuse(*a, **k):
        raise AssertionError("the route called the kernel")
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return plain_attention(*a, **k)
    plain_attention = ly.attention
    monkeypatch.setattr(fa, "flash_attention", refuse)
    monkeypatch.setattr(ly, "attention", counted)
    got = _route_run(cfg, dtype, cache)
    # a layer's attention once a forward: prefill, or forward and loss
    assert len(calls) == cfg.n_layers * (1 if cache else 2)
    for a, b in zip(got, closed):
        assert torch.equal(a, b)


def test_route_takes_the_kernel_where_it_applies(monkeypatch):
    """Where ``kernel_takes`` sees a bf16 card tensor with no window, cap
    or cache, every layer's attention goes to ``fa.flash_attention`` in
    (B, H, L, hd) views and comes back in the model's layout: here its
    CPU version, within the bf16 tolerance of the plain route."""
    cfg = pconfigs.reduced(pconfigs.get_config("stablelm_1_6b"))
    closed = _route_run(cfg, torch.bfloat16, False)
    real, kernel = fa.kernel_takes, fa.flash_attention
    calls = []

    def counted(q, k, v, **kw):
        assert q.shape[1] == cfg.n_heads and q.shape[-1] == 64
        calls.append(kw)
        return kernel(q, k, v, **kw)
    monkeypatch.setattr(fa, "kernel_takes", lambda q, window=None, cap=None:
                        real(_on_card(q), window, cap))
    monkeypatch.setattr(fa, "flash_attention", counted)
    got = _route_run(cfg, torch.bfloat16, False)
    assert calls == [{"cap": None}] * (2 * cfg.n_layers)   # forward, loss
    torch.testing.assert_close(got[0].float(), closed[0].float(), atol=2e-2,
                               rtol=2e-2)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KV,L,hd,causal", [
    (4, 8, 8, 2048, 80, True),          # gpt3_2_7b_tp4's step
    (4, 8, 8, 2048, 128, True),         # gpt3_1_3b_tp2's step
    (4, 48, 8, 768, 128, True),         # internvl2_26b, GQA 6:1
    (4, 32, 32, 512, 64, True),         # stablelm_1_6b
    (4, 16, 16, 512, 96, True),         # gpt3_0_7b
    (2, 4, 2, 200, 64, True),           # L % 64
    (1, 6, 2, 77, 96, True),
    (1, 4, 2, 200, 80, False),
])
def test_backward_matches_plain_on_card(cuda, B, H, KV, L, hd, causal):
    """The kernels' output, log-sum-exp, dq, dk and dv against the plain
    versions (from the kernel's own output and log-sum-exp) and, causal,
    against autograd of ``layers.attention`` on the card; one forward and
    one backward launch."""
    q, k, v, do = _inputs(B, L, H, KV, hd, torch.bfloat16, seed=L + hd,
                          device=cuda)
    views = [t.transpose(1, 2).requires_grad_() for t in (q, k, v)]
    n = (ops.flash_attention.launches, ops.flash_attention.backward_launches)
    out = ops.flash_attention(*views, causal=causal)
    out.backward(do.transpose(1, 2))
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches - n[0],
            ops.flash_attention.backward_launches - n[1]) == (1, 1)
    got = [x.grad for x in views]
    assert all(g.stride() == x.stride() for g, x in zip(got, views))
    qt, kt, vt = (x.detach() for x in views)
    o2, lse = fa._forward(qt, kt, vt, causal, None, None, want_lse=True)
    assert torch.equal(o2, out.detach())
    want_o, want_lse = flash_attention_plain(qt, kt, vt, causal=causal,
                                             lse=True)
    torch.testing.assert_close(out.float(), want_o.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse[..., :L], want_lse, atol=1e-4, rtol=1e-5)
    assert bool(torch.isinf(lse[..., L:]).all())
    plain = flash_attention_bwd_plain(qt, kt, vt, o2, lse, do.transpose(1, 2),
                                      causal=causal)
    auto = _autograd(q, k, v, do) if causal else plain
    for g, p, a in zip(got, plain, auto):
        assert _share(g, p) <= TOL[torch.bfloat16]
        assert _share(g, a.transpose(1, 2) if causal else a) \
            <= TOL[torch.bfloat16]


@pytest.mark.gpu
def test_train_step_launches_the_kernels(cuda):
    """A bf16 train step of a reduced dense model on the card: one forward
    and one backward launch a layer a micro-batch, gradients within the
    bf16 tolerance of the plain route's."""
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    cfg = dataclasses.replace(
        pconfigs.reduced(pconfigs.get_config("stablelm_1_6b")), n_layers=3)
    model = build_model(cfg)
    batch = make_batch(cfg, 4, 128, device=cuda)
    state = init_train_state(model, 0, cuda)
    n = (ops.flash_attention.launches, ops.flash_attention.backward_launches)
    make_train_step(model, AdamConfig(), gas=2)(state, batch)
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches - n[0],
            ops.flash_attention.backward_launches - n[1]) == (6, 6)
