"""The fused Adam kernel (``kernels/adam.py``, ``csrc/adam.cu``) and the
train step's f32 accumulation.

The step sums the micro-batch gradients in f32 (the first one written,
the others added in bf16, which ``add_`` promotes) and Adam takes the
mean's ``1/gas`` in its norm and clip scale. On the CPU the step is held
bit for bit against the unfolded arithmetic, written out here: a zeroed
f32 accumulator, an f32 copy of each micro-batch gradient, the mean
taken before Adam, and the per-leaf update as plain PyTorch ops. For a
power-of-two ``gas`` each folded step is exact in f32, so nothing may
differ. The wrapper's guards are held on the CPU with meta and fake CUDA
tensors.

The tests marked ``gpu`` hold the kernel against ``adam_plain`` bit for
bit on the card, on f32 and bf16 gradients, leaves of 1, 2,560, 2,561
(a scalar tail) and 10,240 x 2,560 elements and unaligned views, over 3
steps that cross the warm-up with the clip active and idle; and the
whole train step at gas 1, 2 and 4 against the plain path and the
unfolded arithmetic. They skip without a card."""
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs as pconfigs
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.kernels import adam as kadam
from repro_torch.kernels import build
from repro_torch.kernels.ref import adam_plain
from repro_torch.models.registry import build_model
from repro_torch.optim import adam
from repro_torch.optim.adam import AdamConfig, AdamState
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.tree import flatten, leaves

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256)
#: a clip far below the gradients' norm, and one far above it
CLIPS = {"clip_active": 1e-3, "clip_idle": 1e9}
#: 3 steps over a 2-step warm-up: lr at 1/2, 1 and 1 of its peak
STEPS, WARMUP = 3, 2
ROWS, SEQ = 4, 16


def _model():
    cfg = dataclasses.replace(
        pconfigs.reduced(pconfigs.get_config("stablelm_1_6b")), **TINY)
    return build_model(cfg), cfg


def _opt(clip: str) -> AdamConfig:
    return AdamConfig(lr=1e-2, warmup_steps=WARMUP, grad_clip=CLIPS[clip])


def _batches(vocab: int, device):
    data = TokenStream(DataConfig(vocab, SEQ, ROWS, seed=3), device=device)
    return [data.peek(i) for i in range(STEPS)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().contiguous()
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _assert_same(a, b, what=""):
    for (name, x), (_, y) in zip(flatten(a), flatten(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)), \
            f"{what}{name}"


def _unfolded_step(model, cfg: AdamConfig, gas: int):
    """The train step with the mean taken before Adam, every operation a
    plain PyTorch op."""
    def step(state, batch):
        ps = leaves(state.params)
        for p in ps:
            p.requires_grad_(True)
        if gas == 1:
            loss = model.loss(state.params, batch)
            grads = torch.autograd.grad(loss, ps)
        else:
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in ps]
            loss = 0.0
            for mb in range(gas):
                micro = {k: v.reshape(gas, v.shape[0] // gas,
                                      *v.shape[1:])[mb]
                         for k, v in batch.items()}
                lm = model.loss(state.params, micro)
                for acc, g in zip(grads, torch.autograd.grad(lm, ps)):
                    acc.add_(g.float())
                loss = loss + lm.detach()
            grads = [g / gas for g in grads]
            loss = loss / gas
        with torch.no_grad():
            opt = state.opt
            opt.step.add_(1)
            t = opt.step.float()
            gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
            lr = cfg.lr * torch.clamp(t / cfg.warmup_steps, max=1.0)
            b1c = 1 - cfg.b1 ** t
            b2c = 1 - cfg.b2 ** t
            for g, p, mw, m, v in zip(grads, ps, leaves(opt.master),
                                      leaves(opt.m), leaves(opt.v)):
                g = g.float() * scale
                m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
                v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
                update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
                mw.sub_(lr * (update + cfg.weight_decay * mw))
                p.copy_(mw)
        return state, {"loss": loss.detach().float()}
    return step


def _run_both(step_a, step_b, model, mcfg, device):
    """Run the two steps from the same state over the same batches,
    asserting the states and losses bit-equal after each step."""
    sa = init_train_state(model, 7, device)
    sb = init_train_state(model, 7, device)
    for i, batch in enumerate(_batches(mcfg.vocab_size, device)):
        sa, ma = step_a(sa, batch)
        sb, mb = step_b(sb, batch)
        assert torch.equal(_bits(ma["loss"]), _bits(mb["loss"])), i
        _assert_same(sa, sb, f"step {i + 1}: ")
    assert int(sa.opt.step) == STEPS
    return sa


# ----------------------------------------------------------------- CPU
@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("gas", [1, 2, 4])
def test_step_bit_equal_to_unfolded_arithmetic(gas, clip):
    model, mcfg = _model()
    cfg = _opt(clip)
    before = kadam.adam_update_.launches
    state = _run_both(make_train_step(model, cfg, gas),
                      _unfolded_step(model, cfg, gas), model, mcfg, "cpu")
    # the weights moved, so the comparison compared an update
    fresh = init_train_state(model, 7, "cpu")
    assert any(not torch.equal(a, b) for a, b in zip(
        leaves(state.opt.master), leaves(fresh.opt.master)))
    assert kadam.adam_update_.launches == before


def test_plain_path_counts_no_launches():
    params = [torch.randn(33).to(torch.bfloat16), torch.randn(4, 8).bfloat16()]
    state = adam.init(params)
    grads = [torch.randn(p.shape) for p in params]
    before = kadam.adam_update_.launches
    adam.apply_(_opt("clip_idle"), grads, params, state, gas=2)
    assert kadam.adam_update_.launches == before
    assert int(state.step) == 1


def test_meta_leaves_run_the_plain_version():
    """The dry run counts the step on meta tensors: no kernel, no raise."""
    params = [torch.empty(16, 8, dtype=torch.bfloat16, device="meta")]
    state = adam.init(params)
    grads = [torch.empty(16, 8, device="meta")]
    before = kadam.adam_update_.launches
    adam.apply_(_opt("clip_idle"), grads, params, state, gas=4)
    assert kadam.adam_update_.launches == before
    assert state.master[0].device.type == "meta"


def _leaf_args(device, shape=(6, 4), grad_dtype=torch.float32):
    make = lambda dt: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    return ([make(grad_dtype)], [make(torch.bfloat16)],
            [make(torch.float32)], [make(torch.float32)],
            [make(torch.float32)])


def _scalars(device):
    return [torch.ones((), device=device) for _ in range(4)]


@pytest.fixture
def no_build(monkeypatch):
    """A build or a load would mean a guard let a bad call through."""
    def refuse(*a, **k):
        raise AssertionError("the wrapper reached the kernel's library")
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)


@pytest.mark.parametrize("odd", ["grad", "param", "master", "v", "scale"])
@pytest.mark.parametrize("other", ["meta", "cuda"])
def test_wrapper_raises_on_mixed_devices(no_build, odd, other):
    cfg = _opt("clip_idle")
    args = list(_leaf_args("cpu"))
    scal = _scalars("cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        if other == "cuda":
            elsewhere = _leaf_args("cuda")
            away = _scalars("cuda")[0]
        else:
            elsewhere = _leaf_args("meta")
            away = _scalars("meta")[0]
        pos = {"grad": 0, "param": 1, "master": 2, "v": 4}
        if odd == "scale":
            scal[0] = away
        else:
            args[pos[odd]] = elsewhere[pos[odd]]
        with pytest.raises(RuntimeError, match="tensors? on"):
            kadam.adam_update_(cfg, *args, *scal)


@pytest.mark.parametrize("bad", ["grad", "param", "master", "m", "v"])
def test_wrapper_raises_on_non_contiguous_cuda_leaf(no_build, bad):
    cfg = _opt("clip_idle")
    with FakeTensorMode():
        args = list(_leaf_args("cuda", shape=(6, 4)))
        pos = ["grad", "param", "master", "m", "v"].index(bad)
        t = args[pos][0]
        args[pos] = [torch.zeros((4, 6), dtype=t.dtype, device="cuda").t()]
        assert args[pos][0].shape == (6, 4)
        assert not args[pos][0].is_contiguous()
        before = kadam.adam_update_.launches
        with pytest.raises(ValueError, match="not contiguous"):
            kadam.adam_update_(cfg, *args, *_scalars("cuda"))
        assert kadam.adam_update_.launches == before


@pytest.mark.parametrize("case", ["grad_f16", "param_f32", "m_bf16",
                                  "shape", "scalar_bf16"])
def test_wrapper_raises_on_bad_cuda_leaf(no_build, case):
    cfg = _opt("clip_idle")
    with FakeTensorMode():
        args = list(_leaf_args("cuda"))
        scal = _scalars("cuda")
        if case == "grad_f16":
            args[0] = [args[0][0].half()]
        elif case == "param_f32":
            args[1] = [args[1][0].float()]
        elif case == "m_bf16":
            args[3] = [args[3][0].bfloat16()]
        elif case == "shape":
            args[4] = [torch.zeros(24, device="cuda")]
        else:
            scal[1] = scal[1].bfloat16()
        err = ValueError if case == "shape" else TypeError
        with pytest.raises(err, match="adam"):
            kadam.adam_update_(cfg, *args, *scal)


# ------------------------------------------------------------- on card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


#: leaf shapes: one element, the norms' 2,560, a scalar tail, the MLP's
SIZES = {"1": (1,), "2560": (2560,), "2561": (2561,),
         "10240x2560": (10240, 2560)}


def _leaf(shape, dtype, device, offset: int):
    """A contiguous leaf; ``offset`` elements into its storage when > 0,
    so that no pointer is 16-byte aligned (the kernel's scalar path)."""
    n = 1
    for s in shape:
        n *= s
    return torch.empty(n + offset, dtype=dtype,
                       device=device)[offset:].view(shape)


def _state(w: torch.Tensor, offset: int):
    """(params, AdamState) of one leaf from f32 weights ``w``."""
    dev = w.device
    p = _leaf(w.shape, torch.bfloat16, dev, offset)
    p.copy_(w)
    master, m, v = (_leaf(w.shape, torch.float32, dev, offset)
                    for _ in range(3))
    master.copy_(p)
    m.zero_()
    v.zero_()
    return [p], AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                          [master], [m], [v])


@pytest.mark.gpu
@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("size", [*SIZES, "2561_unaligned"])
@pytest.mark.parametrize("grad", ["float32", "bfloat16"])
def test_kernel_bit_equal_to_plain_on_card(cuda, monkeypatch, grad, size,
                                           clip):
    shape = SIZES[size.split("_")[0]]
    offset = 1 if size.endswith("unaligned") else 0
    gdt = getattr(torch, grad)
    # an f32 gradient is a sum of 4 micro-batches, a bf16 one stands alone
    gas = 4 if gdt == torch.float32 else 1
    cfg = _opt(clip)
    gen = torch.Generator(device=cuda).manual_seed(11)
    w = torch.randn(shape, generator=gen, device=cuda)
    pk, sk = _state(w, offset)
    pp, sp = _state(w, offset)
    for step in range(STEPS):
        g = _leaf(shape, gdt, cuda, offset)
        g.copy_(torch.randn(shape, generator=gen, device=cuda) * 1e-2)
        before = kadam.adam_update_.launches
        adam.apply_(cfg, [g], pk, sk, gas)
        assert kadam.adam_update_.launches == before + 1
        with monkeypatch.context() as mp:
            mp.setattr(adam, "adam_update_", adam_plain)
            adam.apply_(cfg, [g], pp, sp, gas)
            assert kadam.adam_update_.launches == before + 1
        torch.cuda.synchronize()
        _assert_same((pk, sk), (pp, sp), f"step {step + 1}: ")
    assert not torch.equal(sk.master[0], w)


@pytest.mark.gpu
@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("gas", [1, 2, 4])
def test_train_step_bit_equal_to_plain_on_card(cuda, monkeypatch, gas,
                                               clip):
    model, mcfg = _model()
    cfg = _opt(clip)
    kernel_step = make_train_step(model, cfg, gas)
    n_leaves = len(leaves(init_train_state(model, 7, "meta").params))
    launches = []

    def counted(state, batch):
        before = kadam.adam_update_.launches
        out = kernel_step(state, batch)
        launches.append(kadam.adam_update_.launches - before)
        return out

    plain_step = make_train_step(model, cfg, gas)

    def plain(state, batch):
        with monkeypatch.context() as mp:
            mp.setattr(adam, "adam_update_", adam_plain)
            return plain_step(state, batch)

    _run_both(counted, plain, model, mcfg, cuda)
    assert launches == [n_leaves] * STEPS
    _run_both(kernel_step, _unfolded_step(model, cfg, gas), model, mcfg,
              cuda)
