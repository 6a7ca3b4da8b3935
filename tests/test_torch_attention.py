"""The port's flash attention (kernel B3) against the JAX package's.

On the CPU the wrapper runs its plain PyTorch version; it is held
against ``repro.kernels.ops.flash_attention`` (Pallas in interpret mode)
and ``repro.kernels.ref.flash_attention_ref`` on the same inputs, made
with numpy from a seed, over the shapes, dtypes and variants of
tests/test_kernels.py at its tolerances: 2e-5 (float32; 3e-5 for the
window / cap / non-causal variants), 2e-2 (bfloat16: every side
computes in float32 and rounds the output once to bfloat16, so an
element may land one bfloat16 ulp away).

The CUDA kernel's bfloat16 body departs from that arithmetic in one
place: it rounds the softmax weights P to bfloat16 for the P·V product
on the tensor cores (QKᵀ of bfloat16 inputs is exact in float32, and the
row sum is taken over the float32 weights). That adds at most 2^-9
relative per weight, below the bfloat16 output's own 2^-8 rounding, so
the bfloat16 tolerance stays 2e-2; ``_kernel_bf16`` emulates that
arithmetic tile by tile and is held against the reference on the CPU.
Its float32 body takes every product as three TF32 products (each
operand split into hi = tf32(x) and lo = tf32(x - hi), lo·lo dropped,
about 2^-21 relative per product); ``_kernel_f32`` emulates that split
with the TF32 rounding of tests/test_torch_mamba2.py and is held to the
float32 tolerances at every head dim the kernel takes (64, 80, 96, 128).

The tests marked ``gpu`` hold the CUDA kernel against the plain version
on the card and skip without one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_plain
from test_torch_mamba2 import _split_matmul, _tf32

LOG2E = 1.4426950408889634
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(B, H, KV, Lq, Lk, hd, dtype="float32", seed=0):
    """The same q, k, v as jax arrays and torch tensors."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Lq, hd), (B, KV, Lk, hd), (B, KV, Lk, hd))]
    return ([jnp.asarray(a, dtype=jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, wants, tol):
    for want in wants:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("B,H,KV,L,hd", [
    (1, 4, 4, 128, 64),       # MHA
    (2, 8, 2, 256, 64),       # GQA 4:1
    (1, 4, 1, 384, 128),      # MQA, non-pow2 length
    (1, 2, 2, 100, 64),       # unaligned length (padding path)
    (1, 4, 2, 128, 80),       # gpt3_2_7b's head dim
    (1, 2, 2, 100, 96),       # gpt3_0_7b's head dim, unaligned length
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_sweep(B, H, KV, L, hd, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(B, H, KV, L, L, hd, dtype, seed=L + hd)
    got = ops.flash_attention(q, k, v)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, [jops.flash_attention(jq, jk, jv, block_q=128, block_k=128),
                 jref.flash_attention_ref(jq, jk, jv)],
           2e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("knob", ["block_q", "block_k"])
def test_pallas_tiling_is_not_taken(knob):
    """The kernel's 64 x 64 tiling is fixed: the reference's tiling
    arguments raise instead of being ignored."""
    _, (q, k, v) = _qkv(1, 2, 2, 64, 64, 64)
    with pytest.raises(TypeError, match=knob):
        ops.flash_attention(q, k, v, **{knob: 64})


@pytest.mark.parametrize("kwargs", [
    {"window": 64}, {"cap": 50.0}, {"causal": False},
    {"window": 32, "cap": 30.0},
])
def test_plain_matches_reference_variants(kwargs):
    (jq, jk, jv), (q, k, v) = _qkv(1, 4, 2, 256, 256, 64, seed=7)
    got = ops.flash_attention(q, k, v, **kwargs)
    _close(got, [jops.flash_attention(jq, jk, jv, **kwargs),
                 jref.flash_attention_ref(jq, jk, jv, **kwargs)], 3e-5)


def test_plain_matches_reference_cross_lengths():
    (jq, jk, jv), (q, k, v) = _qkv(1, 4, 4, 128, 512, 64, seed=3)
    got = ops.flash_attention(q, k, v, causal=False)
    _close(got, [jops.flash_attention(jq, jk, jv, causal=False),
                 jref.flash_attention_ref(jq, jk, jv, causal=False)], 2e-5)


def test_windowed_rows_without_a_valid_key_are_finite():
    """Queries past Lk + window - 1 see no valid key under a causal
    window (ROADMAP C.2): with the -1e30 mask value every masked logit is
    equal, so such a row averages v over the Lk keys — no NaN, as in the
    reference (Lk is a block multiple, so the Pallas kernel's zero
    padding adds no keys to the average)."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 2, 2, 256, 128, 64, seed=11)
    got = ops.flash_attention(q, k, v, window=32)
    assert torch.isfinite(got).all()
    empty = got[:, :, 128 + 32 - 1:]
    torch.testing.assert_close(
        empty, v.mean(dim=2, keepdim=True).expand_as(empty), atol=1e-6,
        rtol=1e-6)
    _close(got, [jops.flash_attention(jq, jk, jv, window=32),
                 jref.flash_attention_ref(jq, jk, jv, window=32)], 3e-5)


def _online_softmax(q, k, v, scores, pv, *, causal, window, cap, tile=64):
    """The CUDA kernel's loop, emulated: scores of each 64-key tile from
    ``scores(q, k_tile)``, scaled (soft-capped) and kept in base 2 (times
    log2 e), masked at -1e30, an online softmax with float32 running max
    and sum, and the two terms ``pv(p, v_tile)`` returns (hi·hi and the
    small terms, or the product and 0) added to two rescaled
    accumulators; returns their sum / max(l, 1e-30) in float32."""
    B, H, Lq, hd = q.shape
    rep, Lk = H // k.shape[1], k.shape[2]
    qf = q.float()
    kf, vf = (t.repeat_interleave(rep, dim=1).float() for t in (k, v))
    m = torch.full((B, H, Lq, 1), -1e30)
    l = torch.zeros((B, H, Lq, 1))
    acc = [torch.zeros((B, H, Lq, hd)), torch.zeros((B, H, Lq, hd))]
    qpos = torch.arange(Lq)[:, None]
    for k0 in range(0, Lk, tile):
        kpos = torch.arange(k0, min(k0 + tile, Lk))[None, :]
        s = scores(qf, kf[:, :, k0:k0 + tile]) / hd ** 0.5
        if cap is not None:
            s = cap * torch.tanh(s / cap)
        s = s * LOG2E
        ok = torch.ones_like(qpos >= kpos)
        if causal:
            ok &= qpos >= kpos
        if window is not None:
            ok &= qpos - kpos < window
        s = torch.where(ok, s, -1e30)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - mn), torch.exp2(s - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = [a * alpha + term
               for a, term in zip(acc, pv(p, vf[:, :, k0:k0 + tile]))]
        m = mn
    return (acc[0] + acc[1]) / l.clamp_min(1e-30)


def _kernel_bf16(q, k, v, *, causal=True, window=None, cap=None):
    """The bfloat16 body of the CUDA kernel, emulated: float32 scores of
    the bfloat16 q, k (exact products), P rounded to bfloat16 against the
    bfloat16 v with float32 accumulation, the output rounded to
    bfloat16."""
    return _online_softmax(
        q, k, v, lambda a, b: a @ b.transpose(-1, -2),
        lambda p, b: (p.to(torch.bfloat16).float() @ b, 0.0), causal=causal,
        window=window, cap=cap).to(torch.bfloat16)


def _kernel_f32(q, k, v, *, causal=True, window=None, cap=None):
    """The float32 body of the CUDA kernel, emulated: Q Kᵀ and P V as
    3×TF32 products (hi·hi + hi·lo + lo·hi of operands split with the
    TF32 rounding cvt.rna, lo·lo dropped), the small terms summed apart:
    in S per tile, in the output over all tiles. Its sums are IEEE
    float32, so it bounds the split's error, not the tensor cores'
    accumulation (the ``gpu`` tests hold that)."""
    def pv(p, b):
        ph, bh = _tf32(p), _tf32(b)
        pl, bl = _tf32(p - ph), _tf32(b - bh)
        return ph @ bh, ph @ bl + pl @ bh

    return _online_softmax(
        q, k, v, lambda a, b: _split_matmul(a, b.transpose(-1, -2), _tf32),
        pv, causal=causal, window=window, cap=cap)


@pytest.mark.parametrize("kwargs", [{}, {"window": 64, "cap": 30.0}])
def test_kernel_bf16_arithmetic_matches_reference(kwargs):
    """The bfloat16 body's arithmetic (P rounded to bfloat16), emulated,
    within 2e-2 of the Pallas kernel (interpret mode) and the reference
    at (B, H, KV, L, hd) = (1, 4, 4, 512, 64), causal."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 4, 4, 512, 512, 64, "bfloat16",
                                   seed=13)
    got = _kernel_bf16(q, k, v, **kwargs)
    assert got.dtype == torch.bfloat16
    _close(got, [jops.flash_attention(jq, jk, jv, **kwargs),
                 jref.flash_attention_ref(jq, jk, jv, **kwargs)], 2e-2)
    # and within the same tolerance of the port's plain version
    torch.testing.assert_close(
        got.float(), flash_attention_plain(q, k, v, **kwargs).float(),
        atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("hd,kwargs,tol", [
    (64, {}, 2e-5), (80, {}, 2e-5), (96, {}, 2e-5), (128, {}, 2e-5),
    (64, {"window": 64}, 3e-5), (64, {"cap": 50.0}, 3e-5),
    (64, {"causal": False}, 3e-5), (64, {"window": 32, "cap": 30.0}, 3e-5),
])
def test_kernel_f32_arithmetic_matches_reference(hd, kwargs, tol):
    """The float32 body's 3×TF32 arithmetic, emulated, within the float32
    tolerances (2e-5; 3e-5 for the variants) of the Pallas kernel
    (interpret mode) and the reference at (B, H, KV, L) = (1, 4, 2, 256),
    and of the port's plain version."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 4, 2, 256, 256, hd, seed=17 + hd)
    got = _kernel_f32(q, k, v, **kwargs)
    assert got.dtype == torch.float32 and got.shape == q.shape
    _close(got, [jops.flash_attention(jq, jk, jv, **kwargs),
                 jref.flash_attention_ref(jq, jk, jv, **kwargs),
                 flash_attention_plain(q, k, v, **kwargs)], tol)


def test_strided_views_read_like_contiguous_tensors():
    """The model hands the kernel (B, L, H, hd) tensors swapped to
    (B, H, L, hd): strided views give the contiguous result."""
    _, (q, k, v) = _qkv(2, 4, 2, 64, 64, 64, seed=5)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(ops.flash_attention(*views),
                               flash_attention_plain(q, k, v), atol=0,
                               rtol=0)


@pytest.mark.parametrize("dtype,hd,kw,err", [
    (torch.float16, 64, {}, TypeError),
    (torch.float32, 72, {}, ValueError),
    (torch.float32, 64, {"window": 0}, ValueError),
    (torch.float32, 64, {"cap": 0.0}, ValueError),
])
def test_kernel_refuses_what_it_does_not_take(dtype, hd, kw, err):
    """Off the CPU (``meta`` here), arguments the CUDA kernel does not
    take raise before any launch."""
    q = torch.empty((1, 2, 8, hd), dtype=dtype, device="meta")
    with pytest.raises(err, match="flash_attention"):
        ops.flash_attention(q, q, q, **kw)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KV,Lq,Lk,hd,kw", [
    (4, 32, 32, 512, 512, 64, {}),                    # stablelm_1_6b
    (2, 8, 2, 256, 256, 64, {}),
    (1, 4, 1, 384, 384, 128, {}),
    (1, 2, 2, 100, 100, 64, {}),
    (1, 4, 2, 256, 256, 64, {"window": 64}),
    (1, 4, 2, 256, 256, 64, {"cap": 50.0}),
    (1, 4, 2, 256, 256, 64, {"causal": False}),
    (1, 4, 2, 256, 256, 64, {"window": 32, "cap": 30.0}),
    (1, 4, 4, 128, 512, 64, {"causal": False}),
    (1, 2, 2, 256, 128, 64, {"window": 32}),          # rows with no key
    (1, 4, 2, 200, 200, 128, {}),                     # hd 128, Lq % 64
    (1, 4, 4, 200, 200, 128, {"window": 48, "cap": 30.0}),
    (2, 2, 2, 77, 300, 64, {"causal": False}),        # Lq, Lk % 64
    (4, 32, 32, 512, 512, 80, {}),                    # gpt3_2_7b
    (4, 16, 16, 512, 512, 96, {}),                    # gpt3_0_7b
    (1, 4, 2, 200, 200, 80, {"window": 48, "cap": 30.0}),
    (2, 2, 2, 77, 300, 96, {"causal": False}),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda, B, H, KV, Lq, Lk, hd, kw, dtype):
    g = torch.Generator(device=cuda).manual_seed(Lq + Lk + hd)
    q = torch.randn((B, Lq, H, hd), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((B, Lk, KV, hd), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))    # the model's views
    n0 = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n0 + 1
    assert got.dtype == dtype and got.stride() == q.stride()
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
