"""The port's ckpt_pack kernels against the JAX package's.

On the CPU the wrappers run their plain PyTorch versions; these are held
against ``repro.kernels.ops`` (Pallas in interpret mode) and
``repro.kernels.ref`` on the same inputs, made with numpy from a seed.
Tolerance: none. Packed bytes, masks and amax must match EXACTLY — the
pack is a bit copy or a round-to-nearest-even cast on both sides, and a
max involves no rounding. Inputs holding NaN compare NaN where NaN (a
non-identity cast may pick another NaN payload).

The tests marked ``gpu`` hold the CUDA kernels against the plain
versions on the card and skip without one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ckpt_pack as cp
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ckpt_pack_dirty_plain, ckpt_pack_plain

RNG = np.random.default_rng(42)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x32: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x32, dtype=jdt), torch.from_numpy(x32).to(tdt)


def _bits(a) -> np.ndarray:
    """Raw bits of a jax array or a torch tensor, as unsigned ints."""
    if isinstance(a, torch.Tensor):
        ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
        a = a.contiguous().view(ints).numpy()
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _same_amax(j, t):
    j, t = np.asarray(j, np.float32), t.numpy()
    np.testing.assert_array_equal(np.isnan(j), np.isnan(t))
    np.testing.assert_array_equal(np.nan_to_num(j), np.nan_to_num(t))


# ------------------------------------------------------ ckpt_pack (B2)
@pytest.mark.parametrize("shape", [(8,), (1000,), (37, 1000), (5, 7, 64),
                                   (8192,), (3, 8192)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ckpt_pack_plain_matches_reference(shape, dtype):
    x32 = RNG.standard_normal(shape).astype(np.float32)
    jx, tx = _pair(x32, dtype)
    jp, ja = jops.ckpt_pack(jx, block=1024)
    tp, ta = ops.ckpt_pack(tx, block=1024)
    assert tp.dtype == torch.bfloat16 and tuple(tp.shape) == (x32.size,)
    np.testing.assert_array_equal(_bits(jp), _bits(tp))
    _same_amax(ja, ta)


@pytest.mark.parametrize("scale", [0.5, 3.0])
def test_ckpt_pack_plain_scale(scale):
    x32 = RNG.standard_normal(2048).astype(np.float32)
    jx, tx = _pair(x32, "float32")
    jp, ja = jops.ckpt_pack(jx, scale=scale, block=1024)
    tp, ta = ops.ckpt_pack(tx, scale=scale, block=1024)
    np.testing.assert_array_equal(_bits(jp), _bits(tp))
    _same_amax(ja, ta)


# --------------------------------------------- ckpt_pack_dirty (B1)
@pytest.mark.parametrize("shape", [(8,), (1000,), (37, 1000), (8192,),
                                   (1023,), (1025,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ckpt_pack_dirty_plain_matches_reference(shape, dtype):
    """Pack, amax and mask equal the Pallas kernel's (interpret mode) and
    ``ref.ckpt_pack_dirty_ref``, pad blocks included."""
    block = 1024
    old = RNG.standard_normal(shape).astype(np.float32)
    new = old.copy()
    idx = RNG.choice(new.size, size=max(1, new.size // 7), replace=False)
    new.reshape(-1)[idx] += 1.0
    jold, told = _pair(old, dtype)
    jnew, tnew = _pair(new, dtype)
    jprev = jops.pack_blocks(jold, block=block)
    tprev = ops.pack_blocks(told, block=block)
    np.testing.assert_array_equal(_bits(jprev), _bits(tprev))
    jp, ja, jm = jops.ckpt_pack_dirty(jnew, jprev, block=block)
    tp, ta, tm = ops.ckpt_pack_dirty(tnew, tprev, block=block)
    rp, ra, rm = jref.ckpt_pack_dirty_ref(jops.pack_blocks(jnew, block=block),
                                          jprev)
    for p, m in ((jp, jm), (rp, rm)):
        np.testing.assert_array_equal(_bits(p), _bits(tp))
        np.testing.assert_array_equal(np.asarray(m), tm.numpy())
    _same_amax(ja, ta)
    _same_amax(ra, ta)
    assert tm.dtype == torch.int32


def _special_blocks(dtype: str, block: int):
    """Old/new images over 6 blocks of raw bits: NaN payloads kept, +0.0
    -> -0.0, a NaN payload changed, a signalling NaN kept, inf kept, one
    value changed. Returns (old bits, new bits, expected mask)."""
    u = np.uint32 if dtype == "float32" else np.uint16
    nan_a, nan_b, snan, neg0, inf = (
        (0x7FC00001, 0x7FC00002, 0x7F800001, 0x80000000, 0x7F800000)
        if dtype == "float32" else (0x7FC1, 0x7FC2, 0x7F81, 0x8000, 0x7F80))
    one = 0x3F800000 if dtype == "float32" else 0x3F80
    old = np.full((6, block), one, u)
    old[0, 5] = nan_a
    old[1, 3] = 0
    old[2, 7] = nan_a
    old[3, 11] = snan
    old[4, 0] = inf
    new = old.copy()
    new[1, 3] = neg0
    new[2, 7] = nan_b
    new[5, block - 1] = 0
    return old, new, np.array([0, 1, 1, 0, 0, 1], np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ckpt_pack_dirty_plain_nan_payloads_and_signed_zero(dtype):
    """Bitwise compare: unchanged NaN payloads (quiet and signalling) read
    clean, a changed payload and +0.0 -> -0.0 read dirty — on both sides,
    with the identity pack keeping every bit."""
    block = 1024
    old, new, want = _special_blocks(dtype, block)
    jdt, tdt = DTYPES[dtype]
    sint = np.int32 if dtype == "float32" else np.int16
    jold = jax.lax.bitcast_convert_type(jnp.asarray(old), jdt)
    jnew = jax.lax.bitcast_convert_type(jnp.asarray(new), jdt)
    told = torch.from_numpy(old.view(sint)).view(tdt)
    tnew = torch.from_numpy(new.view(sint)).view(tdt)
    tp, ta, tm = ops.ckpt_pack_dirty(tnew, ops.pack_blocks(told, block=block),
                                     block=block)
    jp, ja, jm = jops.ckpt_pack_dirty(jnew, jops.pack_blocks(jold,
                                                             block=block),
                                      block=block)
    from repro_torch.core.delta import dirty_byte_spans, mask_to_spans
    isz = old.dtype.itemsize
    host = dirty_byte_spans(old.view(np.uint8), new.view(np.uint8),
                            block * isz)
    assert mask_to_spans(want, block * isz, old.nbytes) == host
    np.testing.assert_array_equal(tm.numpy(), want)
    np.testing.assert_array_equal(_bits(tp).reshape(-1), new.reshape(-1))
    jm = np.asarray(jm).copy()
    if dtype == "bfloat16":
        # the reference's Pallas kernel, interpreted by XLA on the CPU,
        # reads a changed bf16 NaN payload as clean (ROADMAP.md C.3);
        # the host byte compare — both packages' oracle — and the port
        # read it dirty
        assert jm[2] == 0
        jm[2] = 1
    np.testing.assert_array_equal(jm, want)
    jb, tb = _bits(jp).reshape(-1), _bits(tp).reshape(-1)
    if dtype == "float32":
        np.testing.assert_array_equal(jb, tb)
    else:       # the same CPU interpretation may requiet bf16 NaN bits
        nan = np.isnan(np.asarray(jp, np.float32)).reshape(-1)
        np.testing.assert_array_equal(jb[~nan], tb[~nan])
    _same_amax(ja, ta)


def test_ckpt_pack_dirty_plain_clean_and_pad_blocks():
    """Unchanged tensor ⇒ all-clean mask; the zero-pad rule keeps pad
    blocks clean; an all-zero block is clean against an all-zero
    baseline (mask means CHANGED, not nonzero)."""
    x = torch.from_numpy(RNG.standard_normal(3000).astype(np.float32))
    _, _, mask = ops.ckpt_pack_dirty(x, ops.pack_blocks(x, block=1024),
                                     block=1024)
    assert mask.shape == (3,) and not mask.any()
    z = torch.zeros(3000)
    _, _, mz = ops.ckpt_pack_dirty(z, ops.pack_blocks(z, block=1024),
                                   block=1024)
    assert not mz.any()


def test_ckpt_pack_dirty_plain_mask_equals_host_spans():
    """THE device-mask / host-compare equivalence rule (DESIGN.md §10)
    on the port: mask_to_spans(mask) == dirty_byte_spans, clipped tail
    span included."""
    from repro_torch.core.delta import dirty_byte_spans, mask_to_spans
    block = 1024
    for n in (4096, 5000, 1023):
        old = RNG.standard_normal(n).astype(np.float32)
        new = old.copy()
        if n > 100:
            new[5] += 1.0
            new[-1] -= 2.0
        want = dirty_byte_spans(old.view(np.uint8), new.view(np.uint8),
                                block=block * 4)
        _, _, mask = ops.ckpt_pack_dirty(
            torch.from_numpy(new), ops.pack_blocks(torch.from_numpy(old),
                                                   block=block),
            block=block)
        assert mask_to_spans(mask.numpy(), block * 4, old.nbytes) == want


def test_pack_blocks_is_new_storage():
    """The baseline must not alias the tensor it was packed from: the
    optimizer updates parameters in place, and an aliased baseline would
    read as clean when the parameter changed."""
    p = torch.from_numpy(RNG.standard_normal(4096).astype(np.float32))
    prev = ops.pack_blocks(p, block=1024)
    assert prev.untyped_storage().data_ptr() != \
        p.untyped_storage().data_ptr()
    with torch.no_grad():
        p[2000] += 1.0                         # in-place update
    _, _, mask = ops.ckpt_pack_dirty(p, prev, block=1024)
    assert mask.tolist() == [0, 1, 0, 0]
    packed, _, _ = ops.ckpt_pack_dirty(p, prev, block=1024)
    with torch.no_grad():
        p[0] -= 1.0
    assert packed[0, 0] != p[0]                # packed is its own copy


def test_ckpt_pack_dirty_shape_mismatch():
    x = torch.zeros(2048)
    prev = ops.pack_blocks(torch.zeros(4096), block=1024)
    with pytest.raises(ValueError):
        ops.ckpt_pack_dirty(x, prev, block=1024)


def _ssd_args(device):
    return (torch.zeros((1, 1, 16, 2, 32), device=device),
            torch.zeros((1, 1, 16, 2), device=device),
            torch.zeros((1, 1, 16, 2, 16), device=device),
            torch.zeros((1, 1, 16, 2, 16), device=device))


def test_wrappers_never_fall_back_off_the_cpu():
    """The plain version serves CPU tensors only; any other device must
    launch the kernel or raise (a ``meta`` tensor here: no kernel)."""
    x = torch.empty((4, 1024), device="meta")
    with pytest.raises(RuntimeError, match="expected cuda"):
        cp.ckpt_pack_blocks(x)
    with pytest.raises(RuntimeError, match="expected cuda"):
        cp.ckpt_pack_dirty_blocks(x, torch.empty((4, 1024), device="meta"),
                                  out_dtype=torch.float32)
    q = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(RuntimeError, match="expected cuda"):
        ops.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="expected cuda"):
        ops.ssd_intra_chunk(*_ssd_args("meta"))


def test_plain_versions_count_no_launches():
    wrappers = (cp.ckpt_pack_blocks, cp.ckpt_pack_dirty_blocks,
                ops.flash_attention, ops.ssd_intra_chunk)
    before = [w.launches for w in wrappers]
    x = torch.zeros((2, 1024))
    cp.ckpt_pack_blocks(x)
    cp.ckpt_pack_dirty_blocks(x, x.clone(), out_dtype=torch.float32)
    q = torch.zeros((1, 2, 8, 64))
    ops.flash_attention(q, q, q)
    ops.ssd_intra_chunk(*_ssd_args("cpu"))
    assert [w.launches for w in wrappers] == before


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,block", [(torch.float32, 1024),
                                         (torch.bfloat16, 2048)])
def test_dirty_kernel_matches_plain_on_card(cuda, dtype, block):
    g = torch.Generator(device=cuda).manual_seed(0)
    old = torch.randn(3 * block * 7 + 5, generator=g, device=cuda).to(dtype)
    new = old.clone()
    new[::997] += 1
    prev = ops.pack_blocks(old, block=block)
    x2d = ops._to_blocks(new, block)
    n0 = cp.ckpt_pack_dirty_blocks.launches
    got = cp.ckpt_pack_dirty_blocks(x2d, prev, out_dtype=dtype)
    want = ckpt_pack_dirty_plain(x2d, prev, out_dtype=dtype)
    torch.cuda.synchronize()
    assert cp.ckpt_pack_dirty_blocks.launches == n0 + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_pack_kernel_matches_plain_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x2d = torch.randn((64, 4096), generator=g, device=cuda)
    got = cp.ckpt_pack_blocks(x2d, scale=0.5)
    want = ckpt_pack_plain(x2d, scale=0.5)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
