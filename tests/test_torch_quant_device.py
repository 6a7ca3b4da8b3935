"""The quantize mode of the port's ckpt_pack kernel (``ckpt_quant``) and
the quantized save and restore built on it, against the reference
(``repro.core.quant``): the same numpy inputs, made from a seed, go
through both packages.

Bit-exact, no tolerance: ``ckpt_quant_plain`` (the kernel's plain
version, which the wrapper runs for CPU tensors) against the reference's
``_blockwise`` on ragged tails, zero blocks, exact ``.5`` ties both ways
and subnormals in f32, bf16 and f16; the one-pass dequantize of a
restore onto the card (run here on CPU tensors) against the reference's
``_deblock``; a quantized save through the kernel's route, byte for byte
the host ``quantize_stream``'s, cross-loading both ways. C.10: the int8
value of a non-finite element is undefined in both packages, so those
positions are left out of the int8 compare; the scales are compared
everywhere. The ``gpu`` legs hold the CUDA kernel against its plain
version and the reference, and the dequantize on the card."""
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import quant as rquant
from repro.core.checkpointer import FastPersistConfig as RefFP
from repro.core.engine import CheckpointEngine as RefEngine
from repro.core.engine import CheckpointSpec as RefSpec
from repro.core.partition import Topology as RefTopology
from repro_torch.core import quant
from repro_torch.core import serializer as pser
from repro_torch.core.checkpointer import (FastPersistCheckpointer,
                                           FastPersistConfig)
from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
from repro_torch.core.partition import Topology
from repro_torch.kernels import ckpt_pack as cp
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ckpt_quant_plain

BLOCK = quant.BLOCK
DTYPES = ["float32", "bfloat16", "float16"]
KEYS = ["f32", "bf16", "f16"]
KINDS = ["ragged", "zeros", "ties", "subnormal", "nonfinite"]


def _np(x32: np.ndarray, dtype: str) -> np.ndarray:
    return x32.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)


def _torch(a: np.ndarray) -> torch.Tensor:
    """The same bits as a torch tensor (bf16 through its uint16 view)."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().reshape(-1).contiguous().view(torch.uint8) \
            .numpy().tobytes()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _ties(k: np.ndarray, scale: float) -> np.ndarray:
    """A block whose amax is 127·scale and whose values divide to k + 0.5
    exactly: round half to even goes down for even k, up for odd k."""
    blk = np.empty(BLOCK, np.float32)
    blk[:-2] = (np.resize(k, BLOCK - 2) + 0.5) * scale
    blk[-2:] = 127 * scale, -127 * scale
    return blk


def _case(kind: str, dtype: str, seed: int = 0) -> np.ndarray:
    """Values in ``dtype`` (exactly representable there) that reach one
    branch of the quantizer; every case ends in a ragged tail."""
    rng = np.random.default_rng(seed)
    tail = rng.standard_normal(37).astype(np.float32)
    if kind == "ragged":
        x = rng.standard_normal(3 * BLOCK + 17).astype(np.float32) * 5
    elif kind == "zeros":                    # a zero block, a zero tail
        x = rng.standard_normal(3 * BLOCK + 5).astype(np.float32)
        x[BLOCK:2 * BLOCK] = 0.0
        x[3 * BLOCK:] = -0.0
        tail = np.zeros(0, np.float32)
    elif kind == "ties":                     # scales 1, 2 and 1/2
        k = np.arange(-126, 127, dtype=np.float32)
        x = np.concatenate([_ties(k, 1.0), _ties(k, 2.0), _ties(k, 0.5)])
    elif kind == "subnormal":                # below the dtype's normals
        tiny = 1e-6 if dtype == "float16" else 1e-39
        x = rng.standard_normal(2 * BLOCK).astype(np.float32) * tiny
        tail = tail * tiny
    else:                                    # NaN, inf and -inf blocks
        x = rng.standard_normal(4 * BLOCK).astype(np.float32)
        x[5], x[BLOCK + 9], x[2 * BLOCK + 3] = np.nan, np.inf, -np.inf
    out = _np(np.concatenate([x, tail]), dtype)
    if kind in ("ties", "subnormal"):
        assert (out.astype(np.float32) != 0).sum() > BLOCK
    if kind == "ties":
        assert np.array_equal(out[:x.size].astype(np.float32), x)
    return out


def _assert_same_quant(q, scale, want_q, want_s, x: np.ndarray):
    finite = np.isfinite(np.asarray(x, np.float32)).reshape(-1)
    q = np.asarray(q).reshape(-1)
    assert q.dtype == np.int8 and q.shape == want_q.shape
    assert np.array_equal(q[finite], want_q[finite])
    assert np.asarray(scale).tobytes() == want_s.tobytes()


# -------------------------------------------------------- the plain version
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ckpt_quant_plain_bit_equal_to_blockwise(dtype, kind):
    """``ckpt_quant_plain`` on the zero-padded rows, and ``ops.ckpt_quant``
    (its wrapper, the plain version for a CPU tensor), against the
    reference's ``_blockwise``: int8 values and scales bit for bit."""
    x = _case(kind, dtype)
    with np.errstate(invalid="ignore"):
        want_q, want_s = rquant._blockwise(x)
    t = _torch(x)
    q2d, s = ckpt_quant_plain(cp.to_blocks(t, BLOCK))
    assert q2d.shape == (-(-x.size // BLOCK), BLOCK)
    _assert_same_quant(q2d.reshape(-1)[:x.size], s, want_q, want_s, x)
    n0 = cp.ckpt_quant_blocks.launches
    q, s = ops.ckpt_quant(t.reshape(-1, 1), block=BLOCK)
    assert cp.ckpt_quant_blocks.launches == n0      # no kernel on the CPU
    _assert_same_quant(q, s, want_q, want_s, x)
    if kind == "ties":                       # k + 0.5 goes to the even
        k = np.arange(-126, 127)
        assert s[:3].tolist() == [1.0, 2.0, 0.5]
        assert np.array_equal(q.numpy()[:k.size], k + (k % 2 != 0))


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ckpt_quant_host_passes_bit_equal(monkeypatch, dtype, rows):
    """The wrapper's plain version quantizes a host tensor ``PLAIN_ROWS``
    rows per pass (a bounded f32 temporary whatever the leaf's size);
    with passes of 1 and 3 rows over 4 blocks and a ragged tail it still
    gives the reference's ``_blockwise`` bit for bit."""
    x = _case("ragged", dtype, seed=9)
    want_q, want_s = rquant._blockwise(x)
    monkeypatch.setattr(cp, "PLAIN_ROWS", rows)
    q, s = ops.ckpt_quant(_torch(x))
    _assert_same_quant(q, s, want_q, want_s, x)


def test_ckpt_quant_never_falls_back():
    """``ckpt_quant`` on anything but a CPU tensor launches the kernel or
    raises (a ``meta`` tensor here: no kernel)."""
    with pytest.raises(RuntimeError, match="expected cuda"):
        ops.ckpt_quant(torch.empty(BLOCK, device="meta"))
    with pytest.raises(ValueError, match="flat"):
        cp.ckpt_quant_blocks(torch.zeros(2, BLOCK))


# ------------------------------------------------------------- dequantize
@pytest.mark.parametrize("kind", ["ragged", "zeros", "ties"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_one_pass_dequantize_bit_equal_to_deblock(dtype, kind):
    """The restore onto the card dequantizes each record in one pass
    (``_deblock_whole``); run here on CPU tensors, it gives the
    reference's ``_deblock`` bit for bit."""
    x = _case(kind, dtype, seed=1)
    q, s = rquant._blockwise(x)
    want = rquant._deblock(q, s, dtype)
    got = quant._deblock_whole(torch.from_numpy(q), torch.from_numpy(s),
                               dtype)
    assert got.dtype == quant._TORCH[dtype] and got.shape == (x.size,)
    assert _bits(got) == _bits(want)


# ------------------------------------------------------ the quantized save
def _edge_state(seed: int = 0) -> dict:
    """A record of each float dtype with a ragged tail and a zero block,
    one below BLOCK (passes through) and an int record."""
    state = {key: _case("zeros" if dt == "float16" else "ragged", dt,
                        seed + i)
             for i, (key, dt) in enumerate(zip(KEYS, DTYPES))}
    rng = np.random.default_rng(seed)
    state["small"] = rng.standard_normal(100).astype(np.float32)
    state["ints"] = np.arange(7, dtype=np.int32)
    return state


def test_quantized_save_goes_through_ckpt_quant(tmp_path, monkeypatch):
    """A quantized save of CPU state quantizes each float record with
    ``ops.ckpt_quant`` before the snapshot (the host stream quantizer
    never runs), snapshots only the int8 values, scales and the records
    that pass through, and writes the bytes of the host
    ``quantize_stream`` of the same state."""
    state = {k: _torch(v) for k, v in _edge_state().items()}
    calls = []
    real = ops.ckpt_quant

    def counted(x, **kw):
        calls.append(tuple(x.shape))
        return real(x, **kw)

    def never(*a, **kw):
        raise AssertionError("the save ran the host stream quantizer")

    monkeypatch.setattr(ops, "ckpt_quant", counted)
    monkeypatch.setattr(quant, "quantize_stream", never)
    ck = FastPersistCheckpointer(str(tmp_path), FastPersistConfig(
        quantize=True, strategy="replica", topology=Topology(dp_degree=1)))
    st = ck.save(state, 1, extras={"step": 1})
    monkeypatch.undo()
    assert calls == [(3 * BLOCK + 54,), (3 * BLOCK + 5,), (3 * BLOCK + 54,)]
    wm, wb = quant.quantize_stream(*pser.serialize(state))
    want = b"".join(np.ascontiguousarray(b).tobytes() for b in wb)
    assert st.d2h_bytes == st.total_bytes == wm.total_bytes == len(want)
    assert st.quantize_seconds > 0 and st.device_scales == {}
    assert st.snapshot_chunks == 0 and st.delta is None
    with open(os.path.join(ck.path(1), "manifest.json")) as f:
        meta = json.load(f)
    assert meta["records"] == [vars(r) | {"shape": list(r.shape)}
                               for r in wm.records]
    assert meta["extras"] == {"step": 1, "quantized": True}
    assert [r["dtype"] for r in meta["records"]
            if r["name"].endswith("#q8")] == [
        "int8|bfloat16", "int8|float16", "int8|float32"]
    with open(os.path.join(ck.path(1), "shard_000.bin"), "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("readers", [None, 4])
def test_quantized_edge_save_cross_loads(tmp_path, readers):
    """The port's quantized save of the edge records (ragged tails, zero
    blocks, all three float dtypes) loads bit-exact through the
    reference's engine and the reference's through the port's, onto the
    host with and without ``device="cpu"``."""
    s = _edge_state(seed=3)
    pd, rd = str(tmp_path / "port"), str(tmp_path / "ref")
    fp = dict(quantize=True, strategy="replica")
    CheckpointEngine(CheckpointSpec(pd, fp=FastPersistConfig(
        topology=Topology(dp_degree=2), **fp))).save(
        {k: _torch(v) for k, v in s.items()}, 1, {"step": 1}).wait()
    RefEngine(RefSpec(rd, fp=RefFP(topology=RefTopology(dp_degree=2),
                                   **fp))).save(s, 1, {"step": 1}).wait()
    for name in ("manifest.json", "shard_000.bin", "shard_001.bin"):
        with open(os.path.join(pd, "ckpt_00000001", name), "rb") as a, \
                open(os.path.join(rd, "ckpt_00000001", name), "rb") as b:
            if name == "manifest.json":
                ma, mb = json.load(a), json.load(b)
                for k in ("generation", "treedef"):     # nonce; C.4
                    ma.pop(k, None), mb.pop(k, None)
                assert ma == mb
            else:
                assert a.read() == b.read(), name
    kw = {} if readers is None else {"parallel": readers}
    want, _ = RefEngine(RefSpec(rd)).load(**kw)
    for d in (pd, rd):
        for got, _ in (CheckpointEngine(CheckpointSpec(d)).load(**kw),
                       CheckpointEngine(CheckpointSpec(d)).load(
                           device="cpu", **kw),
                       RefEngine(RefSpec(d)).load(**kw)):
            assert sorted(got) == sorted(want) == sorted(s)
            for n in s:
                assert _bits(got[n]) == _bits(want[n]), (d, n)


def test_restore_device_reaches_the_dequantizer(tmp_path, monkeypatch):
    """``engine.load(device=...)`` hands the device to the dequantizer
    (a ``meta`` device here stands for the card: the one-pass path runs
    on it) and keeps the host path for ``device="cpu"``."""
    s = {k: _torch(v) for k, v in _edge_state(seed=4).items()}
    eng = CheckpointEngine(CheckpointSpec(str(tmp_path), fp=FastPersistConfig(
        quantize=True, strategy="replica", topology=Topology(dp_degree=2))))
    eng.save(s, 1).wait()
    seen = []
    real = quant._deblock_whole

    def spy(q, scale, dtype):
        seen.append((q.device.type, scale.device.type, dtype))
        return real(q, scale, dtype)

    monkeypatch.setattr(quant, "_deblock_whole", spy)
    host, _ = eng.load(device="cpu", parallel=2)
    assert seen == []
    got, _ = eng.load(device="meta", parallel=2)
    assert sorted(seen) == [("meta", "meta", dt) for dt in sorted(DTYPES)]
    for n, t in s.items():
        assert got[n].device.type == "meta"
        assert got[n].dtype == t.dtype and got[n].shape == t.shape
        assert host[n].dtype == t.dtype and host[n].shape == t.shape


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ckpt_quant_kernel_matches_plain_on_card(cuda, dtype, kind):
    x = _case(kind, dtype, seed=5)
    t = _torch(x).to(cuda)
    n0 = cp.ckpt_quant_blocks.launches
    q, s = ops.ckpt_quant(t)
    assert cp.ckpt_quant_blocks.launches == n0 + 1
    pq, ps = ckpt_quant_plain(cp.to_blocks(t, BLOCK))
    torch.cuda.synchronize()
    with np.errstate(invalid="ignore"):
        want_q, want_s = rquant._blockwise(x)
    _assert_same_quant(q.cpu(), s.cpu(), want_q, want_s, x)
    _assert_same_quant(pq.reshape(-1)[:x.size].cpu(), ps.cpu(), want_q,
                       want_s, x)


@pytest.mark.gpu
@pytest.mark.parametrize("block", [8, 1024, 4096])
def test_ckpt_quant_kernel_blocks_on_card(cuda, block):
    x = _case("ragged", "float32", seed=6)
    t = _torch(x).to(cuda)
    q, s = ops.ckpt_quant(t, block=block)
    pq, ps = ckpt_quant_plain(cp.to_blocks(t, block))
    assert torch.equal(q, pq.reshape(-1)[:x.size])
    assert torch.equal(s.view(torch.int32), ps.view(torch.int32))
    with pytest.raises(ValueError, match="at most"):
        ops.ckpt_quant(t, block=4104)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_dequantize_on_card_matches_deblock(cuda, dtype):
    x = _case("ragged", dtype, seed=7)
    q, s = rquant._blockwise(x)
    got = quant._deblock(q, s, dtype, device=cuda)
    assert got.is_cuda
    assert _bits(got) == _bits(rquant._deblock(q, s, dtype))


@pytest.mark.gpu
def test_quantized_restore_onto_card(cuda, tmp_path):
    """State on the card saved quantized and restored onto the card:
    dequantized there, bit-equal to the reference's host restore."""
    s = _edge_state(seed=8)
    eng = CheckpointEngine(CheckpointSpec(str(tmp_path), fp=FastPersistConfig(
        quantize=True, strategy="replica", topology=Topology(dp_degree=2))))
    st = eng.save({k: _torch(v).to(cuda) for k, v in s.items()}, 1).result()
    assert st.quantize_seconds == 0.0
    assert sorted(st.device_scales) == sorted(KEYS)
    got, _ = eng.load(device=cuda, parallel=2)
    want, _ = RefEngine(RefSpec(str(tmp_path))).load()
    for n in s:
        assert got[n].is_cuda and _bits(got[n]) == _bits(want[n]), n
    assert eng._payload.ckpt.last_dequantize_seconds > 0


@pytest.mark.gpu
def test_quantized_save_frees_its_device_copies(cuda, tmp_path):
    """Once the snapshot of a pipelined quantized save is released, the
    card holds the state and nothing of the save: its int8 values and
    scales are freed while it persists and commits."""
    g = torch.Generator(device=cuda).manual_seed(11)
    state = {"w": torch.randn(64 * BLOCK, generator=g, device=cuda),
             "b": torch.randn(8 * BLOCK, generator=g,
                              device=cuda).to(torch.bfloat16)}
    eng = CheckpointEngine(CheckpointSpec(
        str(tmp_path), backend="fastpersist-pipelined",
        fp=FastPersistConfig(quantize=True)))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    h = eng.save(state, 1)
    eng.wait_snapshot()
    held = torch.cuda.memory_allocated(cuda)
    st = h.result()
    eng.close()
    assert st.d2h_bytes == st.total_bytes
    assert held == base, f"the save holds {held - base} B on the card"
