"""Quantized checkpoints of the port against the reference
(``repro.core.quant``, ``repro.core.delta``): the same numpy inputs, made
from a seed, go through both packages.

Bit-exact, no tolerance: ``quantize_stream`` (host amax, and the amax of
``device_block_amax``, which runs the ckpt_pack kernel's plain version
on CPU tensors), ``dequantize_named``, the ``q8`` delta spans, and
quantized keyframes and ``delta_quantize`` chains cross-loading both
ways. The one exception is stated where it applies: the int8 value of a
NaN element is undefined in both packages (a NaN cast to int8), so the
NaN positions of a NaN block are left out of the byte compare. The
trainer leg holds a restore to the quantizer's own bound, amax/254 per
block plus the final rounding. The ``gpu`` legs hold the CUDA kernel's
amax against the host's and the save's ordering, on the card."""
import dataclasses
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import delta as rdelta
from repro.core import quant as rquant
from repro.core import serializer as rser
from repro.core.checkpointer import FastPersistConfig as RefFP
from repro.core.engine import CheckpointEngine as RefEngine
from repro.core.engine import CheckpointSpec as RefSpec
from repro.core.partition import Topology as RefTopology
from repro.models.registry import build_model as ref_build
from repro.train.steps import init_train_state as ref_init_state
from repro_torch import configs as pconfigs
from repro_torch.convert import train_state_from_numpy
from repro_torch.core import delta as pdelta
from repro_torch.core import quant
from repro_torch.core import serializer as pser
from repro_torch.core.checkpointer import (FastPersistCheckpointer,
                                           FastPersistConfig)
from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
from repro_torch.core.partition import Topology
from repro_torch.kernels import ckpt_pack as cp
from repro_torch.launch import train as launch
from repro_torch.train.trainer import CheckpointPolicy, Trainer, TrainerConfig
from repro_torch.tree import flatten

BLOCK = quant.BLOCK
DTYPES = ["float32", "bfloat16", "float16"]
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256)


# ----------------------------------------------------------------- helpers
def _np(x32: np.ndarray, dtype: str) -> np.ndarray:
    return x32.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)


def _torch(a: np.ndarray) -> torch.Tensor:
    """The same bits as a torch tensor (bf16 through its uint16 view)."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return a.detach().reshape(-1).contiguous().view(torch.uint8) \
            .numpy().tobytes()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _edge_state(dtype: str, seed: int = 0, nan: bool = False) -> dict:
    """Records that reach every branch: a ragged tail (3 blocks + 17), an
    all-zero block, ±0.0, a record below BLOCK (passes through), an int
    record; ``nan`` puts NaNs into block 2 of the ragged record."""
    rng = np.random.default_rng(seed)
    rag = (rng.standard_normal(3 * BLOCK + 17) * 5).astype(np.float32)
    rag[BLOCK:2 * BLOCK] = 0.0                       # all-zero block
    rag[7], rag[8] = 0.0, -0.0
    rag[-3:] = [-0.0, 0.0, -0.0]
    if nan:
        rag[2 * BLOCK + 5] = np.nan
        rag[2 * BLOCK + 77] = -np.nan
    wide = (rng.standard_normal((2, BLOCK)) * 1e-3).astype(np.float32)
    return {"rag": _np(rag, dtype), "wide": _np(wide, dtype),
            "small": _np(rng.standard_normal(100).astype(np.float32), dtype),
            "ints": np.arange(7, dtype=np.int32)}


def _quantized_pair(state: dict, amax_fn=None):
    rm, rb = rquant.quantize_stream(*rser.serialize(state))
    pm, pb = quant.quantize_stream(
        *pser.serialize({k: _torch(v) for k, v in state.items()}),
        amax_fn=amax_fn)
    return (rm, rb), (pm, pb)


def _nan_positions(state: dict) -> dict:
    return {k + "#q8": np.isnan(np.asarray(v, np.float32)).reshape(-1)
            for k, v in state.items() if v.dtype.kind == "f"
            or v.dtype == ml_dtypes.bfloat16}


def _assert_same_stream(ref, port, nan_at=None):
    (rm, rb), (pm, pb) = ref, port
    assert [vars(r) for r in pm.records] == [vars(r) for r in rm.records]
    assert pm.total_bytes == rm.total_bytes and pm.extras == rm.extras
    for rec, r, p in zip(rm.records, rb, pb):
        r, p = np.asarray(r), np.asarray(p)
        if "#" in rec.name:     # pass-through buffers: bytes only
            assert p.dtype == r.dtype and p.shape == r.shape, rec.name
        skip = (nan_at or {}).get(rec.name)
        if skip is not None and skip.any():
            # int8 of a NaN is undefined in both packages
            r, p = r.reshape(-1)[~skip], p.reshape(-1)[~skip]
        assert r.tobytes() == p.tobytes(), rec.name


def _stream_bytes(buffers) -> bytes:
    return b"".join(np.ascontiguousarray(b).tobytes() for b in buffers)


# --------------------------------------------------------- quantize_stream
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("amax", ["host", "device_block_amax"])
def test_quantize_stream_bit_equal(dtype, amax):
    state = _edge_state(dtype)
    fn = quant.device_block_amax if amax == "device_block_amax" else None
    ref, port = _quantized_pair(state, amax_fn=fn)
    _assert_same_stream(ref, port)
    (rm, rb), _ = ref, port
    names = [r.name for r in rm.records]
    assert names == ["ints", "rag#q8", "rag#scale", "small", "wide#q8",
                     "wide#scale"]
    assert rm.extras["quantized"]
    scale = dict(zip(names, rb))["rag#scale"]
    assert scale[1] == 1.0                  # the all-zero block


@pytest.mark.parametrize("dtype", DTYPES)
def test_nan_block_amax_and_scale(dtype):
    """A NaN block's amax is NaN in the host reduction, in the kernel's
    plain version and in the reference; its scale is 1.0 on both sides
    (the reference's ``amax > 0`` rule is false for NaN)."""
    state = _edge_state(dtype, seed=1, nan=True)
    want = rquant.block_amax(state["rag"])
    rag = _torch(state["rag"])
    for got in (quant.block_amax(rag), quant.device_block_amax(rag)):
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[2]) and not np.isnan(got[[0, 1, 3]]).any()
        assert np.array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    assert quant.amax_to_scale(want)[2] == rquant.amax_to_scale(want)[2] \
        == 1.0
    ref, port = _quantized_pair(state, amax_fn=quant.device_block_amax)
    _assert_same_stream(ref, port, nan_at=_nan_positions(state))


def test_amax_by_record_name_is_used():
    """``quantize_stream`` takes a record's scale from ``amax_fn`` where it
    gives one and from the host reduction where it returns None: here
    the ``wide`` record (told apart by its size) gets twice its amax,
    ``rag`` the host's; a quantized save of host state takes no device
    scales."""
    state = {k: _torch(v) for k, v in _edge_state("float32").items()}
    m, b = pser.serialize(state)
    host = quant.block_amax(state["wide"])
    qm, qb = quant.quantize_stream(
        m, b, amax_fn=lambda v: (host * 2 if v.numel() == 2 * BLOCK
                                 else None))
    got = dict(zip([r.name for r in qm.records], qb))
    assert np.array_equal(got["wide#scale"], quant.amax_to_scale(host * 2))
    assert np.array_equal(got["rag#scale"], quant.amax_to_scale(
        quant.block_amax(state["rag"])))
    recs, dtypes, _ = quant.quantize_leaves(flatten(state))
    assert dtypes == {"rag#q8": "int8|float32", "wide#q8": "int8|float32"}
    assert not any(isinstance(t, torch.Tensor) and t.is_cuda
                   for _, t in recs)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dequantize_named_bit_equal(dtype):
    state = _edge_state(dtype, seed=2)
    rm, rb = rquant.quantize_stream(*rser.serialize(state))
    data = _stream_bytes(rb)
    want = rquant.dequantize_named(rser.deserialize(rm, data), rm)
    got = quant.dequantize_named(pser.deserialize(rm, bytearray(data)), rm)
    assert sorted(got) == sorted(want) == sorted(state)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == np.shape(w), name
        assert _bits(g) == _bits(w), name


# --------------------------------------------------------------- q8 spans
@pytest.mark.parametrize("dtype", DTYPES)
def test_q8_spans_bit_equal(dtype):
    rng = np.random.default_rng(3)
    vals = (rng.standard_normal(2 * BLOCK + 300) * 3).astype(np.float32)
    vals[BLOCK:2 * BLOCK] = 0.0
    raw = np.ascontiguousarray(rser.portable_view(_np(vals, dtype))).tobytes()
    rp, renc = rdelta.encode_span(raw, dtype, quantize=True)
    pp, penc = pdelta.encode_span(raw, dtype, quantize=True)
    assert penc == renc == "q8"
    assert bytes(pp) == bytes(rp)
    assert pdelta.decode_span(pp, "q8", dtype, len(raw)) == \
        rdelta.decode_span(rp, "q8", dtype, len(raw))
    # raw where q8 is not smaller, for ints, or for a ragged byte count
    for r, dt in ((raw[:4], "float32"), (raw[:2], dtype),
                  (b"\x01\x02\x03", "int32"), (raw[:7], "float32")):
        want, wenc = rdelta.encode_span(r, dt, quantize=True)
        got, genc = pdelta.encode_span(r, dt, quantize=True)
        assert genc == wenc == "raw" and bytes(got) == bytes(want) == r
    with pytest.raises(IOError, match="corruption"):
        pdelta.decode_span(pp[:-1], "q8", dtype, len(raw))


# -------------------------------------------------- cross-load both ways
def _np_state(seed=0):
    cfg = dataclasses.replace(
        rconfigs.reduced(rconfigs.get_config("stablelm_1_6b")), **TINY)
    return jax.tree.map(np.asarray,
                        ref_init_state(ref_build(cfg),
                                       jax.random.PRNGKey(seed)))


def _mutate(tree, seed):
    """A copy with a few elements of every third float leaf and the
    step counter changed (enough dirty 4 KiB blocks for q8 to win)."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, tree)
    for i, (_, a) in enumerate(flatten(out)):
        if a.dtype.kind == "f" or a.dtype == ml_dtypes.bfloat16:
            if i % 3 == 0:
                flat = a.reshape(-1)
                idx = rng.choice(flat.size, max(1, flat.size // 500),
                                 replace=False)
                flat[idx] = (flat[idx].astype(np.float32) + 1).astype(
                    a.dtype)
        else:
            a += 1
    return out


def _vols(root, n):
    return [os.path.join(root, f"vol{i}") for i in range(n)] if n > 1 \
        else None


def _engines(tmp_path, writers, volumes, **fp):
    pd, rd = str(tmp_path / "port"), str(tmp_path / "ref")
    port = CheckpointEngine(CheckpointSpec(
        directory=pd, backend="fastpersist", volumes=_vols(pd + "_v", volumes),
        fp=FastPersistConfig(strategy="replica",
                             topology=Topology(dp_degree=writers), **fp)))
    ref = RefEngine(RefSpec(
        directory=rd, backend="fastpersist", volumes=_vols(rd + "_v", volumes),
        fp=RefFP(strategy="replica", topology=RefTopology(dp_degree=writers),
                 **fp)))
    return port, ref


def _meta(directory, step):
    d = os.path.join(directory, f"ckpt_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(d, "COMMIT")) as f:
        commit = json.load(f)
    return manifest, commit


def _assert_same_named(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert _bits(got[name]) == _bits(w), name


def _cross_load(port, ref, readers):
    """Each package reads both directories; the four results must hold
    the same bits."""
    loads = []
    for eng in (port, ref):
        vols = eng.spec.volumes
        loads.append(CheckpointEngine(CheckpointSpec(
            directory=eng.directory, volumes=vols)).load(parallel=readers))
        loads.append(RefEngine(RefSpec(
            directory=eng.directory, volumes=vols)).load(parallel=readers))
    (pp, _), (pr, _), (rp, _), (rr, man) = loads
    for got in (pp, pr, rp):
        _assert_same_named(got, rr)
    return rr, man


@pytest.mark.parametrize("writers,volumes", [(1, 1), (4, 3)])
@pytest.mark.parametrize("readers", [1, 4])
def test_quantized_keyframe_cross_loads(tmp_path, writers, volumes, readers):
    s = _np_state(1)
    port, ref = _engines(tmp_path, writers, volumes, quantize=True)
    port.save(train_state_from_numpy(s, device="cpu"), 1, {"step": 1}).wait()
    ref.save(s, 1, {"step": 1}).wait()
    pm, pc = _meta(port.directory, 1)
    rm, rc = _meta(ref.directory, 1)
    # the same bytes on disk: records, plan, index, shard CRCs
    assert pm["records"] == rm["records"]
    assert any(r["name"].endswith("#q8") for r in pm["records"])
    assert pm["plan"] == rm["plan"] and pm.get("index") == rm.get("index")
    assert pm["extras"] == rm["extras"] == {"step": 1, "quantized": True}
    assert pc["shards"] == rc["shards"]
    got, man = _cross_load(port, ref, readers)
    assert sorted(got) == sorted(n for n, _ in flatten(s))
    assert man.extras["step"] == 1


@pytest.mark.parametrize("kind", ["delta", "striped"])
@pytest.mark.parametrize("writers,volumes", [(1, 1), (4, 3)])
def test_delta_quantize_chain_cross_loads(tmp_path, kind, writers, volumes):
    fp = dict(keyframe_every=2, delta_quantize=True)
    if kind == "striped":
        fp["delta_stripe_min_mb"] = 0
    s1 = _np_state(2)
    states = [s1, _mutate(s1, 1)]
    port, ref = _engines(tmp_path, writers, volumes, **fp)
    for step, s in enumerate(states, start=1):
        port.save(train_state_from_numpy(s, device="cpu"), step,
                  {"step": step}).wait()
        ref.save(s, step, {"step": step}).wait()
    pm, pc = _meta(port.directory, 2)
    rm, rc = _meta(ref.directory, 2)
    strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                       if k not in ("gen", "base_gen")}
    assert strip(pc["delta"]) == strip(rc["delta"])
    assert pc["delta"]["striped"] == (kind == "striped")
    encs = {row[4] for row in pc["delta"]["spans"]}
    assert "q8" in encs and "raw" in encs
    assert pc["shards"] == rc["shards"]
    got, man = _cross_load(port, ref, readers=4 if writers > 1 else 1)
    assert man.extras == {"step": 2}
    # lossy in the q8 spans; integer records are never quantized
    live = dict(flatten(states[1]))
    assert any(_bits(got[n]) != _bits(live[n]) for n in live)
    ints = [n for n, a in live.items() if a.dtype.kind in "iu"]
    assert ints and all(_bits(got[n]) == _bits(live[n]) for n in ints)


# ------------------------------------------------------------ the trainer
def _q8_bound_check(got: dict, live: dict, records, spans):
    """Restored vs live: bit-equal outside the q8 spans; inside, per
    4096-element block of each span, |x - x̂| ≤ amax/254 plus the f32
    roundings of the division and the product (2^-22·amax) plus, for
    bf16/f16, half an ulp of the result (2^-8 / 2^-11 relative). Returns
    the number of elements checked against the bound."""
    by_off = sorted(records, key=lambda r: r.offset)
    q8 = {}
    for s in spans:
        if s.enc != "q8":
            continue
        rec = next(r for r in reversed(by_off) if r.offset <= s.offset)
        q8.setdefault(rec.name, []).append((s.offset - rec.offset, s.length))
    n_bound = 0
    for name, want in live.items():
        g, w = got[name].detach().reshape(-1), want.reshape(-1)
        if name not in q8:
            assert _bits(got[name]) == _bits(want), name
            continue
        isz = g.element_size()
        inside = torch.zeros(g.numel(), dtype=torch.bool)
        rel = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
               torch.float16: 2.0 ** -11}[g.dtype]
        for off, length in q8[name]:
            lo, n = off // isz, length // isz
            x, xh = w[lo:lo + n].float(), g[lo:lo + n].float()
            pad = (-n) % BLOCK
            amax = torch.cat([x.abs(), x.new_zeros(pad)]).view(-1, BLOCK) \
                .amax(dim=1).repeat_interleave(BLOCK)[:n]
            bound = amax / 254 + amax * 2.0 ** -22 + rel * xh.abs()
            assert bool(((x - xh).abs() <= bound).all()), name
            inside[lo:lo + n] = True
            n_bound += n
        out = ~inside
        assert torch.equal(g.float()[out].view(torch.int32),
                           w.float()[out].view(torch.int32)), name
    return n_bound


def _reduced_cfg():
    return pconfigs.reduced(pconfigs.get_config("stablelm_1_6b"))


def test_trainer_delta_quantize_restores_within_bound(tmp_path):
    d = str(tmp_path / "ckpt")
    pol = CheckpointPolicy(
        directory=d, every=1, backend="fastpersist-pipelined",
        fp=FastPersistConfig(
            device_dirty=True, delta_quantize=True, keyframe_every=2,
            topology=Topology(dp_degree=2)))
    tcfg = TrainerConfig(model=_reduced_cfg(), steps=2, global_batch=2,
                         seq_len=16, checkpoint=pol, log_every=100)
    tr = Trainer(tcfg, device="cpu")
    tr.run()
    first, second = (h.result() for h in tr.saves)
    assert first.delta is None and second.delta is not None
    # the keyframe moved every byte; the device-dirty delta fewer
    assert first.d2h_bytes == first.total_bytes > second.d2h_bytes
    assert any(row[4] == "q8" for row in second.delta["spans"])
    live = {n: t.detach().clone() for n, t in flatten(tr.state)}
    tr2 = Trainer(tcfg, device="cpu")
    assert tr2.restore() == 2 and tr2.data.position == tr.data.position
    got = dict(flatten(tr2.state))
    ref, man = RefEngine(RefSpec(d)).load(parallel=4)
    _assert_same_named(got, ref)            # the reference reads the same
    spans = [rdelta.DeltaSpan.from_list(r) for r in second.delta["spans"]]
    assert _q8_bound_check(got, live, man.records, spans) > 0


def test_launcher_delta_quantize_on_cpu(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    args = ["--arch", "stablelm_1_6b", "--reduced", "--steps", "2",
            "--batch", "2", "--seq", "8", "--ckpt-dir", d, "--every", "1",
            "--keyframe-every", "2", "--delta-quantize", "--device", "cpu",
            "--dp", "2"]
    launch.main(args)
    assert "done: loss=" in capsys.readouterr().out
    _, commit = _meta(d, 2)
    assert any(row[4] == "q8" for row in commit["delta"]["spans"])
    launch.main(args[:4] + ["3"] + args[5:] + ["--restore"])
    out = capsys.readouterr().out
    assert "restored from step 2" in out and "done: loss=" in out


# ------------------------------------------------- the checkpointer rules
def test_quantized_save_is_monolithic_and_never_a_delta(tmp_path):
    """The reference's two rules for quantized saves: no chunked
    snapshot, and no delta even with keyframe_every > 1."""
    ck = FastPersistCheckpointer(str(tmp_path), FastPersistConfig(
        quantize=True, keyframe_every=2, snapshot_chunk_mb=1))
    state = {k: _torch(v) for k, v in _edge_state("float32").items()}
    for step in (1, 2):
        st = ck.save(state, step)
        assert st.delta is None and st.snapshot_chunks == 0
        assert st.device_scales == {} and st.quantize_seconds > 0
    got, man = ck.load(2, like=state)
    assert man.extras["quantized"] and ck.last_dequantize_seconds > 0
    assert _bits(got["ints"]) == _bits(state["ints"])
    assert _bits(got["small"]) == _bits(state["small"])


def test_load_tensor_reads_quantized_records(tmp_path):
    s = _np_state(3)
    eng = CheckpointEngine(CheckpointSpec(str(tmp_path), fp=FastPersistConfig(
        quantize=True, strategy="replica", topology=Topology(dp_degree=4))))
    eng.save(train_state_from_numpy(s, device="cpu"), 1)
    name = ".opt/.master/embed"
    q, scale = eng.load_tensor(name + "#q8"), eng.load_tensor(name + "#scale")
    want_q, want_s = rquant._blockwise(np.asarray(dict(flatten(s))[name]))
    assert q.dtype == torch.int8 and _bits(q) == _bits(want_q)
    assert _bits(scale) == _bits(want_s)


def test_device_amax_never_falls_back():
    """``device_block_amax`` on anything but a CPU tensor launches the
    kernel or raises (a ``meta`` tensor here: no kernel)."""
    with pytest.raises(RuntimeError, match="expected cuda"):
        quant.launch_block_amax(torch.empty(BLOCK, device="meta"))


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_amax_matches_host_on_card(cuda, dtype):
    state = _edge_state(dtype, seed=4, nan=True)
    x = _torch(state["rag"]).to(cuda)
    n0 = cp.ckpt_pack_blocks.launches
    got = quant.device_block_amax(x)
    assert cp.ckpt_pack_blocks.launches == n0 + 1
    want = rquant.block_amax(state["rag"])
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


@pytest.mark.gpu
def test_quantized_save_amax_is_the_snapshots(cuda, tmp_path):
    """A pipelined quantized save quantizes on the card (one ckpt_quant
    launch per record, no ckpt_pack_blocks) and writes the int8 values
    and scales of the values the snapshot saw, though the caller updates
    a parameter in place as soon as ``wait_snapshot`` returns."""
    g = torch.Generator(device=cuda).manual_seed(5)
    state = {"w": torch.randn(64 * BLOCK, generator=g, device=cuda),
             "b": torch.randn(8 * BLOCK, generator=g,
                              device=cuda).to(torch.bfloat16)}
    snap = {k: v.cpu().clone() for k, v in state.items()}
    eng = CheckpointEngine(CheckpointSpec(
        str(tmp_path), backend="fastpersist-pipelined",
        fp=FastPersistConfig(quantize=True)))
    n0, p0 = cp.ckpt_quant_blocks.launches, cp.ckpt_pack_blocks.launches
    h = eng.save(state, 1)
    eng.wait_snapshot()
    state["w"].mul_(4.0)                     # in place, after the snapshot
    st = h.result()
    eng.close()
    assert cp.ckpt_quant_blocks.launches == n0 + 2
    assert cp.ckpt_pack_blocks.launches == p0
    assert st.quantize_seconds == 0.0
    assert st.d2h_bytes == st.total_bytes == sum(
        t.numel() + 4 * (t.numel() // BLOCK) for t in snap.values())
    rd = CheckpointEngine(CheckpointSpec(str(tmp_path)))
    for name in ("w", "b"):
        q, scale = quant._blockwise(snap[name])
        assert np.array_equal(st.device_scales[name], scale), name
        assert _bits(rd.load_tensor(name + "#scale")) == _bits(scale), name
        assert _bits(rd.load_tensor(name + "#q8")) == _bits(q), name
