"""Owned-span reads of the port (DESIGN.md §7: ``load_owned`` /
``read_owned``, ``allgather_owned``, ``zero1_ownership``) against the
reference's, on the CPU: for every reader count in {1, 2, 4} and
ownership in {None (byte stripe), "zero1"}, each rank reads the
reference's spans and bytes, the allgather of all ranks is the state
``load`` gives, and the ZeRO-1 projection equals the reference's on the
full-width stablelm_1_6b records. No tolerance: bytes."""
import pytest
import torch

import test_torch_faults as faults
from repro.sharding.specs import zero1_ownership as ref_zero1
from repro_torch import configs
from repro_torch.core.checkpointer import allgather_owned
from repro_torch.core.serializer import TensorRecord, deserialize
from repro_torch.models.registry import build_model
from repro_torch.sharding.specs import zero1_ownership
from repro_torch.train.steps import init_train_state
from repro_torch.tree import flatten
from test_torch_tiers import engine, save_all


def _span_tuple(s):
    return (s.reader, s.shard_index, s.shard_offset, s.stream_offset,
            s.length)


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("ownership", [None, "zero1"])
@pytest.mark.parametrize("n_readers", [1, 2, 4])
def test_read_owned_equals_reference(tmp_path, writer, ownership,
                                     n_readers):
    w = engine(writer, str(tmp_path / "w"), kind="striped")
    save_all(writer, w, [faults.np_state(5)])
    port = engine("port", str(tmp_path / "w"), kind="striped")
    ref = engine("ref", str(tmp_path / "w"), kind="striped")
    reads = []
    for rank in range(n_readers):
        a = port.load_owned(rank, n_readers, ownership=ownership)
        b = ref.load_owned(rank, n_readers, ownership=ownership)
        assert [_span_tuple(s) for s in a.spans] == \
            [_span_tuple(s) for s in b.spans]
        assert a.nbytes == b.nbytes and bytes(a.buffer) == bytes(b.buffer)
        fa, fb = a.tensor_fragments(), b.tensor_fragments()
        assert sorted(fa) == sorted(fb)
        for name in fa:
            assert [(o, bytes(m)) for o, m in fa[name]] == \
                [(o, bytes(m)) for o, m in fb[name]], name
        reads.append(a)
    via_load = port.load_owned(0, n_readers, ownership=ownership)
    assert bytes(via_load.buffer) == bytes(reads[0].buffer)
    assert bytes(port.load(owned_only=True, reader_rank=n_readers - 1,
                           n_readers=n_readers,
                           ownership=ownership).buffer) == \
        bytes(reads[-1].buffer)
    # the single-host allgather rebuilds the stream ``load`` reads
    stream = allgather_owned(reads)
    state = deserialize(reads[0].manifest, stream)
    full, _ = port.load()
    assert sorted(state) == sorted(full)
    for name, t in state.items():
        assert torch.equal(t.view(torch.uint8) if t.dtype == torch.bfloat16
                           else t,
                           full[name].view(torch.uint8)
                           if t.dtype == torch.bfloat16 else full[name]), \
            name
    faults.assert_equal_state(state, faults.np_state(5))


def test_allgather_refuses_a_missing_rank(tmp_path):
    w = engine("port", str(tmp_path / "w"), kind="striped")
    save_all("port", w, [faults.np_state()])
    reads = [w.load_owned(r, 4) for r in range(3)]
    with pytest.raises(IOError, match="missing"):
        allgather_owned(reads)


def test_owned_reads_refuse_delta_generations(tmp_path):
    w = engine("port", str(tmp_path / "w"), kind="chain")
    save_all("port", w, [faults.np_state(), faults.mutate(
        faults.np_state(), 1)])
    with pytest.raises(NotImplementedError, match="delta"):
        w.load_owned(0, 2, step=2)
    assert w.load_owned(0, 2, step=1).nbytes > 0


def _records(arch):
    """The on-stream records of ``arch``'s full train state, without
    allocating it (meta tensors)."""
    state = init_train_state(build_model(configs.get_config(arch)), 0,
                             "meta")
    recs, off = [], 0
    for name, t in flatten(state):
        dtype = str(t.dtype).replace("torch.", "")
        n = t.numel() * t.element_size()
        recs.append(TensorRecord(name, dtype, tuple(t.shape), off, n))
        off += n
    return recs


@pytest.mark.parametrize("n_readers", [1, 2, 3, 4, 8])
def test_zero1_ownership_equals_reference_on_stablelm(n_readers):
    recs = _records("stablelm_1_6b")
    # the full-width state chip_smoke.py saves: 49 records, 23.0 GB
    assert len(recs) == 49
    assert sum(r.nbytes for r in recs) == 23_019_745_284
    got = zero1_ownership(recs, n_readers)
    assert got == ref_zero1(recs, n_readers)
    for r in recs:                  # every byte owned exactly once
        spans = sorted((lo, hi) for _, lo, hi in got[r.name])
        assert spans[0][0] == 0 and spans[-1][1] == r.nbytes
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
