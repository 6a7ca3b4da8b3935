"""The port's snapshot arena: the device-dirty equivalence rule (DESIGN.md
§10) — on the CPU, where the kernel wrappers run their plain versions,
the device-dirty spans equal ``dirty_byte_spans`` of the host images —
including parameters updated IN PLACE between saves (a baseline that
aliased them would read clean), and the chunked snapshot's watermark.
Exact: spans and bytes are compared for equality."""
import numpy as np
import pytest
import torch

from repro_torch.core.arena import SerializeArena
from repro_torch.core.delta import dirty_byte_spans
from repro_torch.tree import flatten, treedef_str

BLOCK = 4096
RNG = np.random.default_rng(7)


def _state():
    """Records the device path takes (f32/bf16 ≥ one block, ragged
    tails) and ones it does not (short, int32)."""
    t = lambda n: torch.from_numpy(  # noqa: E731
        RNG.standard_normal(n).astype(np.float32))
    return {"a": t(4 * 1024),                      # 4 blocks f32
            "b": t(3 * 2048 + 5).to(torch.bfloat16),   # ragged bf16
            "c": t(1024 * 9 + 100),                 # ragged f32
            "d": t(100),                            # shorter than a block
            "e": torch.arange(2000, dtype=torch.int32),
            "s": torch.zeros((), dtype=torch.int32)}


def _image(state) -> dict:
    return {n: t.reshape(-1).contiguous().view(torch.uint8).numpy().copy()
            for n, t in flatten(state)}


def _spans_from_images(manifest, before, after):
    out = []
    for rec in manifest.records:
        out += [(rec.offset + o, ln) for o, ln in
                dirty_byte_spans(before[rec.name], after[rec.name], BLOCK)]
    return out


def _save(arena, state, device_dirty, chunk=0):
    leaves = flatten(state)
    if not chunk:
        return arena.serialize(leaves, treedef_str(state), track_dirty=True,
                               dirty_block=BLOCK, device_dirty=device_dirty)
    manifest, buffers, progress, fill = arena.begin_snapshot(
        leaves, treedef_str(state), chunk, track_dirty=True,
        dirty_block=BLOCK, device_dirty=device_dirty)
    fill()
    progress.wait_done()
    assert progress.filled == manifest.total_bytes
    return manifest, buffers


def _stream_equals(manifest, buffers, state):
    img = _image(state)
    for rec, buf in zip(manifest.records, buffers):
        assert buf.reshape(-1).view(np.uint8).tobytes() == \
            img[rec.name].tobytes(), rec.name


@pytest.mark.parametrize("chunk", [0, 8192])
def test_device_dirty_spans_equal_host_compare(chunk):
    state = _state()
    dev, host = SerializeArena(), SerializeArena()
    for arena, dd in ((dev, True), (host, False)):
        _save(arena, state, dd, chunk)
    assert dev.last_dirty is None            # first fill: no baseline
    with torch.no_grad():                    # an optimizer-style step
        before = _image(state)
        state["a"][5] += 1                   # block 0 of a
        state["b"][-1] += 1                  # the ragged tail block of b
        state["c"][1024 * 3 + 1] *= 2        # block 3 of c
        state["e"][7] += 1                   # host path (int32)
        state["s"].add_(1)
    after = _image(state)
    m_dev, b_dev = _save(dev, state, True, chunk)
    m_host, b_host = _save(host, state, False, chunk)
    want = _spans_from_images(m_dev, before, after)
    assert dev.last_dirty == host.last_dirty == want
    _stream_equals(m_dev, b_dev, state)
    _stream_equals(m_host, b_host, state)
    # the device path moved only the mask plus dirty blocks of its records
    assert dev.last_d2h_bytes < host.last_d2h_bytes


def test_in_place_update_of_every_block_reads_dirty():
    """A parameter updated in place everywhere must read dirty in every
    block: the device baseline is the previous packed image in its own
    storage, never a view of the parameter."""
    p = torch.from_numpy(RNG.standard_normal(8 * 1024).astype(np.float32))
    state = {"p": p}
    arena = SerializeArena()
    _save(arena, state, True)
    baseline = arena._dev_prev[0]
    assert baseline.untyped_storage().data_ptr() != \
        p.untyped_storage().data_ptr()
    with torch.no_grad():
        p.mul_(1.5)
    m, b = _save(arena, state, True)
    assert arena.last_dirty == [(0, p.numel() * 4)]
    _stream_equals(m, b, state)
    with torch.no_grad():
        p[4096] += 1
    _save(arena, state, True)
    assert arena.last_dirty == [(4 * BLOCK, BLOCK)]


def test_unchanged_state_is_all_clean_and_moves_only_masks():
    state = _state()
    arena = SerializeArena()
    _save(arena, state, True)
    m, _ = _save(arena, state, True)
    assert arena.last_dirty == []
    # device records: masks only; the rest crosses whole
    host_only = sum(r.nbytes for r in m.records
                    if not SerializeArena._device_eligible(r, BLOCK))
    masks = sum(-(-r.nbytes // BLOCK) * 4 for r in m.records
                if SerializeArena._device_eligible(r, BLOCK))
    assert arena.last_d2h_bytes == host_only + masks


def test_layout_change_drops_the_baseline():
    state = _state()
    arena = SerializeArena()
    _save(arena, state, True)
    state["a"] = torch.zeros(5 * 1024)
    _save(arena, state, True)
    assert arena.last_dirty is None and not arena.last_reused


def test_cpu_state_is_not_pinned():
    arena = SerializeArena()
    m, _ = _save(arena, _state(), False)
    assert not arena.pinned and arena.capacity >= m.total_bytes


@pytest.mark.gpu
def test_cuda_state_uses_pinned_page_aligned_arena():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the arena pins only for a CUDA "
                    "state")
    state = {k: v.cuda() for k, v in _state().items()}
    arena = SerializeArena()
    m, b = _save(arena, state, True, chunk=8192)
    assert arena.pinned and arena._t8.is_pinned()
    assert arena._t8.data_ptr() % 4096 == 0
    with torch.no_grad():
        state["a"][5] += 1
    _save(arena, state, True, chunk=8192)
    assert arena.last_dirty == [(0, BLOCK)]
