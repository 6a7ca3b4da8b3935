"""A mix that saves one DP rank's extent of the stream (``bench/extent.py``):
the carve is the program's, the D ranks' parts hold exactly the bytes of
the whole save, the budget counts the extent, and the check of a rank's
part passes on a sound part and fails on each fault it is there to
catch."""
import json
import os
import zlib

import pytest
import torch

from bench import common, extent, faults, inputs, run
from bench.generators import train_ckpt
from bench.reference import layout
from bench.tests.conftest import TINY, TRAIN

CELL = "gpt3_2_7b_tp4_l24.train_rank_saves"


def rank_cfg(dp: int) -> dict:
    return dict(TINY, assumed={"data_parallel": dp})


def odd_state() -> dict:
    """Records whose sizes cut extents mid-element: bf16, f32, int32."""
    g = torch.Generator().manual_seed(5)
    return {"a": torch.randn(5, 7, generator=g).to(torch.bfloat16),
            "b": torch.randn(3, generator=g),
            "c": torch.arange(3, dtype=torch.int32),
            "d": torch.randn(2, 9, generator=g).to(torch.bfloat16)}


def engine(d):
    from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
    return CheckpointEngine(CheckpointSpec(directory=str(d)))


def stream_of(step_dir) -> bytes:
    records, man, problems = layout.read_step(step_dir)
    assert not problems
    return b"".join(records[r["name"]].reshape(-1).view(torch.uint8)
                    .numpy().tobytes()
                    for r in man["records"])


@pytest.mark.parametrize("dp", [1, 2, 3, 8, 32])
@pytest.mark.parametrize("total", [0, 1, 7, 776_836, 1_276_584_964])
def test_the_carve_is_the_programs(total, dp):
    from repro_torch.core.partition import stripe_ranges
    assert extent.stripe_ranges(total, dp) == stripe_ranges(total, dp)


@pytest.mark.parametrize("dp", [1, 2, 3, 8])
def test_the_ranks_parts_hold_the_whole_save(tmp_path, dp):
    """D engines over the same state, each saving its rank's part, write
    the whole save's stream between them, offset for offset."""
    state = odd_state()
    e = engine(tmp_path / "whole")
    e.save(state, 1).wait()
    whole = stream_of(tmp_path / "whole" / "ckpt_00000001")
    assert len(whole) == extent.stream_size(
        [(n, state[n]) for n in sorted(state)])
    parts = []
    for r in range(dp):
        lo, hi = extent.stripe_ranges(len(whole), dp)[r]
        e = engine(tmp_path / f"rank{r}")
        stats = e.save(extent.share(state, lo, hi), 1).wait()
        assert stats.total_bytes == stats.d2h_bytes == hi - lo
        part = stream_of(tmp_path / f"rank{r}" / "ckpt_00000001")
        assert part == whole[lo:hi]
        parts.append(part)
    assert b"".join(parts) == whole


def test_planned_writes_count_the_extent():
    wl = common.load("workloads", CELL)
    cfg = common.load("configs", wl["config"])
    p = common.cell_params(wl)[1]
    assert extent.rank_of(cfg, p) == (0, 32)
    assert inputs.state_bytes(cfg) == 20_270_566_404
    assert extent.stripe_ranges(inputs.state_bytes(cfg), 32)[0] == (
        0, 633_455_201)
    assert run.planned_writes(cfg, wl) == 4 * (633_455_201 + (1 << 20)) \
        == 2_538_015_108 <= common.WRITE_BUDGET


def test_the_rank_configuration_by_hand():
    """24 layers of the 2.7B share: its parameters counted by hand, and
    the rank mix's four saves past the budget whole."""
    cfg = common.load("configs", "gpt3_2_7b_tp4_l24")
    d, hd, ff, V, L = 2560, 8 * 80, 10240, 12576, 24
    n = V * d + L * (4 * d * hd + 2 * d * ff + 2 * d) + d
    assert inputs.param_count(cfg) == n == 1_447_897_600
    assert inputs.state_bytes(cfg) == 14 * n + 4
    whole = dict(common.cell_params(common.load("workloads", CELL))[1],
                 rank=None)
    assert 4 * extent.save_bytes(inputs.state_bytes(cfg), cfg, whole) > \
        common.WRITE_BUDGET


@pytest.mark.parametrize("dp,fits", [(1, False), (8, True)])
def test_a_535m_parameter_state_fits_at_eight_ranks(dp, fits):
    """A state of 535 M parameters (7.5 GB a save) over a warm save and one
    window save: past the budget whole, within it as a rank's eighth."""
    cfg = dict(common.load("configs", "gpt3_2_7b_tp4"), n_layers=10,
               assumed={"data_parallel": dp})
    cfg["vocab_size"] = (535_000_000 - inputs.param_count(
        dict(cfg, vocab_size=0))) // cfg["d_model"] + 1
    assert 535e6 <= inputs.param_count(cfg) < 535e6 + cfg["d_model"]
    wl = {"traffic": "ckpt_rank_overlap", "limits": {}}
    one = dict(common.load("traffic", "ckpt_rank_overlap"), saves=1)
    planned = 2 * (extent.save_bytes(inputs.state_bytes(cfg), cfg, one)
                   + (1 << 20))
    assert (planned <= common.WRITE_BUDGET) == fits
    assert run.planned_writes(cfg, wl) > common.WRITE_BUDGET  # 3 saves


def test_a_rank_outside_the_group_is_refused():
    with pytest.raises(ValueError):
        extent.rank_of(rank_cfg(4), {"rank": 4})
    assert extent.rank_of(rank_cfg(4), {"rank": None}) is None
    assert extent.rank_of(TINY, {}) is None


@pytest.mark.parametrize("rank", [0, 3])
def test_a_rank_run_writes_its_extent_and_passes(make_ctx, rank):
    cfg = rank_cfg(4)
    ctx = make_ctx(dict(TRAIN, rank=rank, saves=3), seconds=0.6, cfg=cfg)
    out = train_ckpt.run(ctx)
    assert all(c["ok"] for c in out["checks"]), out["checks"]
    lo, hi = extent.stripe_ranges(inputs.state_bytes(cfg), 4)[rank]
    assert [s["total_bytes"] for s in out["records"]["saves"]] == \
        [s["d2h_bytes"] for s in out["records"]["saves"]] == [hi - lo] * 3
    assert out["bytes_written"] == 4 * (hi - lo)


def _sound_part(make_ctx, rank=0, dp=4, seed=11):
    """A rank's part saved at step 2 after two steps: the run's context,
    its trainer (open, for ``check_saved``), the state copy taken at the
    save and the step directory."""
    cfg = rank_cfg(dp)
    ctx = make_ctx(dict(TRAIN, rank=rank, saves=0), cfg=cfg, seed=seed)
    trainer, w0 = train_ckpt.build(ctx, TRAIN["backend"], {})
    train_ckpt.warm_up(ctx, trainer, w0, 2)
    saved = train_ckpt.copy_for_check(ctx, trainer.state)
    train_ckpt.save(ctx, trainer, 2).wait()
    d = os.path.join(ctx.ckpt_dir, "ckpt_00000002")
    return ctx, trainer, saved, d


def _rewrite(d, name, data: bytes):
    """Replace one file of a committed step and mend every CRC over it, so
    that only the check's own comparison can see the change."""
    with open(os.path.join(d, name), "wb") as f:
        f.write(data)
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    for e in man["plan"]["extents"]:
        with open(os.path.join(d, f"shard_{e['shard_index']:03d}.bin"),
                  "rb") as f:
            e["crc32"] = zlib.crc32(f.read())
    raw = json.dumps(man).encode()
    with open(os.path.join(d, "manifest.json"), "wb") as f:
        f.write(raw)
    with open(os.path.join(d, "COMMIT")) as f:
        commit = json.load(f)
    commit["manifest_crc32"] = zlib.crc32(raw)
    for fname in commit.get("files", {}):
        commit["files"][fname] = os.path.getsize(os.path.join(d, fname))
    for sh in commit.get("shards", []):
        path = os.path.join(d, sh["name"])
        if os.path.exists(path):
            with open(path, "rb") as f:
                sh["crc32"] = zlib.crc32(f.read())
    with open(os.path.join(d, "COMMIT"), "w") as f:
        json.dump(commit, f)


def _mismatch(ctx, trainer, saved) -> int:
    return train_ckpt.check_saved(ctx, trainer, {2: saved})[0]["value"]


def test_check_passes_a_sound_part(make_ctx):
    ctx, trainer, saved, d = _sound_part(make_ctx)
    assert _mismatch(ctx, trainer, saved) == 0
    trainer.engine.close()


@pytest.mark.parametrize("where", [0, "last"])
def test_check_fails_one_altered_byte_in_the_extent(make_ctx, where):
    ctx, trainer, saved, d = _sound_part(make_ctx, rank=1)
    with open(os.path.join(d, "shard_000.bin"), "rb") as f:
        data = bytearray(f.read())
    i = 0 if where == 0 else len(data) - 1
    data[i] ^= 0x01
    _rewrite(d, "shard_000.bin", bytes(data))
    assert layout.read_step(d)[2] == []
    assert _mismatch(ctx, trainer, saved) >= 1
    trainer.engine.close()


def test_check_fails_another_ranks_bytes_under_its_offset(make_ctx,
                                                          monkeypatch):
    """Rank 1's bytes saved where rank 0's extent is claimed."""
    share = extent.share
    cfg = rank_cfg(4)
    total = inputs.state_bytes(cfg)
    other = extent.stripe_ranges(total, 4)[1]
    monkeypatch.setattr(extent, "share",
                        lambda state, lo, hi: share(state, *other))
    ctx, trainer, saved, d = _sound_part(make_ctx, rank=0)
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["extras"]["extent"] == list(
            extent.stripe_ranges(total, 4)[0])
    assert _mismatch(ctx, trainer, saved) >= 1
    trainer.engine.close()


def test_check_fails_a_short_manifest_total(make_ctx):
    ctx, trainer, saved, d = _sound_part(make_ctx, rank=2)
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    man["total_bytes"] -= 1
    _rewrite(d, "manifest.json", json.dumps(man).encode())
    assert layout.read_step(d)[2] == []
    assert _mismatch(ctx, trainer, saved) >= 1
    trainer.engine.close()


def test_the_altered_fault_lands_inside_the_extent(make_ctx):
    """The fault alters the first byte of the part the save takes, and a
    rank run's check counts it."""
    cfg = rank_cfg(4)
    with faults.FAULTS["altered"]():
        out = train_ckpt.run(make_ctx(dict(TRAIN, rank=3, saves=2),
                                      seconds=0.5, cfg=cfg))
    check = {c["name"]: c for c in out["checks"]}["saved_mismatch"]
    assert check["value"] >= 1 and not check["ok"]
    assert all(c["ok"] for c in out["checks"] if c is not check)


def _spoil_one_save(monkeypatch, call: int, spoil):
    """``extent.share`` returns ``spoil(state, lo, hi)`` on its ``call``-th
    call (0: the warm save) and the rank's part on every other."""
    share, calls = extent.share, []

    def patched(state, lo, hi):
        calls.append(1)
        if len(calls) == call + 1:
            return spoil(share, state, lo, hi)
        return share(state, lo, hi)
    monkeypatch.setattr(extent, "share", patched)


def test_a_short_part_in_an_earlier_save_fails_the_check(make_ctx,
                                                         monkeypatch):
    """The first window save takes a byte less; retention deletes it, so
    only its ``SaveStats`` can show it."""
    _spoil_one_save(monkeypatch, 1,
                    lambda share, state, lo, hi: share(state, lo, hi - 1))
    out = train_ckpt.run(make_ctx(dict(TRAIN, rank=1, saves=3),
                                  seconds=0.6, cfg=rank_cfg(4)))
    check = {c["name"]: c for c in out["checks"]}["saved_mismatch"]
    assert check["value"] == 1 and not check["ok"]


def test_each_kept_save_is_read_back(make_ctx, monkeypatch):
    """With ``keep_last`` 2 the window's last two saves are read back: the
    one before the last, holding rank 2's bytes under rank 1's extent (of
    the same length), fails the check."""
    cfg = rank_cfg(4)
    total = inputs.state_bytes(cfg)
    other = extent.stripe_ranges(total, 4)[2]
    assert other[1] - other[0] == total // 4 == -(-total // 4)
    _spoil_one_save(monkeypatch, 2,
                    lambda share, state, lo, hi: share(state, *other))
    out = train_ckpt.run(make_ctx(dict(TRAIN, rank=1, saves=3, keep_last=2),
                                  seconds=0.6, cfg=cfg))
    check = {c["name"]: c for c in out["checks"]}["saved_mismatch"]
    assert check["value"] >= 1 and not check["ok"]
    monkeypatch.undo()
    out = train_ckpt.run(make_ctx(dict(TRAIN, rank=1, saves=3, keep_last=2),
                                  seconds=0.6, cfg=cfg, seed=12))
    assert all(c["ok"] for c in out["checks"]), out["checks"]
