"""The port's entry points beside ``launch/train.py``: the counterparts of
the three examples (``quickstart``, ``fastpersist_vs_baseline``,
``train_100m``) and ``serve_decode`` on the two frontend families, each
run on the CPU at a small size (``--device cpu``), and each refusing
``cuda`` when no card is there (no fallback to the CPU)."""
import os

import numpy as np
import pytest
import torch

from repro_torch import configs as pconfigs
from repro_torch.launch import (fastpersist_vs_baseline, quickstart,
                                serve_decode, train_100m)


def test_quickstart_trains_restores_and_continues():
    start, loss = quickstart.main(["--device", "cpu"])
    assert start == 6
    assert np.isfinite(loss)


def test_fastpersist_vs_baseline_saves_every_variant(tmp_path):
    results, t_submit = fastpersist_vs_baseline.main(
        ["--mb", "8", "--device", "cpu", "--dir", str(tmp_path)])
    assert list(results) == ["baseline", "fastpersist 1 writers",
                             "fastpersist 4 writers",
                             "fastpersist 8 writers",
                             "fastpersist-pipelined"]
    n_bytes = 8 * 1024 * 1024 // 14 * 14
    for name, st in results.items():
        assert st.total_bytes >= n_bytes and st.gbps > 0, name
    assert t_submit >= 0
    assert os.listdir(tmp_path) == []          # every save removed


def test_synth_state_is_seeded_on_the_device():
    a = fastpersist_vs_baseline.synth_state(1, "cpu")
    b = fastpersist_vs_baseline.synth_state(1, "cpu")
    assert [(k, t.dtype) for k, t in a.items()] == [
        ("params", torch.bfloat16), ("master", torch.float32),
        ("m", torch.float32), ("v", torch.float32)]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert sum(t.numel() * t.element_size() for t in a.values()) == \
        1024 * 1024 // 14 * 14


def test_train_100m_reduced(tmp_path):
    d = tmp_path / "ckpt"
    loss, needed, measured = train_100m.main(
        ["--reduced", "--steps", "3", "--batch", "2", "--seq", "16",
         "--device", "cpu", "--dir", str(d)])
    assert np.isfinite(loss) and needed > 0 and measured > 0
    assert any(n.startswith("ckpt_") for n in os.listdir(d))


def test_train_100m_is_gpt3_small():
    cfg = train_100m.GPT3_SMALL
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab_size) == \
        (12, 768, 12, 50257)
    assert 100e6 < cfg.param_count() < 150e6


@pytest.mark.parametrize("arch", ["internvl2_26b", "whisper_small"])
def test_serve_decode_frontend_families_on_the_cpu(arch):
    seq = serve_decode.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "8",
                             "--new-tokens", "4"])
    cfg = pconfigs.reduced(pconfigs.get_config(arch))
    assert seq.shape == (2, 4) and seq.dtype == torch.int32
    assert ((0 <= seq) & (seq < cfg.vocab_size)).all()


@pytest.mark.parametrize("main,argv", [
    (quickstart.main, []),
    (fastpersist_vs_baseline.main, ["--mb", "1"]),
    (train_100m.main, ["--reduced", "--steps", "1"]),
    (serve_decode.main, ["--arch", "internvl2_26b", "--reduced"]),
    (serve_decode.main, ["--arch", "whisper_small", "--reduced"])])
def test_entry_points_raise_on_cuda_without_a_card(monkeypatch, main, argv,
                                                   tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="is_available"):
        main(argv)
    with pytest.raises(RuntimeError, match="is_available"):
        main(argv + ["--device", "cuda"])
    assert os.listdir(tmp_path) == []
