"""A configuration's family: the ``gpt`` family gives the model
configuration, state bytes, FLOP count and weights that the harness gave
before it dispatched on families (values frozen from that harness), and a
family the repo does not have runs end to end from new files alone."""
import dataclasses
import hashlib
import math
import os
import sys

import pytest
import torch

from bench import common, flops, inputs, run
from bench.families import gpt
from bench.generators import train_ckpt
from bench.tests.conftest import TINY, TRAIN

#: what the harness gave for each GPT configuration before families
PARENT = {
    "gpt3_2_7b_tp4": {
        "model": dict(arch_type="dense", n_layers=1, d_model=2560,
                      n_heads=8, n_kv_heads=8, head_dim=80, d_ff=10240,
                      vocab_size=12576, tie_embeddings=True,
                      gated_mlp=False, rope_theta=10000.0, norm_eps=1e-5),
        "state_bytes": 1_276_584_964,
        "planned_writes": 2_555_267_080,
        "flops": 18_183_943_618_560},
    "gpt3_1_3b_tp2": {
        "model": dict(arch_type="dense", n_layers=1, d_model=2048,
                      n_heads=8, n_kv_heads=8, head_dim=128, d_ff=8192,
                      vocab_size=25152, tie_embeddings=True,
                      gated_mlp=False, rope_theta=10000.0, norm_eps=1e-5),
        "state_bytes": 1_308_446_724,
        "planned_writes": 2_618_990_600,
        "flops": 9_393_194_139_648},
}

#: sha256 over (name, bytes) of ``make_weights(TINY, 2**31 + 7, "cpu")``
#: in name order, by ``gated_mlp``
WEIGHT_DIGESTS = {
    False: "231fbb1a607f4851176242bc9127d906e8dd02b7e4ffaa1cfa81098dd1d0793a",
    True: "ea97671e78557704aac3c53ef6e39e5ed502e0932d944fd3afea0d41338eabac",
}


def digest(weights: dict) -> str:
    h = hashlib.sha256()
    for name in sorted(weights):
        h.update(name.encode())
        h.update(weights[name].contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PARENT))
def test_gpt_model_config_is_the_parents(name):
    from repro_torch.configs.base import ModelConfig
    cfg = common.load("configs", name)
    assert "family" not in cfg and common.family(cfg) is gpt
    want = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    want.update(PARENT[name]["model"], name=name, source=cfg["source"])
    assert dataclasses.asdict(common.model_config(cfg)) == want


@pytest.mark.parametrize("name", sorted(PARENT))
def test_gpt_state_bytes_and_planned_writes_are_the_parents(name):
    cfg = common.load("configs", name)
    assert inputs.state_bytes(cfg) == PARENT[name]["state_bytes"]
    cells = [common.load("workloads", w) for w in (
        "gpt3_2_7b_tp4.train_overlap", "gpt3_2_7b_tp4.train_blocking",
        "gpt3_1_3b_tp2.train_overlap")]
    for wl in cells:
        if wl["config"] == name:
            assert run.planned_writes(cfg, wl) == PARENT[name][
                "planned_writes"]


@pytest.mark.parametrize("name", sorted(PARENT))
def test_gpt_train_flops_are_the_parents(name):
    cfg = common.load("configs", name)
    rows = cfg["rows_per_step"]
    assert flops.train_flops_per_step(cfg, rows) == PARENT[name]["flops"]
    assert gpt.train_flops_per_step(cfg, rows) == PARENT[name]["flops"]


@pytest.mark.parametrize("gated", [False, True])
def test_gpt_weights_are_the_parents_bytes(gated):
    w = inputs.make_weights(dict(TINY, gated_mlp=gated), 2 ** 31 + 7, "cpu")
    assert digest(w) == WEIGHT_DIGESTS[gated]


# ---- a family the repo does not have: grouped KV heads, a gated MLP

#: ten times what this family's sound run reads on the CPU (1.1e-4,
#: 4.5e-4, 5.6e-4); its reference with the gate and the up-projection
#: swapped reads 3.0e-3, 0.050, 0.012
LIMITS = {"loss_gap": 1e-3, "grad_gap": 5e-3, "delta_gap": 5e-3,
          "saved_mismatch": 0}

FAMILY = '''"""A family written for one test: the program's dense decoder with
grouped KV heads and a gated MLP."""
from bench import inputs

made = []


def program_config(cfg):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=cfg["name"], arch_type="dense", n_layers=cfg["n_layers"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_kv_heads=cfg["n_kv_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["d_ff"], vocab_size=cfg["vocab_size"],
        tie_embeddings=True, gated_mlp=True, rope_theta=cfg["rope_theta"],
        norm_eps=cfg["norm_eps"], source=cfg["source"])


def param_shapes(cfg):
    d, H, KV, hd = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                    cfg["head_dim"])
    L, ff, V = cfg["n_layers"], cfg["d_ff"], cfg["vocab_size"]
    return {"embed": ((V, d), d), "final_norm": ((d,), None),
            "layers/attn/wq": ((L, d, H * hd), d),
            "layers/attn/wk": ((L, d, KV * hd), d),
            "layers/attn/wv": ((L, d, KV * hd), d),
            "layers/attn/wo": ((L, H * hd, d), H * hd),
            "layers/ln1": ((L, d), None), "layers/ln2": ((L, d), None),
            "layers/mlp/wi": ((L, d, ff), d),
            "layers/mlp/wg": ((L, d, ff), d),
            "layers/mlp/wo": ((L, ff, d), ff)}


def train_flops_per_step(cfg, rows):
    d, H, KV, hd = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                    cfg["head_dim"])
    S, L = cfg["seq_len"], cfg["n_layers"]
    mm = cfg["vocab_size"] * d + L * (2 * d * H * hd + 2 * d * KV * hd
                                      + 3 * d * cfg["d_ff"])
    attn = L * H * 2 * (2 * hd * (S * (S + 1) // 2))
    return 3 * rows * (2 * mm * S + attn)


def make_weights(cfg, seed, device):
    made.append(seed)
    return inputs.uniform_weights(param_shapes(cfg), seed, device)
'''

REFERENCE = '''"""The reference of the one-test family: grouped KV heads, a gated
SiLU MLP, in float32."""
import math

import torch

from bench.reference.gpt import rmsnorm, rotary


def loss(cfg, p, tokens, labels):
    B, L = tokens.shape
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    pos = torch.arange(L, device=tokens.device)
    x = p["embed"][tokens.long()]
    a, m = p["layers"]["attn"], p["layers"]["mlp"]
    for i in range(cfg["n_layers"]):
        h = rmsnorm(x, p["layers"]["ln1"][i], eps)
        q = rotary((h @ a["wq"][i]).reshape(B, L, H, hd), pos, theta)
        k = rotary((h @ a["wk"][i]).reshape(B, L, KV, hd), pos, theta)
        v = (h @ a["wv"][i]).reshape(B, L, KV, hd)
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), float("-inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        x = x + o.reshape(B, L, H * hd) @ a["wo"][i]
        h = rmsnorm(x, p["layers"]["ln2"][i], eps)
        g = torch.nn.functional.silu(h @ m["wg"][i]) * (h @ m["wi"][i])
        x = x + g @ m["wo"][i]
    logits = rmsnorm(x, p["final_norm"], eps) @ p["embed"].T
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())
'''


def bench_digests() -> dict:
    """``{path: sha256}`` of the files under bench/, leaving out caches and
    the throwaway files that tests write and remove."""
    out = {}
    for root, dirs, files in os.walk(common.BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if not f.startswith("_throwaway_"):
                path = os.path.join(root, f)
                with open(path, "rb") as fh:
                    out[path] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_new_family_runs_from_new_files_alone(make_ctx, monkeypatch):
    name = f"_throwaway_{os.getpid()}"
    before = bench_digests()
    paths = {kind: os.path.join(common.BENCH, kind, name + ".py")
             for kind in ("families", "reference")}
    for kind, text in (("families", FAMILY), ("reference", REFERENCE)):
        with open(paths[kind], "w") as f:
            f.write(text)
    try:
        cfg = dict(TINY, name=name, family=name, n_heads=4, n_kv_heads=2,
                   head_dim=16, d_ff=128)
        d, V, ff, S = (cfg["d_model"], cfg["vocab_size"], cfg["d_ff"],
                       cfg["seq_len"])
        q, kv = 4 * 16, 2 * 16          # query and KV widths, one layer
        mm = V * d + 2 * d * q + 2 * d * kv + 3 * d * ff
        n = mm + 3 * d                  # and three norms
        assert inputs.param_count(cfg) == n
        assert n != sum(math.prod(s) for s, _ in gpt.param_shapes(
            cfg).values())
        per_save = 14 * n + 4 + (1 << 20)
        wl = {"traffic": "ckpt_overlap", "limits": TRAIN["limits"]}
        assert run.planned_writes(cfg, wl) == 2 * per_save
        attn = 4 * 2 * (2 * 16 * (S * (S + 1) // 2))
        assert flops.train_flops_per_step(cfg, 8) == 3 * 8 * (
            2 * mm * S + attn)

        out = train_ckpt.run(make_ctx(dict(TRAIN, limits=LIMITS), cfg=cfg))
        assert out["failed"] == 0 and out["attempted"] > 0
        assert all(c["ok"] for c in out["checks"]), out["checks"]
        assert common.family(cfg).made, "the family's make_weights"
        assert out["bytes_written"] == (TRAIN["saves"] + 1) * (
            inputs.state_bytes(cfg))

        # build() holds the family to the program: a leaf it does not name
        shapes = common.family(cfg).param_shapes(cfg)
        monkeypatch.setattr(common.family(cfg), "param_shapes", lambda c: {
            k: v for k, v in shapes.items() if k != "layers/mlp/wg"})
        with pytest.raises(RuntimeError, match="not the configuration's"):
            train_ckpt.build(make_ctx(TRAIN, cfg=cfg, seed=5),
                             TRAIN["backend"], {})
    finally:
        monkeypatch.undo()
        for kind, path in paths.items():
            os.remove(path)
            sys.modules.pop(f"bench.{kind}.{name}", None)
    after = bench_digests()
    assert {p: after.get(p) for p in before} == before
