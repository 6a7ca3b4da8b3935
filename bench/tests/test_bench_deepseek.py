"""The ``deepseek_v2`` family against its float32 reference
(``bench/reference/deepseek_v2.py``) on the CPU at a tiny size, the
share of one expert-parallel rank against the whole layer, the family's
sizes and FLOPs at the cell's configuration, its two metric readers, and
a run of the family end to end through the harness.

Tolerances: the program in float32 against the reference, 1e-5 of the
largest magnitude (the same arithmetic in another order); the end-to-end
run's limits below."""
import math

import pytest
import torch

from bench import common, flops, inputs, run
from bench.generators import train_ckpt
from bench.reference import deepseek_v2 as ref
from bench.reference.train import unflat
from bench.tests.conftest import TRAIN

CELL = "deepseek_v2_lite_ep8"

#: the cell's file at tiny widths: 1 dense + 2 MoE layers, 16 router
#: experts, top 3, experts 4-7 held, 2 shared
TINY = dict(
    common.load("configs", CELL), hidden_size=64, num_attention_heads=2,
    num_key_value_heads=2, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16, kv_lora_rank=16, intermediate_size=96,
    moe_intermediate_size=32, router_experts=16, num_experts_per_tok=3,
    n_routed_experts=4, first_held_expert=4, n_layers=3, vocab_size=96,
    seq_len=16)

#: about ten times what the tiny run reads on the CPU (seeds 2**31 + 7,
#: 11, 5: loss 1.5e-4 at most, grad 2.1e-3, delta 3.4e-3); its reference
#: with the gate and the up-projection swapped reads 4.0e-3 to 4.2e-3,
#: 0.080 to 0.084 and 0.067 to 0.075 (seeds 2**31 + 7 and 11)
LIMITS = {"loss_gap": 1.5e-3, "grad_gap": 2e-2, "delta_gap": 2e-2,
          "saved_mismatch": 0}


def _share(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def _weights(cfg, seed=3):
    w = inputs.uniform_weights(common.family(cfg).param_shapes(cfg), seed,
                               "cpu")
    return {n: t.float() for n, t in w.items()}


def _program(cfg):
    from repro_torch.models.registry import build_model
    return build_model(common.model_config(cfg), dtype=torch.float32)


def _tokens(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg["vocab_size"], (2, cfg["seq_len"] + 1),
                        generator=g)
    return tok[:, :-1], tok[:, 1:]


def test_the_programs_tree_is_the_familys():
    """The program's parameters, names and shapes, are the family's."""
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import init_train_state
    from repro_torch.tree import flatten
    cfg = common.load("configs", CELL)
    state = init_train_state(build_model(common.model_config(cfg)), 0,
                             "meta")
    got = {n: tuple(t.shape) for n, t in flatten(state.params)}
    want = {n: s for n, (s, _) in inputs.param_shapes(cfg).items()}
    assert got == want


def test_program_loss_and_gradients_match_the_reference():
    """Float32 program (MLA without a query LoRA, the dropless held-expert
    layer, shared experts, the dense layer, the untied head, the balance
    loss) against the reference: the loss and every leaf's gradient."""
    cfg = TINY
    w = _weights(cfg)
    tok, lab = _tokens(cfg)
    model = _program(cfg)
    prog = unflat({n: t.clone().requires_grad_() for n, t in w.items()})
    refp = unflat({n: t.clone().requires_grad_() for n, t in w.items()})
    lp = model.loss(prog, {"tokens": tok, "labels": lab})
    lr = ref.loss(cfg, refp, tok, lab)
    assert abs(lp.item() - lr.item()) <= 1e-5 * abs(lr.item())
    from repro_torch.tree import flatten
    gp = dict(zip([n for n, _ in flatten(prog)], torch.autograd.grad(
        lp, [t for _, t in flatten(prog)])))
    gr = dict(zip([n for n, _ in flatten(refp)], torch.autograd.grad(
        lr, [t for _, t in flatten(refp)])))
    assert set(gp) == set(gr)
    for n in gr:
        assert _share(gp[n], gr[n]) <= 1e-5, n


def test_mla_without_a_query_lora_matches_the_reference():
    """The program's ``mla_attention`` (one ``wq``, no ``q_norm``, the
    file's YaRN rotary and scale) against the reference's attention,
    float32."""
    from repro_torch.models import layers as ly
    cfg = TINY
    w = unflat(_weights(cfg))
    a = {k: v[0] for k, v in w["layers"]["attn"].items()}
    h = torch.randn((2, cfg["seq_len"], cfg["hidden_size"]),
                    generator=torch.Generator().manual_seed(1))
    pos = torch.arange(cfg["seq_len"])
    got, _ = ly.mla_attention(a, h, common.model_config(cfg), pos)
    assert _share(got, ref.attention(cfg, a, h, pos)) <= 1e-5


def test_eight_shares_add_up_to_the_whole_layer():
    """The share test: a layer of 16 router experts cut into 8 ranks of 2
    experts each. Each rank's output (the program's dropless layer, told
    which experts it holds) less the shared experts' part, summed over
    the ranks, plus the shared experts' part once, is the uncut
    reference's layer; every rank's balance loss is the whole layer's."""
    from repro_torch.models import layers as ly
    whole = dict(TINY, n_routed_experts=16, first_held_expert=0)
    w = unflat(_weights(whole, seed=9))
    m = {k: v[0] if not isinstance(v, dict) else
         {kk: vv[0] for kk, vv in v.items()}
         for k, v in w["layers"]["mlp"].items()}
    h = torch.randn((2, TINY["seq_len"], TINY["hidden_size"]),
                    generator=torch.Generator().manual_seed(2))
    want, want_aux = ref.moe(whole, m, h)
    shared = ref.swiglu(h, m["shared"])
    total = shared.clone()
    for r in range(8):
        cfg = dict(TINY, n_routed_experts=2, first_held_expert=2 * r)
        share = dict(m, **{k: m[k][2 * r:2 * r + 2]
                           for k in ("wi", "wg", "wo")})
        out, aux = ly.moe_apply_dropless(share, h, common.model_config(cfg))
        total = total + (out - shared)
        assert torch.allclose(aux, want_aux, rtol=1e-6)
    assert _share(total, want) <= 1e-5


def test_sizes_flops_and_writes_of_the_cell():
    """The cell's share: each MoE layer 100,405,760 parameters, the dense
    layer and the rest 500,439,552; the state at 14 B a parameter; the
    rank part of D = 64 written 4 times within the budget; the FLOPs by
    hand, the routed experts at 6 x 8 / 64 pairs a token."""
    cfg = common.load("configs", CELL)
    n = cfg["n_layers"] - 1
    assert inputs.param_count(cfg) == 500_439_552 + n * 100_405_760
    assert inputs.state_bytes(cfg) == 14 * inputs.param_count(cfg) + 4
    wl = common.load("workloads", CELL + ".train_rank_saves")
    part = -(-inputs.state_bytes(cfg) // 64)
    assert run.planned_writes(cfg, wl) == 4 * (part + (1 << 20))
    assert run.planned_writes(cfg, wl) <= common.WRITE_BUDGET
    d, V, S = 2048, 102400, 4096
    attn = d * 16 * 192 + d * 576 + 512 * 16 * 256 + 16 * 128 * d
    moe = d * 64 + 3 * d * 2816 + 6 * 8 / 64 * 3 * d * 1408
    mm = V * d + (n + 1) * attn + 3 * d * 10944 + n * moe
    att = (n + 1) * 16 * (S * (S + 1) // 2) * 3 * 2 * (192 + 128)
    fam = common.family(cfg)
    assert fam.mla_attention_flops(cfg) == att
    assert flops.train_flops_per_step(cfg, 8) == 8 * (
        3 * 2 * round(mm) * S + att)
    # the published widths: not one is cut
    for k in ("hidden_size", "intermediate_size", "moe_intermediate_size",
              "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
              "v_head_dim", "num_attention_heads", "num_experts_per_tok",
              "vocab_size", "router_experts"):
        assert cfg[k] == cfg["published"][k]


def test_the_family_refuses_what_the_program_does_not_compute():
    for k, v in (("topk_method", "group_limited_greedy"),
                 ("scoring_func", "sigmoid"), ("hidden_act", "gelu"),
                 ("norm_topk_prob", True), ("routed_scaling_factor", 16),
                 ("seq_aux", False), ("rope_scaling", None),
                 ("rope_scaling", {"type": "linear", "factor": 4})):
        with pytest.raises(ValueError, match="program computes"):
            common.model_config(dict(TINY, **{k: v}))


def test_metric_readers(monkeypatch):
    """``mla_attention_roofline``: the traced steps' time at the roofline
    (here their attention FLOPs at the peak) over the three MLA kernels'
    device time; None while one of the three is missing. ``moe_expert_load_
    ratio``: per MoE layer, the largest held expert's pairs over their
    mean, averaged over the layers that counted; a hot expert in each
    layer reads high, though the layers summed read 1; None without the
    program's counter."""
    from repro_torch.models import layers as ly
    roof = common.module("metrics", "mla_attention_roofline")
    load = common.module("metrics", "moe_expert_load_ratio")
    cfg = common.load("configs", CELL)
    peak = flops.peak("NVIDIA H100 80GB HBM3")
    ops = [["void (anonymous namespace)::flash_tc_kernel<192, 128>(P)", 0.5],
           ["void (anonymous namespace)::flash_bwd_dq_kernel<192, 128>(B)",
            0.7],
           ["void (anonymous namespace)::flash_bwd_dkv_kernel<192, 128>(B)",
            0.8], ["nvjet_gemm", 3.0]]
    rec = {"config": cfg, "device": "NVIDIA H100 80GB HBM3",
           "trace": {"device_ops": ops}}
    steps = common.load("traffic", "ckpt_rank_overlap")["trace_steps"]
    fam = common.family(cfg)
    want = 100 * fam.mla_attention_flops(cfg) * 8 * steps / 2.0 / peak
    assert math.isclose(roof.read(rec), want)
    # at 4K the products bound the kernels, not the bytes
    assert fam.mla_attention_bytes(cfg) / 3.35e12 < 0.5 * (
        fam.mla_attention_flops(cfg) / peak)
    rec["trace"]["device_ops"] = ops[1:]
    assert roof.read(rec) is None
    monkeypatch.setattr(ly.moe_apply_dropless, "pairs",
                        torch.tensor([[10, 20, 30, 40], [25, 25, 25, 25],
                                      [0, 0, 0, 0]]))
    assert math.isclose(load.read({}), (40 / 25 + 1) / 2)
    hot = torch.full((4, 4), 10) + 30 * torch.eye(4, dtype=torch.long)
    monkeypatch.setattr(ly.moe_apply_dropless, "pairs", hot)
    assert math.isclose(load.read({}), 40 / 17.5)
    monkeypatch.setattr(ly.moe_apply_dropless, "pairs",
                        torch.zeros((2, 4), dtype=torch.long))
    assert load.read({}) is None
    monkeypatch.setattr(ly.moe_apply_dropless, "pairs", None)
    assert load.read({}) is None


def _run(make_ctx, seed=2 ** 31 + 7):
    cfg = dict(TINY, assumed=dict(TINY["assumed"], data_parallel=4))
    params = dict(TRAIN, limits=LIMITS, rank=0)
    return train_ckpt.run(make_ctx(params, cfg=cfg, seed=seed))


def test_the_family_runs_end_to_end(make_ctx):
    """The family through the harness on the CPU: the program's bf16
    training against the float32 reference within the limits, the rank's
    part saved and read back; with the reference's gate and up-projection
    swapped, the run fails a limit."""
    out = _run(make_ctx)
    assert out["failed"] == 0 and out["attempted"] > 0
    assert all(c["ok"] for c in out["checks"]), out["checks"]


def test_a_swapped_reference_fails(make_ctx, monkeypatch):
    def swapped(x, w):
        return (torch.nn.functional.silu(x @ w["wi"]) * (x @ w["wg"])) \
            @ w["wo"]
    monkeypatch.setattr(ref, "swiglu", swapped)
    out = _run(make_ctx, seed=11)
    bad = [c for c in out["checks"] if not c["ok"]]
    assert {c["name"] for c in bad} & {"loss_gap", "grad_gap", "delta_gap"}
