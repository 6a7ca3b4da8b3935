"""The model-FLOP count behind train_mfu against a count by hand."""
from bench import flops
from bench.families import gpt


def test_train_flops_by_hand():
    cfg = {"n_layers": 2, "d_model": 8, "n_heads": 2, "head_dim": 4,
           "d_ff": 16, "vocab_size": 10, "seq_len": 3, "gated_mlp": False}
    # forward of one sequence, product by product (2 FLOPs a multiply-add)
    tok = 3
    per_layer = (3 * (2 * 8 * 8) + 2 * 8 * 8    # q, k, v and out
                 + 2 * (2 * 8 * 16))            # the MLP's two products
    head = 2 * 8 * 10                           # tied output head
    pairs = 1 + 2 + 3                           # causal (q, k) pairs
    attn = 2 * (2 * 2 * 4 * pairs)              # scores and values, 2 heads
    fwd = tok * (2 * per_layer + head) + 2 * attn
    assert flops.train_flops_per_step(cfg, rows=5) == 3 * 5 * fwd
    assert gpt.matmul_params(cfg) == (2 * per_layer + head) // 2
    assert gpt.attention_flops(cfg) == 2 * attn


def test_peak_table():
    assert flops.peak("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.peak("some other card") is None
