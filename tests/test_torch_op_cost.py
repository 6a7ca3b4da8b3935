"""``launch/op_cost.py`` counts ``F.one_hot`` as ONE op on every device.

ATen builds ``one_hot`` one way on CUDA (zeros + ``scatter_``), another
on meta tensors (arange + ``eq`` + a cast) and, on the CPU, either way
depending on ``inference_mode``. Counted through those ops, one program
counts different bytes on different devices. ``OpCost`` counts the op
whole, above that choice: one op named ``one_hot`` with its index
operand's and its result's bytes, so a MoE forward counts the same
bytes on the CPU as on meta tensors (and, in chip_smoke.py phase 13 (c),
on the card)."""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_paper_config, reduced
from repro_torch.launch.op_cost import OpCost
from repro_torch.models.registry import build_model, make_batch
from repro_torch.tree import tree_map


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@pytest.mark.parametrize("inference", [True, False],
                         ids=["inference", "autograd"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_one_hot_alone_is_one_op(device, inference):
    idx = torch.zeros(3, 5, dtype=torch.long, device=device)
    with torch.inference_mode(inference), OpCost() as c:
        out = F.one_hot(idx, 7)
    assert c.n_ops == 1
    assert c.by_op == {"one_hot": _nbytes(idx) + _nbytes(out)}
    assert c.bytes == _nbytes(idx) + _nbytes(out) == 15 * 8 + 105 * 8


@pytest.mark.parametrize("inference", [True, False],
                         ids=["inference", "autograd"])
def test_moe_forward_counts_one_hot_whole_on_cpu_and_meta(monkeypatch,
                                                          inference):
    """One forward of a reduced gpt3_1_8b_moe (einsum dispatch: two
    ``one_hot`` per MoE layer, over the experts and over the capacity
    slots) on CPU tensors and on meta tensors: each ``one_hot`` call is
    one op with its operand and result bytes, and
    the two devices count the same bytes, op by op."""
    calls = []
    one_hot = F.one_hot

    def recorded(idx, n):
        out = one_hot(idx, n)
        calls.append(_nbytes(idx) + _nbytes(out))
        return out
    monkeypatch.setattr(F, "one_hot", recorded)

    cfg = reduced(get_paper_config("gpt3_1_8b_moe"))
    model = build_model(cfg)
    params = tree_map(lambda t: t.to(torch.bfloat16), model.init(0, "cpu"))
    batch = make_batch(cfg, 2, 32, seed=13, device="cpu")
    meta = (tree_map(lambda t: torch.empty_like(t, device="meta"), params),
            {k: torch.empty_like(v, device="meta")
             for k, v in batch.items()})
    counts = []
    for p, b in ((params, batch), meta):
        calls.clear()
        with torch.inference_mode(inference), OpCost() as c:
            model.forward(p, b)
        assert len(calls) == 2 * cfg.n_layers
        assert c.by_op["one_hot"] == sum(calls)
        assert sum(c.by_op.values()) == c.bytes
        counts.append(c)
    cpu, on_meta = counts
    assert cpu.flops == on_meta.flops > 0
    assert cpu.bytes == on_meta.bytes
    assert cpu.by_op == on_meta.by_op
    assert cpu.n_ops == on_meta.n_ops
