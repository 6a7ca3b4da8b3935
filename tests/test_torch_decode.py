"""Prefill and decode of the port's dense and moe families (the KV cache,
``attention(kv_valid_len=)``) against the port's own forward and against
the reference's prefill and decode, on the reference's weights
(``repro_torch.convert``) and its ``make_batch`` tokens.

Tolerances, and why:
  * decode against the forward over the same tokens: 2e-3, as
    tests/test_archs.py (f32; the cache path attends over the padded
    cache with masks, the forward over the sequence, so the f32 sums
    differ in order). The MoE runs with capacity = n_experts, as there:
    a decode step routes B tokens where the forward routed B·L, so with
    drops the two compute different functions.
  * the port's logits and cache against the reference's: 1e-5 absolute
    in f32 (the same math, f32 sums in another order); bf16: 0.05, as
    tests/test_torch_model.py.
  * ``attention`` with ``kv_valid_len`` against the reference's: 1e-6
    (one f32 softmax over the same masked scores)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import layers as ref_layers
from repro.models.registry import build_model as ref_build
from repro.models.registry import make_batch as ref_make_batch
from repro_torch import configs as pconfigs
from repro_torch.convert import train_state_from_numpy
from repro_torch.models import layers as ly
from repro_torch.models.registry import build_model
from repro_torch.train.steps import make_decode_step

KEYS = ["stablelm_1_6b", "qwen1_5_4b", "gpt3_0_7b", "gpt3_1_8b_moe",
        "qwen3_moe_235b"]


def _cfgs(key):
    """(reference, port) reduced configs; MoE without drops."""
    if key.startswith("gpt3"):
        ref = rconfigs.reduced(rconfigs.get_paper_config(key))
        port = pconfigs.reduced(pconfigs.get_paper_config(key))
    else:
        ref = rconfigs.reduced(rconfigs.get_config(key))
        port = pconfigs.reduced(pconfigs.get_config(key))
    if ref.moe is not None:
        ref, port = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=float(c.moe.n_experts)))
            for c in (ref, port))
    return ref, port


def _setup(key, dtype="float32", B=2, L=16, seed=0):
    ref_cfg, cfg = _cfgs(key)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = ref_build(ref_cfg, dtype=jdt)
    params = jax.tree.map(lambda a: a.astype(jdt),
                          jm.init(jax.random.PRNGKey(seed)))
    jb = ref_make_batch(ref_cfg, B, L)
    tp = train_state_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    tokens = torch.from_numpy(np.array(jb["tokens"]))
    return jm, params, jb, build_model(cfg, dtype=tdt), tp, tokens


@pytest.mark.parametrize("key", KEYS)
def test_decode_matches_forward(key):
    """tests/test_archs.py::test_decode_matches_forward on the port:
    prefill L-1 tokens into a cache of L+4, decode the last one."""
    _, _, _, pm, tp, tokens = _setup(key)
    B, L = tokens.shape
    logits, _ = pm.forward(tp, {"tokens": tokens})
    cache = pm.init_cache(B, L + 4, "cpu")
    assert cache["k"].shape == (pm.cfg.n_layers, B, L + 4,
                                pm.cfg.n_kv_heads,
                                pm.cfg.resolved_head_dim)
    last, cache = pm.prefill(tp, {"tokens": tokens[:, :L - 1]}, cache)
    assert last.shape == (B, 1, pm.cfg.vocab_size)
    assert float((last[:, 0] - logits[:, L - 2]).abs().max()) < 2e-3
    dec, cache = pm.decode(tp, tokens[:, L - 1:], cache, L - 1)
    assert float((dec[:, 0] - logits[:, -1]).abs().max()) < 2e-3
    # positions past the last token were never written
    assert not cache["k"][:, :, L:].any() and not cache["v"][:, :, L:].any()


@pytest.mark.parametrize("key", KEYS)
def test_greedy_decode_matches_forward(key):
    """Several greedy steps, each against the forward over the prompt
    and every token generated so far (what chip_smoke's phase 10 holds
    on gpt3_2_7b at full width)."""
    _, _, _, pm, tp, tokens = _setup(key, L=8)
    B, P = tokens.shape
    new = 4
    cache = pm.init_cache(B, P + new, "cpu")
    last, cache = pm.prefill(tp, {"tokens": tokens}, cache)
    tok = last.argmax(-1).to(torch.int32)
    seq, dec = [tokens, tok], []
    for i in range(new - 1):
        lg, cache = pm.decode(tp, tok, cache, P + i)
        dec.append(lg[:, 0])
        tok = lg.argmax(-1).to(torch.int32)
        seq.append(tok)
    full, _ = pm.forward(tp, {"tokens": torch.cat(seq, dim=1)})
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, P - 1].numpy(),
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(),
                               full[:, P:P + new - 1].numpy(), atol=2e-3,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("key", ["gpt3_0_7b", "qwen1_5_4b", "gpt3_1_8b_moe"])
def test_decode_matches_reference_decode(key, dtype):
    """The port's prefill + decode against the reference's, on shared
    weights: the logits and the cache the reference returns."""
    jm, params, jb, pm, tp, tokens = _setup(key, dtype)
    B, L = tokens.shape
    jcache = jm.init_cache(B, L + 4)
    jlast, jcache = jm.prefill(params, {"tokens": jb["tokens"][:, :L - 1]},
                               jcache)
    jdec, jcache = jm.decode(params, jb["tokens"][:, L - 1:], jcache,
                             jnp.int32(L - 1))
    cache = pm.init_cache(B, L + 4, "cpu")
    last, cache = pm.prefill(tp, {"tokens": tokens[:, :L - 1]}, cache)
    dec, cache = pm.decode(tp, tokens[:, L - 1:], cache, L - 1)
    tol = 1e-5 if dtype == "float32" else 0.05
    for got, want in ((last, jlast), (dec, jdec), (cache["k"], jcache["k"]),
                      (cache["v"], jcache["v"])):
        assert got.dtype == tp["embed"].dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=0)
    tok, _ = make_decode_step(pm)(tp, tokens[:, L - 1:],
                                  pm.init_cache(B, L + 4, "cpu"), 0)
    assert tok.dtype == torch.int32 and tok.shape == (B, 1)


@pytest.mark.parametrize("Lq,valid,causal", [(1, 6, True), (1, 6, False),
                                             (3, 9, False), (4, 12, True)])
def test_attention_kv_valid_len_matches_reference(Lq, valid, causal):
    """A cache of 12 slots, of which the first ``valid`` hold keys; the
    queries sit at the last ``Lq`` valid positions; GQA (4 heads, 2 KV
    heads). Without the causal mask only ``kv_valid_len`` hides the
    empty slots."""
    rng = np.random.default_rng(Lq)
    q = rng.standard_normal((2, Lq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
            for _ in range(2))
    q_pos = np.arange(valid - Lq, valid, dtype=np.int32)
    kv_pos = np.arange(12, dtype=np.int32)
    want = ref_layers.attention(*map(jnp.asarray, (q, k, v)),
                                q_pos=jnp.asarray(q_pos),
                                kv_pos=jnp.asarray(kv_pos), causal=causal,
                                kv_valid_len=valid)
    got = ly.attention(*map(torch.from_numpy, (q, k, v)),
                       q_pos=torch.from_numpy(q_pos),
                       kv_pos=torch.from_numpy(kv_pos), causal=causal,
                       kv_valid_len=valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    # garbage in the slots at or past ``valid`` changes nothing
    k[:, valid:] = 1e3
    v[:, valid:] = -1e3
    again = ly.attention(*map(torch.from_numpy, (q, k, v)),
                         q_pos=torch.from_numpy(q_pos),
                         kv_pos=torch.from_numpy(kv_pos), causal=causal,
                       kv_valid_len=valid)
    torch.testing.assert_close(again, got, atol=0, rtol=0)


def test_cache_is_written_in_place():
    """Prefill and decode return the cache they were given, written at
    the positions they were asked to fill."""
    _, _, _, pm, tp, tokens = _setup("gpt3_0_7b", L=8)
    cache = pm.init_cache(2, 12, "cpu")
    k, v = cache["k"], cache["v"]
    _, out = pm.prefill(tp, {"tokens": tokens}, cache)
    assert out["k"] is k and out["v"] is v
    assert k[:, :, :8].abs().amax(dim=(0, 1, 3, 4)).gt(0).all()
    assert not k[:, :, 8:].any()
    before = k.clone()
    _, out = pm.decode(tp, tokens[:, :1], cache, 8)
    assert out["k"] is k
    assert torch.equal(k[:, :, :8], before[:, :, :8])
    assert k[:, :, 8].abs().amax(dim=(0, 1, 2, 3)).gt(0).all()
    assert not k[:, :, 9:].any()
