"""The analytic overlap model and the retry discipline of the port
against the reference's, on the CPU (the pipelined saves are held in
test_torch_engine.py). The overlap model gives the reference's numbers
for the same peak FLOP rate, which the port requires from the caller.
Exact where step counts are compared; the model's floats agree to
1e-12 relative (the same formulas, evaluated in the same order)."""
import random
import threading
import time

import numpy as np
import pytest

from repro import configs as rconfigs
from repro.core import overlap as roverlap
from repro.core import retry as rretry
from repro.core.partition import Topology as RefTopology
from repro_torch import configs
from repro_torch.core import overlap, retry
from repro_torch.core.partition import Topology


# ============================================================== overlap
ARCHES = ["stablelm_1_6b", "mamba2_370m"]


@pytest.mark.parametrize("arch", ARCHES)
@pytest.mark.parametrize("peak", [1e12, 989e12])
def test_overlap_model_equals_reference(arch, peak):
    pc, rc = configs.get_config(arch), rconfigs.get_config(arch)
    for kw in (dict(global_batch=8, seq_len=2048, n_accel=8),
               dict(global_batch=4, seq_len=512, n_accel=1, mfu=0.3,
                    gas=2)):
        a = overlap.estimate_iteration(pc, peak_flops=peak, **kw)
        b = roverlap.estimate_iteration(rc, peak_flops=peak, **kw)
        for f in ("t_forward", "t_backward", "t_optimizer", "fb", "total"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-12)
        nbytes = 14 * pc.param_count()
        assert overlap.required_bandwidth(nbytes, a) == pytest.approx(
            roverlap.required_bandwidth(nbytes, b), rel=1e-12)
        for pipelined in (True, False):
            for ser, f in ((0.0, 0.0), (1.5, 0.75)):
                assert overlap.effective_overhead(
                    a, 2.0, pipelined, serialize_s=ser,
                    snapshot_overlap=f) == pytest.approx(
                    roverlap.effective_overhead(
                        b, 2.0, pipelined, serialize_s=ser,
                        snapshot_overlap=f), rel=1e-12)


@pytest.mark.parametrize("dp,strategy", [(4, "auto"), (16, "replica"),
                                         (64, "socket")])
def test_checkpoint_and_staging_seconds_equal_reference(dp, strategy):
    nbytes = 23_019_745_284
    pt, rt = Topology(dp_degree=dp), RefTopology(dp_degree=dp)
    assert overlap.checkpoint_seconds(nbytes, pt, strategy) == \
        roverlap.checkpoint_seconds(nbytes, rt, strategy)
    for steady in (True, False):
        assert overlap.staging_seconds(nbytes, pt, steady) == \
            roverlap.staging_seconds(nbytes, rt, steady)
    for chunk in (0, 8 << 20, nbytes):
        assert overlap.chunk_overlap_fraction(nbytes, chunk) == \
            roverlap.chunk_overlap_fraction(nbytes, chunk)
    assert overlap.recovery_overhead_gpu_seconds(100, dp, 1.3) == \
        roverlap.recovery_overhead_gpu_seconds(100, dp, 1.3)


def test_peak_flops_is_required_and_no_inherited_peaks():
    cfg = configs.get_config("stablelm_1_6b")
    with pytest.raises(TypeError):
        overlap.estimate_iteration(cfg, 8, 2048, 8)
    names = {n for n in dir(overlap) if n.endswith("_FLOPS")}
    assert names == set()


# ================================================================ retry
def _flaky(n_failures, exc=IOError):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= n_failures:
            raise exc(f"blip {calls['n']}")
        return calls["n"]
    return fn


@pytest.mark.parametrize("n_failures,max_retries", [(0, 2), (2, 2),
                                                    (3, 2), (1, 0)])
def test_call_with_retry_equals_reference(n_failures, max_retries):
    out = []
    for mod in (retry, rretry):
        pol = mod.RetryPolicy(max_retries=max_retries, base_backoff=0.5)
        st = mod.RetryStats()
        slept = []
        try:
            res = mod.call_with_retry(_flaky(n_failures), pol, stats=st,
                                      rng=random.Random(7),
                                      sleep=slept.append)
        except IOError as e:
            res = str(e)
        out.append((res, st.attempts, st.retries, st.deadline_hits,
                    slept))
    assert out[0] == out[1]


def test_deadline_and_non_retryable_errors_equal_reference():
    for mod in (retry, rretry):
        ev = threading.Event()
        with pytest.raises(TimeoutError):
            mod.deadline_call(ev.wait, 0.05)
        ev.set()
        pol = mod.RetryPolicy(max_retries=3, retry_on=(IOError,))
        st = mod.RetryStats()
        with pytest.raises(ValueError):
            mod.call_with_retry(_flaky(5, ValueError), pol, stats=st)
        assert st.attempts == 1
        pol = mod.RetryPolicy(max_retries=1, base_backoff=0.0,
                              attempt_timeout=0.05)
        st = mod.RetryStats()
        with pytest.raises(TimeoutError):
            mod.call_with_retry(lambda: time.sleep(0.5), pol, stats=st)
        assert (st.attempts, st.deadline_hits) == (2, 2)
    assert np.isclose(retry.RetryPolicy(base_backoff=0.1).backoff(
        3, random.Random(1)), rretry.RetryPolicy(base_backoff=0.1).backoff(
        3, random.Random(1)))
