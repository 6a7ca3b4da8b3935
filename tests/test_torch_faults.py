"""Fault injection for the port's durability tiers, and the states the
port's tier tests share.

The counterparts of ``tests/faults.py``, on the port's store: those
subclass the reference's ``LocalObjectStore``, these subclass
``repro_torch.core.upload.LocalObjectStore`` with the same knobs —

  * :class:`FlakyStore` — scripted failures (fail a key's next N puts,
    fail every COMMIT put, die after N ops), a dead/alive switch, a
    slow-WAN gate and per-key success counts (``put_ok``);
  * :class:`OrderAssertingStore` — the COMMIT object is put strictly
    last;
  * :func:`truncate_object` / :func:`corrupt_object` — a torn or
    bit-rotted stored object;
  * :func:`crash_before_commit` — the port engine's next local COMMIT
    marker write raises.

The other ``tests/test_torch_*.py`` tier files import this module; its
own tests hold the tools to their contract. Everything is deterministic.
"""
import dataclasses
import json
import threading
import time
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models.registry import build_model as ref_build
from repro.train.steps import init_train_state as ref_init_state
from repro_torch.core.upload import REMOTE_COMMIT, LocalObjectStore, cas_key
from repro_torch.tree import flatten

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256)


# ============================================================ fault tools
class FlakyStore(LocalObjectStore):
    """Filesystem mock bucket with scripted fault injection (the knobs of
    ``tests/faults.py::FlakyStore``): ``fail_once`` keys fail their next
    put, ``fail_schedule[key] = n`` fails the next n puts (-1: forever),
    ``fail_commits`` fails every COMMIT put, ``die_after_ops`` kills the
    store after that many operations, :meth:`hold_puts` blocks puts until
    :meth:`release_puts`, ``latency`` sleeps per op. A dead store raises
    ``IOError`` on every operation until :meth:`revive`."""

    def __init__(self, root, latency=0.0, die_after_ops=None,
                 fail_commits=False):
        super().__init__(root)
        self.put_ok = Counter()
        self.fail_once = set()
        self.fail_schedule = {}
        self.fail_commits = fail_commits
        self.latency = latency
        self.die_after_ops = die_after_ops
        self.ops = 0
        self.dead = False
        self.gate = threading.Event()
        self.gate.set()

    def kill(self):
        self.dead = True

    def revive(self):
        self.dead = False
        self.die_after_ops = None

    def hold_puts(self):
        self.gate.clear()

    def release_puts(self):
        self.gate.set()

    def _op(self):
        if self.dead:
            raise IOError(f"injected dead store: {self.root}")
        self.ops += 1
        if self.die_after_ops is not None and self.ops > self.die_after_ops:
            self.dead = True
            raise IOError(f"injected dead store (after "
                          f"{self.die_after_ops} ops): {self.root}")
        if self.latency:
            time.sleep(self.latency)

    def _maybe_fail_put(self, key):
        self._op()
        self.gate.wait()
        if self.fail_commits and key.endswith("/" + REMOTE_COMMIT):
            raise IOError(f"injected crash before remote COMMIT: {key}")
        if key in self.fail_once:
            self.fail_once.discard(key)
            raise IOError(f"injected transient failure for {key}")
        n = self.fail_schedule.get(key, 0)
        if n:
            if n > 0:
                self.fail_schedule[key] = n - 1
            raise IOError(f"injected scheduled failure for {key}")

    def put(self, key, data):
        self._maybe_fail_put(key)
        super().put(key, data)
        self.put_ok[key] += 1

    def put_file(self, key, path):
        self._maybe_fail_put(key)
        super().put_file(key, path)
        self.put_ok[key] += 1

    def get(self, key):
        self._op()
        return super().get(key)

    def get_to(self, key, path, offset=0, length=None):
        self._op()
        super().get_to(key, path, offset=offset, length=length)

    def exists(self, key):
        self._op()
        return super().exists(key)

    def size(self, key):
        self._op()
        return super().size(key)

    def list(self, prefix=""):
        self._op()
        return super().list(prefix)

    def delete(self, key):
        self._op()
        super().delete(key)


class OrderAssertingStore(LocalObjectStore):
    """Asserts the COMMIT object is put strictly LAST: at its put() every
    payload object it names already exists (content-addressed or under
    the generation's prefix)."""

    def put(self, key, data):
        assert key.endswith("/" + REMOTE_COMMIT), \
            f"unexpected non-COMMIT put() of {key}"
        marker = json.loads(data.decode())
        prefix = key.rsplit("/", 1)[0]
        digests = marker.get("object_digest") or {}
        for name in marker["objects"]:
            obj_key = (cas_key(digests[name]) if name in digests
                       else f"{prefix}/{name}")
            assert self.exists(obj_key), \
                f"COMMIT written before payload object {name} ({obj_key})"
        super().put(key, data)


def truncate_object(store, key, at):
    """Torn write: the stored object keeps only its first ``at`` bytes."""
    store.put(key, store.get(key)[:at])


def corrupt_object(store, key, at, xor=0xFF):
    """Bit-rot: XOR the byte at offset ``at`` of the stored object."""
    data = bytearray(store.get(key))
    data[at] ^= xor
    store.put(key, bytes(data))


def crash_before_commit(monkeypatch, message="injected crash before COMMIT"):
    """Make the port engine's NEXT local COMMIT-marker write raise (a
    writer dying between payload and COMMIT). Returns the real function;
    the monkeypatch fixture restores it at teardown."""
    import repro_torch.core.engine as engine_mod
    from repro_torch.core import layout
    real = layout.write_commit_marker

    def boom(*a, **kw):
        raise RuntimeError(message)

    monkeypatch.setattr(engine_mod.layout, "write_commit_marker", boom)
    return real


# ================================================= shared test states
def np_state(seed=0):
    """A reduced stablelm_1_6b train state (49 records: bf16 params, f32
    master, m, v, step) from the reference's initializer, as numpy."""
    cfg = dataclasses.replace(
        rconfigs.reduced(rconfigs.get_config("stablelm_1_6b")), **TINY)
    return jax.tree.map(np.asarray,
                        ref_init_state(ref_build(cfg),
                                       jax.random.PRNGKey(seed)))


def mutate(tree, seed):
    """A copy of ``tree`` with a few blocks of every third float leaf and
    the integer leaves changed (what one optimizer step leaves dirty)."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, tree)
    for i, (_, a) in enumerate(flatten(out)):
        if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
            if i % 3 == 0:
                flat = a.reshape(-1)
                idx = rng.choice(flat.size, max(1, flat.size // 500),
                                 replace=False)
                flat[idx] = (flat[idx].astype(np.float32) + 1).astype(
                    a.dtype)
        else:
            a += 1
    return out


def bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().reshape(-1).contiguous() \
            .view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def assert_equal_state(loaded, expected_tree):
    """Every leaf of ``loaded`` (a flat dict or a tree) bit-equal to the
    same-named leaf of ``expected_tree``."""
    got = loaded if isinstance(loaded, dict) and all(
        isinstance(k, str) for k in loaded) else dict(flatten(loaded))
    want = dict(flatten(expected_tree))
    assert sorted(got) == sorted(want)
    for name, a in got.items():
        assert bits(a) == bits(want[name]), name


# ========================================== the tools hold their contract
def test_flaky_store_schedules_heal_and_count(tmp_path):
    s = FlakyStore(str(tmp_path / "b"))
    s.fail_once.add("k")
    s.fail_schedule["j"] = 2
    with pytest.raises(IOError, match="transient"):
        s.put("k", b"x")
    s.put("k", b"x")
    for _ in range(2):
        with pytest.raises(IOError, match="scheduled"):
            s.put("j", b"y")
    s.put("j", b"y")
    assert s.put_ok == Counter({"k": 1, "j": 1})
    assert s.get("k") == b"x" and s.size("j") == 1


def test_flaky_store_dies_after_ops_and_revives(tmp_path):
    s = FlakyStore(str(tmp_path / "b"), die_after_ops=2)
    s.put("a", b"1")
    s.put("b", b"2")
    with pytest.raises(IOError, match="dead"):
        s.get("a")
    with pytest.raises(IOError, match="dead"):
        s.list()                          # reads fail too once dead
    s.revive()
    assert sorted(s.list()) == ["a", "b"]


def test_flaky_store_fails_only_commit_puts(tmp_path):
    s = FlakyStore(str(tmp_path / "b"), fail_commits=True)
    s.put("ckpt_00000001.gen-x/shard_000.bin", b"p")
    with pytest.raises(IOError, match="before remote COMMIT"):
        s.put("ckpt_00000001.gen-x/" + REMOTE_COMMIT, b"{}")


def test_order_asserting_store_refuses_early_commit(tmp_path):
    s = OrderAssertingStore(str(tmp_path / "b"))
    commit = {"objects": {"shard_000.bin": 3},
              "object_digest": {"shard_000.bin": "00000001-3"}}
    with pytest.raises(AssertionError, match="before payload"):
        s.put("ckpt_00000001.gen-x/" + REMOTE_COMMIT,
              json.dumps(commit).encode())
    s.put_file(cas_key("00000001-3"), __file__)
    s.put("ckpt_00000001.gen-x/" + REMOTE_COMMIT,
          json.dumps(commit).encode())


def test_truncate_and_corrupt_object(tmp_path):
    s = LocalObjectStore(str(tmp_path / "b"))
    s.put("k", b"abcdef")
    corrupt_object(s, "k", 1)
    assert s.get("k") == b"a" + bytes([ord("b") ^ 0xFF]) + b"cdef"
    truncate_object(s, "k", 2)
    assert s.size("k") == 2
