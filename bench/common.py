"""What the harness shares: a cell's files, the run's context, its spans,
a configuration's family module, the program's model configuration that
it builds, and the comparisons that decide ``correct``."""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")

#: the most a run may ask the program to write to disk
WRITE_BUDGET = int(2.5 * 2 ** 30)

#: the family of a configuration file without a ``family`` key
DEFAULT_FAMILY = "gpt"


def load(kind: str, name: str) -> dict:
    """``bench/<kind>/<name>.json``."""
    with open(os.path.join(BENCH, kind, name + ".json")) as f:
        return json.load(f)


def module(kind: str, name: str):
    """``bench/<kind>/<name>.py``, found by its name and loaded once."""
    key = f"bench.{kind}.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(BENCH, kind, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def family_name(cfg: dict) -> str:
    return cfg.get("family", DEFAULT_FAMILY)


def family(cfg: dict):
    """The configuration's family module, ``bench/families/<family>.py``:
    ``program_config``, ``param_shapes``, ``train_flops_per_step`` and,
    optionally, ``make_weights``."""
    return module("families", family_name(cfg))


def cell_params(workload: dict) -> tuple:
    """A cell's generator and parameters: its traffic mix's data file,
    ``bench/traffic/<traffic>.json``, which names the generator in
    ``bench/generators/``, with the cell's own ``limits``."""
    params = load("traffic", workload["traffic"])
    generator = params.pop("generator")
    return generator, dict(params, limits=workload["limits"])


def forbidden_loaded(modules=None) -> list:
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods
                   if m.split(".")[0] in FORBIDDEN})


@dataclass
class Ctx:
    """One run: the cell's configuration and traffic parameters, the seed
    and window, where checkpoints go, and the harness's spans."""
    config: dict
    params: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    ckpt_dir: str
    spans: list = field(default_factory=list)

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span: (name, start, end) on ``perf_counter``'s clock."""
        t0 = time.perf_counter()
        yield
        self.spans.append((name, t0, time.perf_counter()))


def model_config(cfg: dict):
    """The program's ``ModelConfig`` for a configuration file, as its
    family builds it."""
    return family(cfg).program_config(cfg)


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream().synchronize()


def leaf_norms(tree, scale: float = 1.0, minus=None) -> dict:
    """``{name: float64 norm}`` of each leaf of a program pytree (times
    ``scale``, less ``minus[name]`` when given)."""
    import torch
    from repro_torch.tree import flatten
    out = {}
    for name, t in flatten(tree):
        x = t.double() * scale
        if minus is not None:
            x = x - minus[name].to(t.device).double()
        out[name] = float(torch.linalg.vector_norm(x))
    return out


def worst_gap(prog: dict, ref: dict, keep=None) -> float:
    """The largest ``|prog - ref|`` over leaves, each against the larger
    of its reference norm and the median leaf's."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def moving_leaves(grad_ref: dict, share: float = 1e-3) -> set:
    """Leaves whose reference gradient is at least ``share`` of the median
    leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(grad_ref.values())
    return {n for n, g in grad_ref.items() if g >= share * med}


def state_mismatch(expect: dict, got: dict) -> int:
    """Leaves of ``expect`` ({name: tensor}) that ``got`` lacks or holds
    with other bytes, shape or dtype."""
    import torch
    bad = 0
    for name, a in expect.items():
        b = got.get(name)
        if b is None or b.dtype != a.dtype or tuple(b.shape) != tuple(
                a.shape):
            bad += 1
            continue
        a8 = a.detach().reshape(-1).view(torch.uint8)
        b8 = b.detach().to(a.device).reshape(-1).view(torch.uint8)
        bad += int(not torch.equal(a8, b8))
    return bad + sum(1 for n in got if n not in expect)


def check(name: str, value, limit) -> dict:
    return {"name": name, "value": value, "limit": limit,
            "ok": value is not None and value <= limit}
