"""The crash-atomicity kill drive against the port: a process saving in
a loop through the port's engine is killed with SIGKILL mid-save; a
fresh engine sees the last step the dead process reported committed (or
a later one whose COMMIT had landed), loads it bit-exact, sweeps the
leftover staging, and the reference reads the same step. No tolerance:
bytes."""
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import torch

from repro.core.engine import CheckpointEngine as RefEngine
from repro.core.engine import CheckpointSpec as RefSpec
from repro_torch.core import layout
from repro_torch.core.engine import CheckpointEngine, CheckpointSpec

ROOT = Path(__file__).resolve().parents[1]
N = 4 << 20                                  # 16 MiB of float32 per save

LOOP = textwrap.dedent(f"""
    import sys, torch
    from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
    eng = CheckpointEngine(CheckpointSpec(sys.argv[1],
                                          backend=sys.argv[2]))
    w = torch.zeros({N})
    step = 0
    while True:
        step += 1
        w.fill_(float(step))
        eng.save({{"w": w, "s": torch.tensor([step])}}, step).wait()
        print("committed", step, flush=True)
""")


def _drive(directory, backend):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.Popen([sys.executable, "-c", LOOP, directory, backend],
                         stdout=subprocess.PIPE, text=True, env=env)
    committed = []
    deadline = time.time() + 120
    while len(committed) < 3 and time.time() < deadline:
        line = p.stdout.readline()
        if line.startswith("committed"):
            committed.append(int(line.split()[1]))
    time.sleep(0.05)                          # land inside a later save
    p.send_signal(signal.SIGKILL)
    p.wait()
    rest = p.stdout.read()
    committed += [int(x.split()[1]) for x in rest.splitlines()
                  if x.startswith("committed")]
    assert len(committed) >= 3, "the save loop never got going"
    return committed[-1]


def _check(directory, last):
    eng = CheckpointEngine(CheckpointSpec(directory))
    latest = eng.latest_step()
    assert latest is not None and latest >= last
    assert not [n for n in os.listdir(directory) if n.endswith(".tmp")]
    got, _ = eng.load(device="cpu")
    assert torch.equal(got["w"], torch.full((N,), float(latest)))
    assert int(got["s"][0]) == latest
    ref, _ = RefEngine(RefSpec(directory)).load(latest)
    assert np.asarray(ref["w"]).tobytes() == got["w"].numpy().tobytes()
    for step in layout.committed_steps(directory, legacy_ok=False):
        layout.verify_commit(os.path.join(directory,
                                          layout.step_dir_name(step)),
                             deep=True)


def test_kill_mid_save_leaves_the_last_commit_loadable(tmp_path):
    d = str(tmp_path / "ckpt")
    _check(d, _drive(d, "fastpersist"))


def test_kill_mid_pipelined_save_leaves_the_last_commit_loadable(tmp_path):
    d = str(tmp_path / "ckpt")
    _check(d, _drive(d, "fastpersist-pipelined"))
