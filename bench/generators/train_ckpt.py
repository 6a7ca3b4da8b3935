"""``train_ckpt``: training with checkpoints on a wall-clock interval, the
generator of every mix in ``bench/traffic/`` (``ckpt_overlap``,
``ckpt_blocking``, ``ckpt_rank_overlap``), whose parameters (backend,
warm steps, saves, traced steps and, optionally, the DP rank whose extent
each save writes, ``bench/extent.py``) it reads from ``ctx.params``.

The window runs the loop of the program's ``Trainer.run`` step for step:
``next(trainer.data)``, ``engine.wait_snapshot()`` for an async backend,
``trainer.train_step``, a synchronise; on the schedule, ``engine.save``
(with the trainer's retention after it). Set-up trains ``warm_steps``
steps and saves once, which fills the pinned staging arena. The window
then issues ``saves`` saves, save ``k`` at the first step boundary after
``k / (saves + 1)`` of the window, and ends with ``engine.drain()`` once
``--seconds`` have passed: a fixed number of bytes whatever the step time.
The state (for a rank mix, the bytes of its extent) is copied before each
of the window's last ``keep_last`` saves, the steps that retention keeps,
and the check reads each of them back.
"""
from __future__ import annotations

import os
import threading
import time

from bench import common, extent, inputs, trace
from bench.reference import layout
from bench.reference import train as ref_train

#: seconds the profiler runs before the traced stretch starts
TRACE_LEAD_S = 1.0


def build(ctx, backend: str, fp: dict):
    """The program's trainer over the configuration, with its state set to
    the run's weights (``{name: bf16 tensor}`` returned beside it)."""
    from repro_torch.core.checkpointer import FastPersistConfig
    from repro_torch.core.retention import RetentionPolicy
    from repro_torch.optim import adam
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.steps import TrainState, init_train_state
    from repro_torch.train.trainer import (CheckpointPolicy, Trainer,
                                           TrainerConfig)
    from repro_torch.tree import flatten
    from bench.reference.train import unflat
    cfg, p = ctx.config, ctx.params
    rows, micro = cfg["rows_per_step"], cfg["micro_batch"]
    trainer = Trainer(TrainerConfig(
        model=common.model_config(cfg), steps=0, global_batch=rows,
        seq_len=cfg["seq_len"], gas=rows // micro, seed=ctx.seed,
        opt=AdamConfig(**cfg["optimizer"]),
        checkpoint=CheckpointPolicy(
            directory=ctx.ckpt_dir, backend=backend,
            fp=FastPersistConfig(**fp),
            retention=RetentionPolicy(keep_last=p["keep_last"]))),
        device=ctx.device)
    if not trainer.engine.spec.fsync_commit:
        raise RuntimeError("the engine does not fsync its commits")
    w0 = inputs.make_weights(cfg, ctx.seed, ctx.device)
    like = {n: (tuple(t.shape), t.dtype) for n, t in flatten(
        init_train_state(trainer.model, 0, "meta").params)}
    mine = {n: (tuple(t.shape), t.dtype) for n, t in w0.items()}
    if like != mine:
        raise RuntimeError(f"the program's parameters {like} are not the "
                           f"configuration's {mine}")
    params = unflat({n: t.clone() for n, t in w0.items()})
    trainer.state = TrainState(params, adam.init(params))
    trainer.engine.invalidate_arena()
    return trainer, w0


def step_once(ctx, trainer):
    """One iteration of ``Trainer.run``'s loop; returns (metrics, seconds
    blocked on the previous save's snapshot)."""
    with ctx.span("data"):
        batch = next(trainer.data)
    stall = 0.0
    if trainer.engine.async_save:
        t = time.perf_counter()
        with ctx.span("wait_snapshot"):
            trainer.engine.wait_snapshot()
        stall = time.perf_counter() - t
    with ctx.span("train_step"):
        trainer.state, metrics = trainer.train_step(trainer.state, batch)
    with ctx.span("sync"):
        common.sync(ctx.device)
    return metrics, stall


def part(ctx):
    """``(rank, D, lo, hi)`` of a mix that saves one DP rank's extent of
    the stream, else None."""
    r = extent.rank_of(ctx.config, ctx.params)
    if r is None:
        return None
    rank, dp = r
    return (rank, dp, *extent.stripe_ranges(inputs.state_bytes(ctx.config),
                                            dp)[rank])


def save(ctx, trainer, step: int):
    """``Trainer._save`` and the retention after it, as ``Trainer.run``
    calls them; for a rank mix, of the rank's part of the state."""
    with ctx.span("save"):
        state = trainer.state
        extras = {"step": step, "data": trainer.data.state()}
        p = part(ctx)
        if p is not None:
            state = extent.share(state, p[2], p[3])
            extras.update(rank=p[0], data_parallel=p[1], extent=list(p[2:]))
        h = trainer.engine.save(state, step, extras)
        trainer.saves.append(h)
        if trainer._retain is not None:
            trainer._retain.after_commit()
    return h


def state_copy(state) -> dict:
    from repro_torch.tree import flatten
    return {n: t.detach().clone() for n, t in flatten(state)}


def copy_for_check(ctx, state):
    """What the check holds a save against: a copy of the state, or of
    the bytes of a rank mix's extent."""
    p = part(ctx)
    return state_copy(state) if p is None else extent.flat(state, *p[2:])


def warm_up(ctx, trainer, w0: dict, n_steps: int):
    """Set-up's steps through the window's own call and feed. Returns the
    losses, the first gradient's leaf norms as Adam got it (its first
    moment over ``1 - b1``) and each leaf's change over the steps."""
    b1 = ctx.config["optimizer"]["b1"]
    losses, grad = [], None
    for _ in range(n_steps):
        metrics, _ = step_once(ctx, trainer)
        losses.append(float(metrics["loss"]))
        if grad is None:
            grad = common.leaf_norms(trainer.state.opt.m, 1 / (1 - b1))
    delta = common.leaf_norms(trainer.state.opt.master, minus=w0)
    return {"loss": losses, "grad": grad, "delta": delta}


def compare(ctx, w0: dict, prog: dict, n_steps: int, limits: dict,
            ref_out=None) -> list:
    """The reference's first ``n_steps`` from the same weights and stream,
    held against the program's: each number that ``limits`` names
    (``ref_out``, a dict, receives the reference's readings)."""
    cfg = ctx.config
    ref = ref_train.follow(cfg, cfg["optimizer"], ctx.seed, w0, n_steps,
                           cfg["rows_per_step"], cfg["micro_batch"],
                           ctx.device)
    if ref_out is not None:
        ref_out.update(ref)
    gaps = {}
    if "loss_gap" in limits:
        gaps["loss_gap"] = max(abs(a - b) / abs(b) for a, b in zip(
            prog["loss"], ref["loss"]))
    if "grad_gap" in limits:
        gaps["grad_gap"] = common.worst_gap(prog["grad"], ref["grad"])
    if "delta_gap" in limits:
        gaps["delta_gap"] = common.worst_gap(
            prog["delta"], ref["delta"], common.moving_leaves(ref["grad"]))
    return [common.check(k, v, limits[k]) for k, v in gaps.items()]


def control_step(ctx, limits=None) -> list:
    """The control of the training numbers: the reference itself, put in
    the program's place and computed one precision below what the
    configuration states, its weights, master weights and moments in
    bfloat16, held against the float32 reference as the program is."""
    import torch
    cfg, n = ctx.config, ctx.params["warm_steps"]
    w0 = inputs.make_weights(cfg, ctx.seed, ctx.device)
    low = ref_train.follow(cfg, cfg["optimizer"], ctx.seed, w0, n,
                           cfg["rows_per_step"], cfg["micro_batch"],
                           ctx.device, dtype=torch.bfloat16)
    return compare(ctx, w0, low, n, limits or ctx.params["limits"])


def _watch(handle, t_call: float, out: list, i: int):
    """``out[i]``: seconds from the save's call to its durable commit
    (None when the save failed)."""
    try:
        handle.wait()
        out[i] = time.perf_counter() - t_call
    except BaseException:      # noqa: BLE001 - a failed save is counted
        pass


def release(ctx, trainer):
    """Frees the program's state and engine before the reference runs. The
    state is held in reference cycles after a step, so a collection is what
    returns its memory; the cache is emptied for the reference."""
    import gc
    import torch
    trainer.state = None
    trainer.engine.close()
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()


def run(ctx) -> dict:
    import torch
    p = ctx.params
    marks = [time.perf_counter()]
    trainer, w0 = build(ctx, p["backend"], p.get("fp", {}))
    cfg = ctx.config
    tokens_per_step = cfg["rows_per_step"] * cfg["seq_len"]

    # ---- set-up: warm steps, then a save that fills the pinned arena
    marks.append(time.perf_counter())
    prog = warm_up(ctx, trainer, w0, p["warm_steps"])
    step = p["warm_steps"]
    n_saves = p["saves"]
    # the saves that retention keeps are read back: a copy before each
    copies = {} if n_saves else {step: copy_for_check(ctx, trainer.state)}
    checked = range(n_saves - min(p["keep_last"], n_saves), n_saves)
    marks.append(time.perf_counter())
    h = save(ctx, trainer, step)
    warm = h.wait()
    metrics = None

    # ---- the window
    due = [ctx.seconds * (k + 1) / (n_saves + 1) for k in range(n_saves)]
    handles, commits, watchers = [], [None] * n_saves, []
    stall, n_steps = 0.0, 0
    stretch, prof_t0, prof_t1, prof_steps = None, None, None, 0
    trace_left = p["trace_steps"] if ctx.trace and n_saves else 0
    setup_end = time.perf_counter()
    t0 = setup_end
    marks.append(setup_end)
    while True:
        now = time.perf_counter() - t0
        if trace_left and stretch is None and now >= due[0] - TRACE_LEAD_S:
            # the profiler starts a little before the stretch it reads,
            # so that its own start-up falls outside the stretch
            prof_t0 = time.perf_counter()
            stretch = trace.Stretch()
        if len(handles) < n_saves and now >= due[len(handles)]:
            if stretch is not None and stretch.t0 is None:
                stretch.start()
            if len(handles) in checked:
                copies[step] = copy_for_check(ctx, trainer.state)
            t = time.perf_counter()
            h = save(ctx, trainer, step)
            stall += time.perf_counter() - t
            handles.append(h)
            w = threading.Thread(target=_watch,
                                 args=(h, t, commits, len(handles) - 1))
            w.start()
            watchers.append(w)
        elif len(handles) == n_saves and now >= ctx.seconds:
            break
        metrics, s = step_once(ctx, trainer)
        stall += s
        step += 1
        n_steps += 1
        if stretch is not None and prof_t1 is None:
            prof_steps += 1
            if stretch.t0 is not None:
                trace_left -= 1
                if not trace_left:
                    stretch.stop()
                    prof_t1 = time.perf_counter()
    if stretch is not None and prof_t1 is None:
        stretch.stop()
        prof_t1 = time.perf_counter()
    t = time.perf_counter()
    with ctx.span("drain"):
        trainer.engine.drain()
    stall += time.perf_counter() - t
    window = time.perf_counter() - t0
    for w in watchers:
        w.join()

    # ---- after the window: counts, the peak, then the checks
    stats = [h.wait() for h, c in zip(handles, commits) if c is not None]
    written = [s.total_bytes for s in [warm, *stats]]
    failed = n_saves - len(stats)
    if metrics is not None:
        failed += int(not torch.isfinite(metrics["loss"]).item())
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(ctx.device).type == "cuda" else 0)
    checks = check_saved(ctx, trainer, copies,
                         [vars(s) for s in [warm, *stats]])
    release(ctx, trainer)
    checks += compare(ctx, w0, prog, p["warm_steps"], p["limits"])

    rec = {"saves": [vars(s) for s in stats], "window_s": window,
           "window_steps": n_steps, "tokens_per_step": tokens_per_step,
           # the part of the window the profiler did not slow
           "untraced_steps": n_steps - prof_steps,
           "untraced_s": window - ((prof_t1 - prof_t0) if stretch else 0),
           "stall_per_save_s": stall / max(n_saves, 1), "commit_s": commits}
    if stretch is not None:
        rec["trace"] = stretch.result(ctx.spans)
    return {
        "attempted": n_steps + n_saves, "failed": failed,
        "setup_end": setup_end,
        "setup_phases": dict(zip(("build", "warm_steps", "warm_save"), (
            b - a for a, b in zip(marks, marks[1:])))),
        "end_to_end": {
            "train_tokens_per_s": n_steps * tokens_per_step / window,
            "ckpt_stall_s": rec["stall_per_save_s"],
            "commit_s": (sum(commits) / n_saves
                         if n_saves and None not in commits else None),
        },
        "records": rec, "checks": checks, "memory_peak_bytes": peak,
        "bytes_written": sum(written),
    }


def check_saved(ctx, trainer, copies: dict, saves=()) -> list:
    """Each step of ``copies`` (``{step: copy taken at its save}``), the
    newest the engine's latest, read back by the plain layout reader and
    held byte for byte against its copy; for a rank mix, as
    ``rank_mismatch`` holds a part, and every save of ``saves`` (its
    ``SaveStats`` as dicts) must have taken and written the extent."""
    limit = ctx.params["limits"]["saved_mismatch"]
    if not copies or trainer.engine.latest_step() != max(copies):
        return [common.check("saved_mismatch", None, limit)]
    p = part(ctx)
    bad = 0
    for step, saved in copies.items():
        try:
            records, man, problems = layout.read_step(
                os.path.join(ctx.ckpt_dir, f"ckpt_{step:08d}"))
        except OSError:
            bad += 1
            continue
        if p is None:
            bad += common.state_mismatch(saved, records)
        else:
            bad += rank_mismatch(ctx.config, trainer.state, p, saved,
                                 records, man)
        bad += len(problems) + int(man.get("extras", {}).get("step") != step)
    if p is not None:
        bad += sum(int(not s["total_bytes"] == s["d2h_bytes"] == p[3] - p[2])
                   for s in saves)
    return [common.check("saved_mismatch", bad, limit)]


def rank_mismatch(cfg: dict, state, p: tuple, saved, records: dict,
                  man: dict) -> int:
    """Misses of one rank's part read back: the state's stream against the
    configuration's ``state_bytes``; the manifest's length against the
    carve of rank r of D; its records' names, dtypes and shapes against the
    pieces of the state that the extent overlaps; and their bytes, in
    stream order, against ``saved``, the copy of the extent's bytes."""
    import torch
    from repro_torch.tree import flatten
    _, _, lo, hi = p
    bad = int(extent.stream_size(flatten(state)) != inputs.state_bytes(cfg))
    bad += int(man.get("total_bytes") != hi - lo)
    listed = [(r["name"], r["dtype"], list(r["shape"]))
              for r in man["records"]]
    bad += int(listed != [(n, "uint8", [v.numel()]) for n, v in flatten(
        extent.share(state, lo, hi))])
    got = [records[r["name"]].reshape(-1).view(torch.uint8)
           for r in man["records"] if r["name"] in records]
    got = torch.cat(got) if got else torch.empty(0, dtype=torch.uint8)
    return bad + int(not torch.equal(got.to(saved.device), saved))
