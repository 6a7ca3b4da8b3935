"""Paper Fig. 8/15: parallel checkpoint writes — aggregate bandwidth vs
writer parallelism, Replica vs Socket subsets (the counterpart of
``benchmarks/fig8_parallel_writes.py``). One node's disk here, so the
contention (not the scaling) side of the figure is what this machine
can measure; the multi-node scaling side is the §4.2 analytic model.
The writers drain a host byte stream: the disk side of a save, after
the snapshot has left the device."""
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.benchmarks.common import (bench_dir, cleanup, emit,
                                           resolve_device, save_json,
                                           synth_bytes)
from repro_torch.core.partition import Topology, make_plan, \
    predict_write_seconds, select_writers
from repro_torch.core.serializer import ByteStreamView
from repro_torch.core.writer import WriterConfig, write_stream


def plan_for(total: int, n_writers: int, n_volumes: int = 1):
    """The (writers × volumes) plan ``parallel_write`` writes through."""
    return make_plan(total, Topology(dp_degree=n_writers,
                                     ranks_per_node=max(n_writers, 1)),
                     "replica", n_volumes=n_volumes)


def parallel_write(view, n_writers, directory, n_volumes=1) -> float:
    """Write the stream through a (writers × volumes) plan: each extent
    lands in its mapped volume's directory, one flusher per destination
    — the sharded layout's data path without the commit protocol."""
    plan = plan_for(view.total, n_writers, n_volumes)
    cfg = WriterConfig(io_buffer_size=32 * 2**20)
    vol_dirs = [os.path.join(directory, f"vol{v}")
                for v in range(max(n_volumes, 1))]
    for d in vol_dirs:
        os.makedirs(d, exist_ok=True)

    def one(extent):
        return write_stream(
            os.path.join(vol_dirs[extent.volume],
                         f"s{extent.shard_index}.bin"),
            view.slices(extent.offset, extent.length), extent.length, cfg)

    t0 = time.perf_counter()
    if n_writers == 1:
        one(plan.extents[0])
    else:
        with ThreadPoolExecutor(n_writers) as ex:
            list(ex.map(one, plan.extents))
    return time.perf_counter() - t0


def run(quick=True, device="cuda"):
    resolve_device(device)
    mb = 256 if quick else 1024
    data = synth_bytes(mb, seed=8)
    view = ByteStreamView([data])
    out = {}
    for w in ([1, 2, 4, 8] if quick else [1, 2, 4, 8, 16]):
        d = os.path.join(bench_dir(), f"f8_{w}")
        os.makedirs(d, exist_ok=True)
        t = min(parallel_write(view, w, d) for _ in range(2))
        shutil.rmtree(d, ignore_errors=True)
        gbps = view.total / t / 1e9
        out[w] = gbps
        emit(f"fig8/writers{w}", t, f"{gbps:.2f}GBps")

    # volume striping: same writer count, shards spread over 1..4
    # destination roots (the paper's per-node SSDs; here directories —
    # point FASTPERSIST_BENCH_DIR at a multi-disk mount to see the
    # hardware effect)
    for nv in ([1, 2, 4] if quick else [1, 2, 4, 8]):
        d = os.path.join(bench_dir(), f"f8v_{nv}")
        os.makedirs(d, exist_ok=True)
        t = min(parallel_write(view, 4, d, n_volumes=nv) for _ in range(2))
        shutil.rmtree(d, ignore_errors=True)
        gbps = view.total / t / 1e9
        out[f"4w_{nv}v"] = gbps
        emit(f"fig8/writers4_volumes{nv}", t, f"{gbps:.2f}GBps")

    # analytic multi-node projection (the paper's 8-node side)
    ck = 10 * 10**9
    for nodes in (1, 2, 4, 8):
        topo = Topology(dp_degree=16 * nodes, ranks_per_node=16)
        for strat, wpn in (("replica", 0), ("socket", 2)):
            ws = select_writers(topo, strat, wpn)
            t = predict_write_seconds(topo, ck, ws)
            emit(f"fig8/model_{nodes}node_{strat}", t,
                 f"{ck/t/1e9:.1f}GBps_model")

    save_json("fig8", {str(k): round(v, 3) for k, v in out.items()})
    return out


if __name__ == "__main__":
    run()
    cleanup()
