"""A plain reader of one committed checkpoint directory, written from the
on-disk layout (layout v1 keyframes, one volume): ``COMMIT`` (JSON: the
manifest's CRC32, the payload files and their sizes), ``manifest.json``
(records: name, dtype, shape, offset and length in the logical stream;
``plan.extents``: which bytes of the stream each ``shard_NNN.bin`` holds,
from its start, with their CRC32) and the shard files.
"""
from __future__ import annotations

import json
import os
import zlib

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16, "int32": torch.int32,
          "int64": torch.int64, "int8": torch.int8, "uint8": torch.uint8}


def read_step(step_dir: str):
    """Returns ``(records, manifest, problems)``: ``{name: CPU tensor}``,
    the manifest dict, and a list of what failed a check (empty when the
    directory is whole)."""
    problems = []
    with open(os.path.join(step_dir, "COMMIT")) as f:
        commit = json.load(f)
    with open(os.path.join(step_dir, "manifest.json"), "rb") as f:
        raw = f.read()
    if zlib.crc32(raw) != commit.get("manifest_crc32"):
        problems.append("manifest crc")
    for name, size in commit.get("files", {}).items():
        path = os.path.join(step_dir, name)
        if not os.path.exists(path) or os.path.getsize(path) != size:
            problems.append(f"size of {name}")
    man = json.loads(raw)
    stream = bytearray(man["total_bytes"])
    for e in man["plan"]["extents"]:
        if e.get("volume", 0) != 0:
            problems.append(f"extent on volume {e['volume']}")
            continue
        path = os.path.join(step_dir, f"shard_{e['shard_index']:03d}.bin")
        with open(path, "rb") as f:
            data = f.read(e["length"])
        if len(data) != e["length"]:
            problems.append(f"short shard {e['shard_index']}")
        if "crc32" in e and zlib.crc32(data) != e["crc32"]:
            problems.append(f"crc of shard {e['shard_index']}")
        stream[e["offset"]:e["offset"] + len(data)] = data
    records = {}
    for r in man["records"]:
        dt = DTYPES.get(r["dtype"])
        if dt is None:
            problems.append(f"dtype {r['dtype']} of {r['name']}")
            continue
        n = r["nbytes"] // dt.itemsize
        t = torch.frombuffer(stream, dtype=dt, count=n, offset=r["offset"])
        records[r["name"]] = t.reshape(r["shape"]).clone() if n else \
            torch.empty(r["shape"], dtype=dt)
    return records, man, problems
