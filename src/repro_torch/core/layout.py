"""Checkpoint directory layout + crash-atomic commit protocol.

A checkpoint is PUBLISHED, never written in place (DESIGN.md §3/§5):

    ckpt_00000042.tmp/        staging on the PRIMARY root — the global
      manifest.json           index plus any primary-resident shards
      shard_000.bin ...
    <volume>/ckpt_00000042.shards-<nonce>.tmp/
      shard_001.bin ...       per-volume staging for striped shards
    ckpt_00000042.tmp/COMMIT  global marker: layout_version, manifest
                              CRC32, every payload file's size, and —
                              layout v2 — every shard's (volume, dir,
                              size, crc32) across ALL volumes
    ckpt_00000042/            os.replace() of the primary staging dir —
                              the single atomic publish point

Secondary-volume shard directories are published (renamed to their
final generation name) BEFORE the global COMMIT is written, but they
are meaningless until a committed primary references them — readers
only ever discover shards through the primary's COMMIT. Striped delta
generations (DESIGN.md §13) follow the SAME protocol: their packed
dirty-span payload is carved across per-volume shards, the COMMIT
carries the same per-shard ``(volume, dir, size, crc32)`` entries as a
v2 keyframe, and ``clean_stale_multi`` sweeps their orphans
identically — there is one publish rule, not one per generation kind. A crash at ANY
instant therefore leaves either (a) stale ``.tmp``/unreferenced shard
directories that readers ignore and startup sweeps, or (b) a fully
committed checkpoint. There is no third state.

Readers use :func:`committed_steps` / :func:`verify_commit`; anything
that fails the marker checks (missing COMMIT, checksum mismatch,
truncated payload file or shard on any volume, unknown future
``layout_version``) is treated as torn and skipped — or raised loudly
on an explicit ``load``.
"""
from __future__ import annotations

import json
import os
import re
import zlib
from typing import Dict, List, Optional, Sequence

#: Bump when the on-disk layout changes incompatibly. Readers refuse
#: directories whose COMMIT declares a NEWER version (forward compat).
#: v1 = single-directory payloads; v2 = sharded multi-volume layout
#: (global index + per-volume shard dirs); v3 = incremental DELTA
#: generations (DESIGN.md §9: the payload is a packed dirty-span
#: stream, the COMMIT/manifest carry the span table and the base
#: generation's (step, nonce) identity). Each stamp is the MINIMUM
#: version that can read the directory: v1 dirs remain readable (their
#: markers carry no ``shards``/``volume_dirs``, so every check and
#: shard-path resolution falls back to the primary directory), and full
#: keyframes are still stamped v2 so pre-delta readers load them after
#: a rollback.
LAYOUT_VERSION = 3
#: stamp of a full (keyframe / non-delta) sharded checkpoint
SHARDED_LAYOUT_VERSION = 2
#: stamp of an incremental delta generation
DELTA_LAYOUT_VERSION = 3

COMMIT_FILE = "COMMIT"
MANIFEST_FILE = "manifest.json"
STAGING_SUFFIX = ".tmp"

_STEP_RE = re.compile(r"^ckpt_(\d+)$")
_STAGING_RE = re.compile(r"^ckpt_(\d+)\.tmp$")
_SHARDS_RE = re.compile(r"^ckpt_(\d+)\.shards-([0-9a-f]+)$")
_SHARDS_DEBRIS_RE = re.compile(r"^ckpt_(\d+)\.shards-[0-9a-f]+\.(tmp|trash)$")


class CheckpointError(IOError):
    """Base class for checkpoint layout/commit errors."""


class TornCheckpointError(CheckpointError):
    """An uncommitted or torn (partially persisted) checkpoint was read."""


def step_dir_name(step: int) -> str:
    return f"ckpt_{step:08d}"


def staging_dir_name(step: int) -> str:
    return step_dir_name(step) + STAGING_SUFFIX


def parse_step(name: str) -> Optional[int]:
    """Step number of a COMMITTED directory name, else None. Defensive:
    staging dirs, ``ckpt_foo``, stray files all map to None."""
    m = _STEP_RE.match(name)
    return int(m.group(1)) if m else None


def parse_staging_step(name: str) -> Optional[int]:
    m = _STAGING_RE.match(name)
    return int(m.group(1)) if m else None


def shard_dir_name(step: int, nonce: str) -> str:
    """Final name of a secondary volume's shard directory. The nonce
    makes every save generation collision-free, so re-saving a step
    never overwrites the committed generation's shard files in place —
    old generations become unreferenced and are swept."""
    return f"{step_dir_name(step)}.shards-{nonce}"


def shard_staging_dir_name(step: int, nonce: str) -> str:
    return shard_dir_name(step, nonce) + STAGING_SUFFIX


def parse_shard_dir(name: str) -> Optional[int]:
    """Step of a published shard directory name, else None."""
    m = _SHARDS_RE.match(name)
    return int(m.group(1)) if m else None


def shard_dirs_for_step(root: str, step: int) -> List[str]:
    """All published shard-generation dirs for ``step`` under ``root``."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    return sorted(os.path.join(root, n) for n in names
                  if parse_shard_dir(n) == step
                  and os.path.isdir(os.path.join(root, n)))


def resolve_shard_dir(marker: Optional[dict], directory: str, volume: int,
                      volume_roots: Optional[Sequence[str]] = None) -> str:
    """Directory holding a given volume's shard files for a committed
    checkpoint. Layout v1 markers (and primary-resident volumes) resolve
    to the checkpoint directory itself; v2 markers record the shard
    directory name per volume plus the writer's volume roots. The
    writer-recorded root wins; the caller's ``volume_roots`` is the
    fallback when the recorded path no longer exists (relocated
    volume)."""
    vd = (marker or {}).get("volume_dirs") or {}
    name = vd.get(str(volume))
    if name is None:
        return directory
    roots = (marker or {}).get("volume_roots") or []
    candidates = []
    if volume < len(roots):
        candidates.append(os.path.join(roots[volume], name))
    if volume_roots is not None and volume < len(volume_roots):
        candidates.append(os.path.join(volume_roots[volume], name))
    for c in candidates:
        if os.path.isdir(c):
            return c
    return candidates[0] if candidates else os.path.join(directory, name)


def _fsync_path(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def manifest_crc32(directory: str) -> int:
    with open(os.path.join(directory, MANIFEST_FILE), "rb") as f:
        return zlib.crc32(f.read())


def payload_files(directory: str) -> Dict[str, int]:
    """{relative filename: size} for every payload file (COMMIT excluded)."""
    out = {}
    for name in sorted(os.listdir(directory)):
        if name == COMMIT_FILE:
            continue
        p = os.path.join(directory, name)
        if os.path.isfile(p):
            out[name] = os.path.getsize(p)
    return out


def write_commit_marker(directory: str, step: int, backend: str,
                        fsync: bool = True,
                        shards: Optional[List[dict]] = None,
                        volume_roots: Optional[Sequence[str]] = None,
                        volume_dirs: Optional[Dict[str, str]] = None,
                        generation: Optional[str] = None,
                        delta: Optional[dict] = None
                        ) -> dict:
    """Seal ``directory`` (still at its staging path): checksum the
    manifest, record every payload file's size — and, for the sharded
    layout, every shard's (volume, size, crc32) plus the per-volume
    shard directory names — write COMMIT, fsync. This one marker is the
    global commit record for the whole multi-volume checkpoint.

    The stamped ``layout_version`` is the MINIMUM version able to read
    the directory: a delta generation (``delta`` set) is v3, a
    checkpoint referencing secondary volume dirs is v2, and everything
    else is physically a v1 layout (one directory holds everything) so
    pre-sharding readers, which refuse markers from a NEWER version,
    can still load it after a rollback. The extra ``shards`` key is
    additive and ignored by v1 readers.

    ``generation`` is the save's random nonce — the identity a later
    delta's ``delta["base_gen"]`` must match for its chain to be valid
    (DESIGN.md §9); ``delta`` is the DeltaPlan meta dict of a delta
    generation (base identity + dirty-span table + per-span CRCs)."""
    marker = {
        "layout_version": (DELTA_LAYOUT_VERSION if delta
                           else SHARDED_LAYOUT_VERSION if volume_dirs
                           else 1),
        "step": step,
        "backend": backend,
        "manifest_crc32": manifest_crc32(directory),
        "files": payload_files(directory),
    }
    if generation:
        marker["generation"] = generation
    if delta:
        marker["delta"] = dict(delta)
    if shards:
        marker["shards"] = list(shards)
    if volume_roots is not None:
        marker["volume_roots"] = [os.path.abspath(r) for r in volume_roots]
    if volume_dirs:
        marker["volume_dirs"] = dict(volume_dirs)
    path = os.path.join(directory, COMMIT_FILE)
    with open(path, "w") as f:
        json.dump(marker, f)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    if fsync:
        _fsync_path(directory)
    return marker


def read_commit_marker(directory: str) -> Optional[dict]:
    """Parsed COMMIT marker, or None if absent/unparseable/from-the-future."""
    try:
        with open(os.path.join(directory, COMMIT_FILE)) as f:
            marker = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(marker, dict):
        return None
    if marker.get("layout_version", 0) > LAYOUT_VERSION:
        return None            # written by a newer release — don't guess
    return marker


def _manifest_meta(directory: str) -> Optional[dict]:
    """Parsed manifest.json of a step dir, else None (chain helpers'
    fallback for standalone/legacy saves that carry no COMMIT)."""
    try:
        with open(os.path.join(directory, MANIFEST_FILE)) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return None
    return meta if isinstance(meta, dict) else None


def delta_base(directory: str) -> Optional[tuple]:
    """``(base_step, base_gen)`` the delta generation in ``directory``
    chains off, or None for keyframes / absent dirs. The COMMIT marker
    is authoritative; standalone saves (no COMMIT) fall back to the
    manifest meta. Retention uses this to pin every keyframe (and
    intermediate delta) a live delta's restore path runs through."""
    marker = read_commit_marker(directory)
    if marker is not None:
        info = marker.get("delta")
    else:
        info = (_manifest_meta(directory) or {}).get("delta")
    if not isinstance(info, dict) or "base_step" not in info:
        return None
    return int(info["base_step"]), str(info.get("base_gen", ""))


def chain_steps(primary_root: str, step: int,
                max_hops: int = 10000) -> List[int]:
    """The full restore chain of ``step`` under ``primary_root``,
    oldest-first: ``[keyframe, ..., base, step]``. A full (non-delta)
    checkpoint is its own one-element chain. Used by the peer tier to
    ship every generation a replicated delta needs for replay
    (DESIGN.md §11).

    Raises:
        CheckpointError: a chain link's base directory is missing
            locally (the chain cannot be enumerated, let alone
            replicated), or the chain exceeds ``max_hops`` links
            (cyclic/corrupt metadata).
    """
    chain = [step]
    cur = step
    while True:
        base = delta_base(os.path.join(primary_root, step_dir_name(cur)))
        if base is None:
            if os.path.isdir(os.path.join(primary_root,
                                          step_dir_name(cur))):
                return list(reversed(chain))
            raise CheckpointError(
                f"delta chain of step {step}: link step {cur} has no "
                f"local directory under {primary_root}")
        if len(chain) >= max_hops:
            raise CheckpointError(
                f"delta chain of step {step} exceeds {max_hops} links "
                f"— cyclic or corrupt COMMIT metadata")
        cur = base[0]
        chain.append(cur)


def generation_of(directory: str) -> Optional[str]:
    """The save-generation nonce of a committed step dir (marker first,
    manifest-meta fallback), or None when the dir predates generation
    stamping. Delta chains compare this against their recorded
    ``base_gen`` to refuse replaying onto a re-saved base."""
    marker = read_commit_marker(directory)
    if marker is not None and marker.get("generation"):
        return str(marker["generation"])
    meta = _manifest_meta(directory)
    if meta and meta.get("generation"):
        return str(meta["generation"])
    return None


def verify_commit(directory: str, deep: bool = True,
                  volume_roots: Optional[Sequence[str]] = None) -> dict:
    """Validate a checkpoint directory against its COMMIT marker.

    Raises :class:`TornCheckpointError` when the marker is missing or the
    payload does not match it. ``deep`` additionally stats every payload
    file (size) — INCLUDING shards striped onto other volumes — and
    re-checksums the manifest; cheap (no shard reads) and catches
    truncated shards from a writer killed mid-flight.
    """
    marker = read_commit_marker(directory)
    if marker is None:
        raise TornCheckpointError(
            f"{directory}: no valid COMMIT marker — checkpoint was never "
            f"committed (or was written by a newer layout_version)")
    if not deep:
        return marker
    for name, size in marker.get("files", {}).items():
        p = os.path.join(directory, name)
        if not os.path.isfile(p):
            raise TornCheckpointError(f"{directory}: payload file {name} "
                                      f"missing")
        actual = os.path.getsize(p)
        if actual != size:
            raise TornCheckpointError(
                f"{directory}: {name} is {actual} bytes, COMMIT recorded "
                f"{size} — torn write")
    for sh in marker.get("shards", []):
        d = resolve_shard_dir(marker, directory, int(sh.get("volume", 0)),
                              volume_roots)
        p = os.path.join(d, sh["name"])
        if not os.path.isfile(p):
            raise TornCheckpointError(
                f"{directory}: shard {sh['name']} missing from volume "
                f"{sh.get('volume', 0)} ({d})")
        actual = os.path.getsize(p)
        if actual != sh["size"]:
            raise TornCheckpointError(
                f"{directory}: shard {sh['name']} on volume "
                f"{sh.get('volume', 0)} is {actual} bytes, COMMIT "
                f"recorded {sh['size']} — torn write")
    if "manifest_crc32" in marker:
        try:
            crc = manifest_crc32(directory)
        except OSError as e:
            raise TornCheckpointError(f"{directory}: manifest unreadable: "
                                      f"{e}") from e
        if crc != marker["manifest_crc32"]:
            raise TornCheckpointError(
                f"{directory}: manifest crc {crc:#x} != COMMIT "
                f"{marker['manifest_crc32']:#x}")
    return marker


def is_committed(directory: str, deep: bool = False,
                 legacy_ok: bool = False,
                 volume_roots: Optional[Sequence[str]] = None) -> bool:
    """True if ``directory`` holds a committed checkpoint. With
    ``legacy_ok``, a pre-engine directory (manifest.json but no COMMIT)
    also counts — those were published by the old non-atomic writers."""
    try:
        verify_commit(directory, deep=deep, volume_roots=volume_roots)
        return True
    except TornCheckpointError:
        pass
    if legacy_ok and not os.path.exists(os.path.join(directory, COMMIT_FILE)):
        return os.path.exists(os.path.join(directory, MANIFEST_FILE))
    return False


def committed_steps(root: str, deep: bool = False,
                    legacy_ok: bool = True) -> List[int]:
    """Sorted steps of committed checkpoints under ``root``. Staging
    dirs, torn dirs, and stray entries are ignored, never raised on."""
    steps = []
    try:
        names = os.listdir(root)
    except OSError:
        return []
    for name in names:
        step = parse_step(name)
        if step is None:
            continue
        d = os.path.join(root, name)
        if os.path.isdir(d) and is_committed(d, deep=deep,
                                             legacy_ok=legacy_ok):
            steps.append(step)
    return sorted(steps)


def fsync_payload(directory: str):
    """fsync every payload file plus the directory itself, so the data a
    COMMIT marker vouches for is durable BEFORE the marker is written
    (otherwise power loss could keep the marker but drop shard bytes)."""
    for name in os.listdir(directory):
        p = os.path.join(directory, name)
        if os.path.isfile(p):
            fd = os.open(p, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
    _fsync_path(directory)


def fsync_payloads(directories: Sequence[str]):
    """fsync the payload of several staging dirs with one flusher per
    FILE (os.fsync releases the GIL): the multi-volume analogue of the
    paper's per-node SSD flush, where every volume drains concurrently
    instead of serialising behind one thread."""
    from concurrent.futures import ThreadPoolExecutor
    files = []
    for d in directories:
        for name in os.listdir(d):
            p = os.path.join(d, name)
            if os.path.isfile(p):
                files.append(p)

    def _sync(p):
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    # directory fsyncs join the same pool: each one is a journal commit,
    # and serialising them behind the file syncs costs tens of ms/volume
    targets = files + list(directories)
    if len(targets) > 1:
        with ThreadPoolExecutor(min(len(targets), 16)) as ex:
            list(ex.map(_sync, targets))
    elif targets:
        _sync(targets[0])


def publish(staging: str, final: str, fsync: bool = True):
    """Atomically publish a sealed staging directory. The rename IS the
    commit point: before it readers see nothing, after it they see a
    complete checkpoint.

    Re-saving an existing step parks the old committed copy at a
    ``.trash`` name (ignored by readers, swept at engine start) before
    the rename — never an rmtree-then-rename window where a crash
    could lose BOTH copies of the step."""
    import shutil
    trash = None
    if os.path.exists(final):
        trash = final + ".trash"
        if os.path.exists(trash):
            shutil.rmtree(trash)
        os.replace(final, trash)
    os.replace(staging, final)
    if fsync:
        _fsync_path(os.path.dirname(final) or ".")
    if trash is not None:
        shutil.rmtree(trash, ignore_errors=True)


_DEBRIS_RE = re.compile(r"^ckpt_(\d+)\.(tmp|trash)$")


def stale_staging_dirs(root: str) -> List[str]:
    try:
        names = os.listdir(root)
    except OSError:
        return []
    return sorted(os.path.join(root, n) for n in names
                  if _DEBRIS_RE.match(n)
                  and os.path.isdir(os.path.join(root, n)))


def clean_stale_staging(root: str) -> List[str]:
    """Remove leftover ``.tmp``/``.trash`` dirs (a crashed writer's
    debris). Call only when no save can be in flight (engine startup).

    Exception: a ``.trash`` dir is a previously PUBLISHED checkpoint
    parked during a re-save. If the crash hit between publish()'s two
    renames, the step has no published copy left — recover the parked
    one (rename it back) instead of deleting the step outright."""
    import shutil
    removed = []
    for d in stale_staging_dirs(root):
        if d.endswith(".trash"):
            final = d[:-len(".trash")]
            if not os.path.exists(final) and is_committed(d, deep=True):
                os.replace(d, final)
                continue
        shutil.rmtree(d, ignore_errors=True)
        removed.append(d)
    return removed


def publish_fresh(staging: str, final: str, fsync: bool = True):
    """Publish a secondary volume's shard staging dir. The generation
    nonce guarantees ``final`` is a fresh name, so this is a plain
    atomic rename — no parking dance needed."""
    os.replace(staging, final)
    if fsync:
        _fsync_path(os.path.dirname(final) or ".")


def referenced_shard_dirs(primary_root: str,
                          volume_roots: Optional[Sequence[str]] = None
                          ) -> set:
    """Real paths of every secondary shard directory referenced by a
    committed checkpoint under ``primary_root``."""
    referenced = set()
    for step in committed_steps(primary_root, legacy_ok=True):
        d = os.path.join(primary_root, step_dir_name(step))
        marker = read_commit_marker(d)
        if marker is None:
            continue
        for v_str in (marker.get("volume_dirs") or {}):
            sd = resolve_shard_dir(marker, d, int(v_str), volume_roots)
            referenced.add(os.path.realpath(sd))
    return referenced


def clean_stale_multi(primary_root: str,
                      volume_roots: Sequence[str]) -> List[str]:
    """Multi-volume startup sweep. Call only when no save can be in
    flight (engine startup).

    1. Sweep the primary root's ``.tmp``/``.trash`` debris first —
       including the re-save recovery rename — so every recoverable
       COMMIT is back in place before reference counting.
    2. Compute the set of shard directories referenced by any committed
       step's COMMIT, then remove from every volume root all shard
       staging debris and every UNREFERENCED published shard-generation
       dir (orphans from a writer that died between per-volume publish
       and the global COMMIT, or old generations of a re-saved step).
       DELTA generations (layout v3) stage and publish through these
       same names, so a writer that crashed between a delta's
       per-volume publish and its COMMIT leaves orphans this sweep
       removes identically.

    Shard dirs referenced by a committed COMMIT are never touched, so a
    sweep can never strand a loadable step."""
    import shutil
    removed = list(clean_stale_staging(primary_root))
    referenced = referenced_shard_dirs(primary_root, volume_roots)
    seen_roots = set()
    for root in volume_roots:
        real_root = os.path.realpath(root)
        if real_root in seen_roots:
            continue
        seen_roots.add(real_root)
        try:
            names = os.listdir(root)
        except OSError:
            continue
        for name in sorted(names):
            full = os.path.join(root, name)
            if not os.path.isdir(full):
                continue
            if _SHARDS_DEBRIS_RE.match(name):
                shutil.rmtree(full, ignore_errors=True)
                removed.append(full)
            elif _SHARDS_RE.match(name) \
                    and os.path.realpath(full) not in referenced:
                shutil.rmtree(full, ignore_errors=True)
                removed.append(full)
    return removed


def commit_files(directory: str, marker: Optional[dict] = None,
                 volume_roots: Optional[Sequence[str]] = None,
                 digests: bool = False) -> List[dict]:
    """Enumerate every payload file a committed checkpoint references,
    across ALL volumes — the manifest-driven input to the upload tier
    (DESIGN.md §8) and to anything else that must walk a whole step.

    Args:
        directory: the committed (or sealed staging) checkpoint dir.
        marker: its parsed COMMIT marker; read from ``directory`` when
            omitted (raises :class:`TornCheckpointError` if absent).
        volume_roots: fallback roots for relocated volumes, as in
            :func:`resolve_shard_dir`.
        digests: guarantee a ``crc32`` on EVERY entry — files the
            marker recorded no CRC for (``manifest.json``, baseline
            payloads) get one computed from their bytes here. The
            content-addressed upload/replication keyspace (DESIGN.md
            §12) derives each object's digest from this CRC + size.

    Returns:
        ``[{"path", "name", "size", "volume", "crc32"?}, ...]`` —
        primary-resident payload files first (``manifest.json``
        included, ``COMMIT`` excluded), then shards striped onto other
        volumes. Shard entries carry the layout-v2 ``crc32`` when the
        writer recorded one; a shard resident in the primary directory
        is listed exactly once (with its CRC attached).
    """
    if marker is None:
        marker = verify_commit(directory, deep=False)
    crc_by_name = {sh["name"]: sh.get("crc32")
                   for sh in marker.get("shards", [])}
    out, seen = [], set()
    for name, size in sorted((marker.get("files") or {}).items()):
        entry = {"path": os.path.join(directory, name), "name": name,
                 "size": int(size), "volume": 0}
        if crc_by_name.get(name) is not None:
            entry["crc32"] = crc_by_name[name]
        out.append(entry)
        seen.add(name)
    for sh in marker.get("shards", []):
        if sh["name"] in seen:
            continue
        seen.add(sh["name"])
        d = resolve_shard_dir(marker, directory, int(sh.get("volume", 0)),
                              volume_roots)
        entry = {"path": os.path.join(d, sh["name"]), "name": sh["name"],
                 "size": int(sh["size"]), "volume": int(sh.get("volume", 0))}
        if sh.get("crc32") is not None:
            entry["crc32"] = sh["crc32"]
        out.append(entry)
    if digests:
        for entry in out:
            if "crc32" not in entry:
                entry["crc32"] = _path_crc32(entry["path"])
    return out


def _path_crc32(path: str, chunk: int = 1 << 20) -> int:
    """Streamed CRC32 of one file (digest source for payload files the
    writer recorded no CRC for)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(block, crc)


def delete_step(primary_root: str, step: int,
                volume_roots: Optional[Sequence[str]] = None) -> None:
    """Delete one checkpoint step across ALL volumes (GC path). The
    primary directory goes first — that atomically un-commits the step,
    so a crash mid-delete leaves only unreferenced shard dirs that the
    startup sweep removes; shards of a still-committed step are never
    deleted first (which would tear it)."""
    import shutil
    d = os.path.join(primary_root, step_dir_name(step))
    marker = read_commit_marker(d)
    shard_dirs = []
    if marker is not None:
        for v_str in (marker.get("volume_dirs") or {}):
            shard_dirs.append(
                resolve_shard_dir(marker, d, int(v_str), volume_roots))
    shutil.rmtree(d, ignore_errors=True)
    for sd in shard_dirs:
        if os.path.realpath(sd) != os.path.realpath(d):
            shutil.rmtree(sd, ignore_errors=True)
