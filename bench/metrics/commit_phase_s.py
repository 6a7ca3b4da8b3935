"""Mean of the window's saves' commit phase (``SaveStats.commit_seconds``:
the payloads' fsync, the COMMIT marker and the atomic publish)."""


def read(rec):
    saves = rec.get("saves") or []
    if not saves:
        return None
    return sum(s["commit_seconds"] for s in saves) / len(saves)
