"""Mean of the window's saves' payload fsync (``SaveStats.fsync_seconds``,
the program's ``commit.fsync`` span), the first part of
``commit_phase_s``; None where the program does not time it apart."""


def read(rec):
    saves = rec.get("saves") or []
    if not saves or any("fsync_seconds" not in s for s in saves):
        return None
    return sum(s["fsync_seconds"] for s in saves) / len(saves)
