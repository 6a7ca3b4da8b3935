"""Bytes of the window's saves over their persist time
(``SaveStats.total_bytes`` / ``seconds``), in GB/s."""


def read(rec):
    saves = rec.get("saves") or []
    t = sum(s["seconds"] for s in saves)
    if not t:
        return None
    return sum(s["total_bytes"] for s in saves) / t / 1e9
