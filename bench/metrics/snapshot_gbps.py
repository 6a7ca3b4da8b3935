"""Device-to-host bytes of the window's saves over their snapshot time
(``SaveStats.d2h_bytes`` / ``snapshot_seconds``), in GB/s."""


def read(rec):
    saves = rec.get("saves") or []
    t = sum(s["snapshot_seconds"] for s in saves)
    if not t:
        return None
    return sum(s["d2h_bytes"] for s in saves) / t / 1e9
