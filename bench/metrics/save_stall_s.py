"""Seconds the training loop spent blocked per save of the window: in
``save()``, in ``wait_snapshot()`` and in the final ``drain()``."""


def read(rec):
    return rec.get("stall_per_save_s")
