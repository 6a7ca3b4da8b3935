"""Share of the traced stretch of training (from the first save of the
window, ``trace_steps`` steps) with no kernel or copy on the device."""


def read(rec):
    tr = rec.get("trace")
    if "window_steps" not in rec or not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
