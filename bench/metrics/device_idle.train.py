"""1 - the union of device intervals over the traced sub-window, in %."""


def read(run):
    tr = run.get("trace")
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
