"""The engine's decode seconds over its decode steps in the window, in ms
(host time around each step, ending in the copy of its tokens)."""


def read(run):
    if not run.get("decode_steps"):
        return None
    return 1e3 * run["decode_seconds"] / run["decode_steps"]
