"""The learner body's ``sync_time_s`` (push and pull, the BSP wait
included), mean over the window's steps, in ms."""


def read(run):
    xs = run.get("sync_s")
    if not xs:
        return None
    return 1e3 * sum(xs) / len(xs)
