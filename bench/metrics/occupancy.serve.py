"""Occupied slot-steps over decode steps times the slots, in the window,
in %."""


def read(run):
    if not run.get("decode_steps"):
        return None
    return 100.0 * run["occupied_slot_steps"] / (run["decode_steps"]
                                                 * run["capacity"])
