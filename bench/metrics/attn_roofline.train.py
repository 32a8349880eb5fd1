"""K4 (with its LSE) and K4b in the traced sub-window: the least time
their calls need at the learner's shape, over their device time, in %."""
from bench import cost
from bench.trace import kernel_seconds


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    s, mix = run["spec"], run["mix"]
    t_f, n_f = kernel_seconds(tr, r"flash_fwd")
    t_b, _ = kernel_seconds(tr, r"flash_bwd")
    _, n_b = kernel_seconds(tr, r"flash_bwd_dq")
    if not n_f or not (t_f + t_b):
        return None
    B, S = mix["batch_docs"], mix["seq_len"]
    least = (cost.flash_fwd(B, S, s.heads, s.kv, s.hd, lse=True).seconds()
             * n_f + cost.flash_bwd(B, S, s.heads, s.kv, s.hd).seconds()
             * n_b)
    return 100.0 * least / (t_f + t_b)
