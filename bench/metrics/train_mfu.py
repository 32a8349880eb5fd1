"""Model FLOPs of the window's tokens (6 N + causal attention, forward and
backward) over the window's seconds and the chip's bf16 peak, in %."""
from bench import cost


def read(run):
    if run.get("tokens") is None or not run.get("window_s"):
        return None
    flops = cost.train_flops_per_token(run["spec"], run["mix"]["seq_len"]) \
        * run["tokens"]
    return 100.0 * flops / (run["window_s"] * cost.PEAK_FLOPS_BF16)
