"""Model FLOPs of the prompt tokens prefilled and the tokens decoded in
the window, over the window's seconds and the chip's bf16 peak, in %."""
from bench import cost


def read(run):
    if "prefills" not in run or not run.get("window_s"):
        return None
    s = run["spec"]
    flops = sum(cost.prefill_flops(s, n, plen) for n, plen in run["prefills"])
    flops += cost.decode_flops(s, run["occupied_slot_steps"])
    if not flops:
        return None
    return 100.0 * flops / (run["window_s"] * cost.PEAK_FLOPS_BF16)
