"""K1 (Adam over each shard), K2 (int8 push with error feedback) and K3
(its receive) in the traced sub-window: the least time of their bytes,
over their device time, in %."""
from bench import cost
from bench.trace import kernel_seconds


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    mix, n = run["mix"], run["ps_padded"]
    t1, n1 = kernel_seconds(tr, r"ps_aggregate")
    t2, n2 = kernel_seconds(tr, r"quantize_ef")
    t3, n3 = kernel_seconds(tr, r"dequantize")
    if not (n1 and n2 and n3):
        return None
    least = (cost.ps_aggregate(mix["learners"], n // mix["shards"]).seconds()
             * n1 + cost.quantize_ef(n, run["grad_esize"]).seconds() * n2
             + cost.dequantize(n).seconds() * n3)
    return 100.0 * least / (t1 + t2 + t3)
