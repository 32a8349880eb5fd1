"""The moe block's three batched products in the sub-window traced with
every host op: for
each ``aten::bmm`` call, the least time of its routed tokens' products
and of its weights and buffer bytes (the router's product just before it
on the same thread gives the tokens), over the device time of the
kernels it launched, in %."""
from bench import cost


def read(run):
    tr = run.get("trace_ops")
    if not tr:
        return None
    s = run["spec"]
    tokens = {}             # thread -> tokens the last router call saw
    least = 0.0
    for op in sorted(tr["ops"], key=lambda o: o["start"]):
        dims = op.get("dims") or []
        if op["name"] == "aten::mm" and len(dims) == 2 and len(dims[1]) == 2 \
                and dims[1] == [s.d, s.experts]:
            tokens[op["tid"]] = dims[0][0]
        elif op["name"] == "aten::bmm" and len(dims) == 2 \
                and len(dims[0]) == 3 and dims[0][0] == s.experts \
                and op["tid"] in tokens:
            (E, C, K), (_, _, N) = dims[0], dims[1]
            least += cost.expert_bmm(E, C, K, N, tokens[op["tid"]]
                                     * s.top_k).seconds()
    t = sum(d["dur"] for d in tr["device"] if d["op"] == "aten::bmm")
    if not t or not least:
        return None
    return 100.0 * least / t
