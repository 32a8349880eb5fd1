"""The engine's prefill seconds in the window over the prompt tokens it
prefilled, per 1,000 tokens, in ms."""


def read(run):
    toks = sum(n * plen for n, plen in run.get("prefills", ()))
    if not toks:
        return None
    return 1e3 * run["prefill_seconds"] / toks * 1e3
