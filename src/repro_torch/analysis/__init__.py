"""Per-job performance estimates (``perf``: the ``JobPerf`` stand-in)."""
