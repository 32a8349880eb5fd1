"""Roofline estimates of the port's programs on H100 constants
(``roofline``) and the per-job ``status.perf`` service (``perf``)."""
