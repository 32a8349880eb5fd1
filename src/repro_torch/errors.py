"""Errors the port raises for bad user input.

``UserError`` is the counterpart of ``repro.platform.cluster.UserError``:
an error in what the user asked for (a malformed request, an arch the
port cannot run yet), not an infrastructure failure, so callers report it
and do not retry.
"""


class UserError(Exception):
    """Raised for errors in user input (no retry)."""
