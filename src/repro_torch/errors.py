"""Errors shared by the port's layers.

``UserError`` and ``Preempted`` are the counterparts of
``repro.platform.cluster.UserError`` and ``Preempted``
(``repro/platform/cluster.py:734-744``):

  * ``UserError`` — an error in what the user asked for (a malformed
    request, an arch the port cannot run yet), not an infrastructure
    failure, so callers report it and do not retry;
  * ``Preempted`` — raised inside a task body when the scheduler asked
    the task to yield; it resumes from its last checkpoint.
"""


class UserError(Exception):
    """Raised for errors in user input (no retry)."""


class Preempted(Exception):
    """Raised inside a task body when the scheduler preempted the task;
    the task is already back in the queue and resumes from checkpoint."""
