"""Copies of the ``repro.platform`` modules the learner body needs:
journal, ZooKeeper, watchdog, storage and metrics."""
