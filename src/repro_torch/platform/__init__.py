"""Copies of the ``repro.platform`` modules the learner body, the
execution backends and the endpoints need: journal, ZooKeeper, watchdog,
storage, metrics, cluster (scheduler), queue (fair share) and lcm."""
