"""Runtimes: the learner (framework plugins and the learner body), the
pjit trainer, and the execution backends."""
