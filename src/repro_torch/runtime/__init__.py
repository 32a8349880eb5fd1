"""Learner runtime: framework plugins and the learner body."""
