"""Checkpoints in the on-disk layout of ``repro.checkpoint``."""
