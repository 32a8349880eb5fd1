"""Synthetic corpus and cursor-driven loader (copy of ``repro.data``)."""
