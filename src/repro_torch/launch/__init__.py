"""Mesh construction (``mesh``): the counterpart of ``repro.launch``."""
