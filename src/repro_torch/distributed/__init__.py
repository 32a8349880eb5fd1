"""Step builders of the model-level path (``steps``): train, prefill and
decode on one card. The mesh and its shardings are not ported yet."""
