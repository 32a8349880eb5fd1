"""Optimizers of the model-level train step and of a flat PS shard
(``optimizers``)."""
