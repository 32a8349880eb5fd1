"""Distribution: the sharding policy and specs (``sharding``) and the
step builders (``steps``): train, prefill and decode on one card or
sharded over a ``torch.distributed`` mesh."""
