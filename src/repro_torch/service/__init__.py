"""Service layer of the port: the manifest parser and resolvers
(``manifest``, a copy), ``DLaaSCore`` (``core``), the REST server
(``rest``: ``DLaaSServer``) and the CLI (``cli``, a copy)."""
from repro_torch.service.core import DLaaSCore, default_cluster
from repro_torch.service.rest import DLaaSServer

__all__ = ["DLaaSCore", "DLaaSServer", "default_cluster"]
