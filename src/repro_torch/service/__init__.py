"""Service layer of the port: the manifest parser and resolvers
(``manifest``, a copy)."""
