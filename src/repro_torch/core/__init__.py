"""The software parameter server, its int8 wire and the global cursor."""
