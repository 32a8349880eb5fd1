"""Hand-written Hopper kernels of the port (``csrc/``), their build
(``build.py``), wrappers, plain PyTorch versions (``ref.py``) and the
device-dispatching entry points (``ops.py``)."""
