"""PyTorch/CUDA port of the DLaaS reproduction (NVIDIA H100).

Sits beside the JAX package ``repro``, which stays the reference. This
package imports ``torch``, numpy and the standard library only: never
``jax`` and nothing of ``repro``.

Layout (first slice: serving):
  * ``device``      — ``resolve_device``: CUDA unless the caller asks for CPU.
  * ``configs``     — architecture configs (copy of ``repro.configs``).
  * ``models``      — dense decoder: layers, attention, transformer, facade.
  * ``kernels``     — hand-written CUDA kernels, their build, wrappers and
    plain PyTorch versions.
  * ``weights``     — the flat f32 weight vector shared with ``repro``.
  * ``serving``     — the continuous-batching ``InferenceEngine``.
"""
