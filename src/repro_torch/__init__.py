"""PyTorch/CUDA port of the DLaaS reproduction (NVIDIA H100).

Sits beside the JAX package ``repro``, which stays the reference. This
package imports ``torch``, numpy and the standard library only: never
``jax`` and nothing of ``repro``.

Layout:
  * ``device``        — ``resolve_device``: CUDA unless the caller asks for
    the CPU; ``errors`` — ``UserError``, ``Preempted``.
  * ``configs``       — architecture configs (copy of ``repro.configs``).
  * ``models``        — dense decoder and the ssm family (Mamba-2): layers,
    attention, transformer, ``Model.loss``, facade.
  * ``kernels``       — hand-written CUDA kernels (K1-K5, K4b), their
    build, wrappers and plain PyTorch versions.
  * ``weights``       — the flat f32 weight vector shared with ``repro``.
  * ``core``          — the device-resident software parameter server,
    the int8 wire, the global data cursor; ``data`` — the synthetic
    corpus; ``checkpoint`` — ``repro``'s on-disk layout.
  * ``platform``      — copies of ``repro.platform``: journal, ZooKeeper,
    watchdog, storage, metrics, the cluster and scheduler, the fair-share
    queue, the Lifecycle Manager, the health controller, the autoscaler,
    fault injection.
  * ``observability`` — copies of ``stream``, ``trace``, ``log`` (the
    ``"repro_torch"`` logger tree), ``slo`` and ``export``;
    ``analysis`` — ``roofline`` (a program's FLOPs and bytes counted on
    the meta device against H100 constants, ``kernel_cost``,
    ``model_flops``) and ``perf`` (``JobPerf``: ``status.perf``).
  * ``service``       — the manifest parser and the CLI (copies),
    ``DLaaSCore`` (``core``) and the REST server (``rest``), the entry
    point: ``python -m repro_torch.service.rest <workdir> [port]
    [device]``.
  * ``runtime``       — framework plugins and the learner body
    (``learner``), the execution backends (``backend``: ``software-ps``;
    ``pjit`` raises, not ported).
  * ``serving``       — the continuous-batching ``InferenceEngine`` and
    managed endpoints (``endpoint``: ``ServingBackend``,
    ``ModelEndpoint``).
"""
