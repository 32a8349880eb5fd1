from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, MoEConfig, SSMConfig, ShapeSpec,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, ALL_SHAPES, SHAPES_BY_NAME,
    shapes_for, skip_reason, reduce_for_smoke,
    SMOKE_TRAIN, SMOKE_PREFILL, SMOKE_DECODE,
)
