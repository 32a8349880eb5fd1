"""Grok-1 314B — 8 experts top-2. [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768),
    source="hf:xai-org/grok-1; unverified",
)
