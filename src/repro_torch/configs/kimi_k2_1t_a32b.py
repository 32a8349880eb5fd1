"""Kimi K2 — trillion-param MoE. [arXiv:2501.kimi2; unverified]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048),
    source="arXiv:2501.kimi2; unverified",
)
