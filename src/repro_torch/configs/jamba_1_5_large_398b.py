"""Jamba 1.5 Large 398B — Mamba+attn 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576,
                  layout="alternate"),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256),
    attn_period=8,          # 1 attention layer per 8 (1:7 mamba:attn)
    subquadratic=True,      # hybrid: attn layers use seq-sharded decode
    source="arXiv:2403.19887; hf",
)
