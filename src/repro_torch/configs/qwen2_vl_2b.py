"""Qwen2-VL 2B — M-RoPE, dynamic resolution (vision frontend stubbed).
[arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),   # t/h/w sections of head_dim 128
    frontend="vision",
    source="arXiv:2409.12191; hf",
)
