"""Whisper large-v3 — enc-dec, conv frontend stubbed. [arXiv:2212.04356]

The assignment specifies the transformer BACKBONE only; the conv frontend is
a STUB — ``input_specs()`` provides precomputed (B, S_enc, d_model) frame
embeddings. Shapes are interpreted as enc_len = dec_len = seq_len // 2 for
train/prefill; decode steps the decoder against self+cross caches.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-large-v3",
    family="encdec",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    encdec=True,
    frontend="audio",
    source="arXiv:2212.04356; unverified",
)
