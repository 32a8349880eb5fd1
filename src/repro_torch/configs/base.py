"""Config system: architecture configs, input-shape specs, smoke reduction.

The port's own copy of ``repro/configs/base.py``: ``repro_torch`` imports
nothing of ``repro``, so the configs are duplicated rather than shared.
Keep the two in step when an architecture changes.

Every assigned architecture is a frozen ``ArchConfig``; the four assigned
input shapes are ``ShapeSpec``s. ``reduce_for_smoke`` derives a tiny
same-family config for CPU smoke tests; the full configs are only ever
lowered via the dry-run (ShapeDtypeStruct, no allocation).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # Which FFN sites are MoE. 'all' = every layer, 'alternate' = every other.
    layout: str = "all"


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64          # mamba2 "P"
    expand: int = 2             # d_inner = expand * d_model
    chunk_size: int = 256       # SSD chunk length
    n_groups: int = 1           # B/C groups
    conv_kernel: int = 4        # depthwise conv width (decode keeps a tail)


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False         # qwen2-vl M-RoPE (t/h/w sections)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: one attention layer every `attn_period` layers (rest mamba).
    attn_period: int = 0
    # enc-dec (whisper): encoder layers == n_layers, decoder layers too.
    encdec: bool = False
    # modality frontend stub: none | audio | vision. Stub frontends mean
    # input_specs() provides precomputed (B, S, d_model) embeddings.
    frontend: str = "none"
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # Sub-quadratic attention available? Pure full-attention archs skip
    # long_500k per the assignment.
    subquadratic: bool = False
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def n_params(self) -> int:
        """Total parameter count (embedding + blocks + head)."""
        return _count_params(self, active_only=False)

    def n_active_params(self) -> int:
        """Active-per-token parameters (MoE: top_k experts only)."""
        return _count_params(self, active_only=True)


def _attn_params(c: ArchConfig) -> int:
    hd = c.hd
    q = c.d_model * c.n_heads * hd
    kv = 2 * c.d_model * c.n_kv_heads * hd
    o = c.n_heads * hd * c.d_model
    b = (c.n_heads + 2 * c.n_kv_heads) * hd if c.qkv_bias else 0
    return q + kv + o + b


def _ffn_params(c: ArchConfig, moe_site: bool, active_only: bool) -> int:
    if moe_site and c.moe is not None:
        e = c.moe.top_k if active_only else c.moe.n_experts
        router = c.d_model * c.moe.n_experts
        return e * 3 * c.d_model * c.moe.d_ff_expert + router
    return 3 * c.d_model * c.d_ff  # gated MLP (w_gate, w_up, w_down)


def _mamba_params(c: ArchConfig) -> int:
    s = c.ssm
    assert s is not None
    d_in = s.expand * c.d_model
    nheads = d_in // s.head_dim
    # in_proj covers [z, x, B, C, dt]
    in_proj = c.d_model * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)
    out_proj = d_in * c.d_model
    conv = s.conv_kernel * (d_in + 2 * s.n_groups * s.d_state)
    extra = 3 * nheads  # A_log, dt_bias, D
    return in_proj + out_proj + conv + extra


def _count_params(c: ArchConfig, active_only: bool) -> int:
    emb = c.vocab_size * c.d_model
    head = c.vocab_size * c.d_model  # untied output head
    total = emb + head
    n_layers = c.n_layers
    if c.encdec:
        # encoder + decoder stacks, decoder has extra cross-attention.
        enc = n_layers * (_attn_params(c) + _ffn_params(c, False, active_only)
                          + 2 * c.d_model)
        dec = n_layers * (2 * _attn_params(c)
                          + _ffn_params(c, False, active_only)
                          + 3 * c.d_model)
        return total + enc + dec
    for i in range(n_layers):
        if c.family == "ssm":
            total += _mamba_params(c) + 2 * c.d_model
            continue
        if c.family == "hybrid" and c.attn_period and (i % c.attn_period != 0):
            mixer = _mamba_params(c)
        else:
            mixer = _attn_params(c)
        moe_site = c.moe is not None and (
            c.moe.layout == "all" or (c.moe.layout == "alternate" and i % 2 == 1))
        total += mixer + _ffn_params(c, moe_site, active_only) + 2 * c.d_model
    return total


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shapes_for(cfg: ArchConfig) -> Tuple[ShapeSpec, ...]:
    """Applicable shapes: long_500k only for sub-quadratic archs."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        out.append(LONG_500K)
    return tuple(out)


def skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return "full quadratic attention; 500k decode requires sub-quadratic"
    return None


# ---------------------------------------------------------------------------
# Smoke reduction
# ---------------------------------------------------------------------------


def reduce_for_smoke(c: ArchConfig) -> ArchConfig:
    """Tiny same-family config for one CPU forward/train step."""
    kw = {}
    period = c.attn_period or 0
    n_layers = max(2, period) if period else 2
    moe = None
    if c.moe is not None:
        moe = MoEConfig(n_experts=4, top_k=min(2, c.moe.top_k),
                        d_ff_expert=64, capacity_factor=c.moe.capacity_factor,
                        layout=c.moe.layout)
    ssm = None
    if c.ssm is not None:
        ssm = SSMConfig(d_state=16, head_dim=16, expand=2, chunk_size=32,
                        n_groups=1, conv_kernel=c.ssm.conv_kernel)
    return dataclasses.replace(
        c,
        arch_id=c.arch_id + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(c.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        moe=moe,
        ssm=ssm,
        mrope_sections=(2, 3, 3),   # half of head_dim 16
        dtype="float32",
        **kw,
    )


SMOKE_TRAIN = ShapeSpec("smoke_train", 64, 4, "train")
SMOKE_PREFILL = ShapeSpec("smoke_prefill", 64, 2, "prefill")
SMOKE_DECODE = ShapeSpec("smoke_decode", 64, 2, "decode")
