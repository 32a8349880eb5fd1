"""Tiny configurations and mixes for the CPU tests: the same files'
shapes at small widths, run through the same runners."""
from __future__ import annotations

import copy

from bench.common import BENCH, load_json


def config(name: str, dtype: str = "bfloat16") -> dict:
    c = load_json(BENCH / "configs" / f"{name}.json")
    small = {"hidden_size": 64, "intermediate_size": 96,
             "num_attention_heads": 4, "head_dim": 16, "num_hidden_layers": 2,
             "vocab_size": 256, "torch_dtype": dtype}
    small["num_key_value_heads"] = 4 if c["num_key_value_heads"] == \
        c["num_attention_heads"] else 2
    if c["family"] == "moe":
        small["num_experts"] = 4
    c.update(small)
    return c


def train_mix() -> dict:
    m = copy.deepcopy(load_json(BENCH / "mixes" / "ps-4k.json"))
    m.update(seq_len=64, trace_steps=1, lr=1e-3)
    return m


def serve_mix() -> dict:
    m = copy.deepcopy(load_json(BENCH / "mixes" / "chat.json"))
    m.update(rate_per_s=20.0, capacity=4, max_seq=96, lead_s=0.2,
             drain_s=20.0, trace_s=0.3, trace_ops_s=0.3,
             check_requests=3)
    m["prompt"].update(median=24, min=4, max=64)
    m["output"].update(median=6, min=2, max=32)
    return m
