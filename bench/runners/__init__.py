"""One runner a kind of cell, found by the name a mix file gives under
``"runner"``. A runner's ``run(ctx)`` builds the program's entry from
the configuration, warms it, measures the window, checks what the
window produced against the reference and returns a ``Run``."""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Ctx:
    seed: int
    seconds: float
    trace: bool
    workload: dict
    config: dict
    mix: dict
    limits: dict = field(default_factory=dict)
    device: str = "cuda"
    t_start: float = field(default_factory=time.time)
    # calibration: also read the control's and the faults' numbers
    control: bool = False


@dataclass
class Run:
    """What a runner hands back: its end-to-end numbers, the record the
    per-layer readers read, and the comparison that decides ``correct``
    (name -> (number, limit))."""
    end_to_end: Dict[str, float]
    record: dict
    checks: Dict[str, tuple]
    attempted: int
    failed: int
    memory_peak_bytes: int
    notes: List[str] = field(default_factory=list)
    extra: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(v == v and v <= lim for v, lim in self.checks.values())


def port_config(cj: dict):
    """The port's ``ArchConfig`` of a configuration file: the registry's
    entry with every size the file states."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.configs.registry import get_arch
    base = get_arch(cj["registry_id"])
    kw = dict(n_layers=cj["num_hidden_layers"], d_model=cj["hidden_size"],
              n_heads=cj["num_attention_heads"],
              n_kv_heads=cj["num_key_value_heads"], head_dim=cj["head_dim"],
              d_ff=cj["intermediate_size"], vocab_size=cj["vocab_size"],
              rope_theta=cj["rope_theta"], norm_eps=cj["norm_eps"],
              dtype=cj["torch_dtype"])
    if cj["family"] == "moe":
        kw["moe"] = MoEConfig(n_experts=cj["num_experts"],
                              top_k=cj["num_experts_per_tok"],
                              d_ff_expert=cj["intermediate_size"],
                              capacity_factor=cj["capacity_factor"],
                              layout="all")
    cfg = dataclasses.replace(base, **kw)
    if cfg.family != cj["family"] or cfg.qkv_bias or cfg.mrope:
        raise ValueError(f"{cj['registry_id']}: the port's block is not "
                         f"the one the configuration file states")
    return cfg


def sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   keep=None) -> tuple:
    """(gap, leaf): the largest |got - want| over the leaves, each against
    the reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    return worst_leaf_ratio({n: abs(got[n] - want[n]) for n in want},
                            want, keep)


def worst_leaf_ratio(num: Dict[str, float], want: Dict[str, float],
                     keep=None) -> tuple:
    """(ratio, leaf): the largest ``num`` over the leaves, each against the
    reference's norm ``want`` of that leaf or of the median leaf,
    whichever is larger."""
    names = [n for n in want if keep is None or n in keep]
    med = sorted(want[n] for n in names)[len(names) // 2]
    best = (0.0, None)
    for n in names:
        g = num[n] / max(want[n], med)
        if not g <= best[0]:
            best = (g, n)
    return best


CARD_FIELDS = ("clocks.sm", "clocks.max.sm", "clocks.mem", "power.draw",
               "power.limit", "temperature.gpu")


def card_sample(device) -> Optional[Dict[str, float]]:
    """The card's clocks (MHz), power (W) and temperature (C) as
    ``nvidia-smi`` reads them now, so that a card running slower shows
    beside the window's numbers; None off the card or where the tool
    cannot read them."""
    import os
    import subprocess
    if not str(device).startswith("cuda"):
        return None
    idx = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0] or "0"
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(CARD_FIELDS)}",
             "--format=csv,noheader,nounits", "-i", idx],
            capture_output=True, text=True, timeout=20)
        vals = [float(v) for v in res.stdout.strip().split(",")]
    except (OSError, subprocess.SubprocessError, ValueError):
        return None
    if res.returncode != 0 or len(vals) != len(CARD_FIELDS):
        return None
    return dict(zip(CARD_FIELDS, vals))


class Clock:
    """Host times of events, shared between threads."""

    def __init__(self):
        self.cond = threading.Condition()
        self.events: List[tuple] = []

    def add(self, *ev):
        with self.cond:
            self.events.append((time.perf_counter(),) + ev)
            self.cond.notify_all()

    def wait_for(self, pred, timeout: float):
        with self.cond:
            if not self.cond.wait_for(lambda: pred(self.events), timeout):
                raise TimeoutError("the program did not get there in "
                                   f"{timeout} s")
