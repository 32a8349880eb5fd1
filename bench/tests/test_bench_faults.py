"""A whole run of each cell, on the CPU at tiny width, with the look for a
chip skipped: sound, it is correct; with the timed path broken
underneath, ``correct`` comes out false, once for each fault the cell
can have (one card: no exchange between chips to leave out)."""
import pytest
import torch

from bench.common import benchmark_spec
from bench.runners import Ctx
from bench.run import execute
from bench.tests import tiny

SEED = 2 ** 31 + 7
# limits at this width: above what sound tiny runs read on the CPU (loss
# 1.7-2.4e-4, gradient 1.0-1.6e-3, its difference 1.4-1.6e-2, change
# 1.8-2.8e-3, tokens off the best 0-2%), under what the controls read
# (the difference 0.11-0.12); the cells' own limits are set at their own
# width on the card (bench/limits/)
TINY_LIMITS = {"loss_rel_gap": 1e-3, "grad1_norm_gap": 0.02,
               "grad1_diff": 0.05, "change_norm_gap": 0.02,
               "off_best_pct": 5.0}


def run_cell(workload, config, mix):
    spec = benchmark_spec()
    w = next(w for w in spec["workloads"] if w["name"] == workload)
    ctx = Ctx(seed=SEED, seconds=1.5, trace=False, workload=w,
              config=config, mix=mix, limits=TINY_LIMITS, device="cpu")
    out, _ = execute(ctx, spec, 1)
    return out


def train():
    return run_cell("train-stablelm-ps-4k",
                    tiny.config("stablelm-2-1.6b-L12"), tiny.train_mix())


def serve():
    return run_cell("serve-grok-chat", tiny.config("grok-1-L4"),
                    tiny.serve_mix())


def no_update(monkeypatch):
    """The PS round returns its state unchanged."""
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "ps_aggregate", lambda *a, **k: None)


def half_batch(monkeypatch):
    """The loss, and so the gradient, over half of the batch's tokens."""
    from repro_torch.models import transformer
    real = transformer.chunked_xent

    def half(h, w_head, labels, chunk=512):
        n = h.shape[1] // 2
        return real(h[:, :n], w_head, labels[:, :n], min(chunk, n))
    monkeypatch.setattr(transformer, "chunked_xent", half)


def altered_token(monkeypatch):
    """Every fifth step's tokens are not the logits' best."""
    from repro_torch.models import transformer
    real = transformer.last_token_logits
    calls = [0]

    def altered(h, w):
        out = real(h, w)
        calls[0] += 1
        if calls[0] % 5 == 0:
            best = out[:, -1].argmax(-1)
            out[torch.arange(out.shape[0]), -1,
                (best + 1) % out.shape[-1]] += 1e4
        return out
    monkeypatch.setattr(transformer, "last_token_logits", altered)


def stale_cache(monkeypatch):
    """A decode step leaves the slot cache as it was."""
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "cache_update",
                        lambda cache, new, pos: cache)


@pytest.mark.parametrize("cell", [train, serve])
def test_sound_run_is_correct(cell):
    out = cell()
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", [(train, no_update),
                                        (train, half_batch),
                                        (serve, altered_token),
                                        (serve, stale_cache)])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = cell()
    assert not out["correct"], out["checks"]
