"""The port's serving engine on the CPU: the cases of
tests/test_serving.py (continuous batching, eos, admission queue,
deadlines, validation, release) against ``repro_torch``'s engine, token
identity with the JAX engine from the same flat weights, and no silent
CPU fallback."""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.configs.registry import get_arch as jax_get_arch
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.configs.base import reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.errors import UserError
from repro_torch.serving.engine import (EndpointClosed, InferenceEngine,
                                        QueueFull)
from repro_torch.weights import flat_from_params
from util_poll import wait_until

ARCH = "stablelm-1.6b"
MAX_SEQ = 32


@pytest.fixture(scope="module")
def cfg():
    return reduce_for_smoke(get_arch(ARCH))


def _engine(cfg, **kw):
    kw.setdefault("max_seq", MAX_SEQ)
    return InferenceEngine(cfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def engine(cfg):
    eng = _engine(cfg, capacity=2, max_queue=16, default_max_new=6,
                  endpoint_id="ep-test")
    eng.start(None)
    return eng


def _serve(eng, reqs, timeout=120.0):
    t = threading.Thread(target=eng.run, daemon=True)
    t.start()
    for r in reqs:
        assert r.wait(timeout), f"request {r.req_id} stuck: {r.status}"
    eng.drain()
    t.join(20)
    assert not t.is_alive()
    return reqs


def _sequential_reference(model, params, prompt, max_new):
    """Greedy B=1 decode with the plain model functions, one request
    alone in a one-slot cache: the oracle a mid-flight join must match."""
    cache = model.empty_cache(1, MAX_SEQ, "cpu")
    with torch.no_grad():
        logits, _ = model.prefill(
            params, {"tokens": torch.from_numpy(prompt[None]).long()},
            cache=cache, slots=torch.tensor([0]))
        toks = [int(logits[0, -1].argmax())]
        while len(toks) < max_new:
            logits, cache = model.decode(
                params, cache, {"tokens": torch.tensor([[toks[-1]]])})
            toks.append(int(logits[0, -1].argmax()))
    return toks


MIDFLIGHT_MAX_NEW = [3, 6, 4, 5, 7]          # staggered retirement → joins


def _midflight_prompts(cfg):
    rng = np.random.RandomState(0)
    return [rng.randint(0, cfg.vocab_size, size=8).astype(np.int32)
            for _ in range(5)]


def test_midflight_join_token_identical(cfg, engine):
    """5 requests over 2 slots: 3 join mid-flight into freed slots; each
    output is token-identical to decoding that request alone."""
    prompts = _midflight_prompts(cfg)
    reqs = [engine.submit(p, max_new=m)
            for p, m in zip(prompts, MIDFLIGHT_MAX_NEW)]
    _serve(engine, reqs)
    stats = engine.stats()
    assert stats["mean_batch_occupancy"] > 0.5
    assert engine.prefill_batches >= 3            # joins did happen
    for p, m, r in zip(prompts, MIDFLIGHT_MAX_NEW, reqs):
        assert r.status == "DONE"
        assert len(r.tokens) == m
        assert r.tokens == _sequential_reference(engine.model,
                                                 engine.params, p, m)


@pytest.mark.parametrize("arch", [ARCH, "grok-1-314b"])
def test_midflight_join_matches_jax_engine(arch):
    """The port's engine and the JAX engine, started from the same flat
    vector, give the same greedy tokens for the mid-flight-join case
    (grok-1: the moe family, prefill capacity over each batch, per-slot
    decode capacity)."""
    cfg = reduce_for_smoke(get_arch(arch))
    ref = _engine(cfg, capacity=2, endpoint_id="ep-flat")
    ref.start(None)
    flat = flat_from_params(ref.params)
    ref.release()
    prompts = _midflight_prompts(cfg)

    def serve(eng):
        eng.start(flat)
        reqs = [eng.submit(p, max_new=m)
                for p, m in zip(prompts, MIDFLIGHT_MAX_NEW)]
        return [r.tokens for r in _serve(eng, reqs)]

    jax_eng = JaxEngine(jax_reduce(jax_get_arch(arch)), capacity=2,
                        max_seq=MAX_SEQ, endpoint_id="ep-jax")
    port = serve(_engine(cfg, capacity=2, endpoint_id="ep-port"))
    assert port == serve(jax_eng)
    jax_eng.release()


def test_eos_retires_early(cfg):
    eng = _engine(cfg, capacity=1, default_max_new=8, endpoint_id="ep-eos")
    eng.start(None)
    prompt = np.random.RandomState(3).randint(
        0, cfg.vocab_size, size=6).astype(np.int32)
    free_run = eng.submit(prompt, max_new=8)
    _serve(eng, [free_run])
    eos = free_run.tokens[1]
    eng2 = _engine(cfg, capacity=1, default_max_new=8, eos_id=eos,
                   endpoint_id="ep-eos2")
    eng2.start(None)
    r = eng2.submit(prompt, max_new=8)
    _serve(eng2, [r])
    assert r.tokens == free_run.tokens[:2]


def test_admission_queue_overflow(cfg):
    eng = _engine(cfg, capacity=1, max_queue=2, default_max_new=2,
                  endpoint_id="ep-q")
    p = np.arange(4, dtype=np.int32) + 1
    eng.submit(p)
    eng.submit(p)
    with pytest.raises(QueueFull):
        eng.submit(p)
    st = eng.stats()
    assert st["rejected_total"] == 1
    assert st["queue_depth"] == 2
    assert st["requests_total"] == 3
    eng.shed(0.5)                                  # limit 1: still full
    assert eng.stats()["shed_limit"] == 1
    eng.unshed()
    assert eng.stats()["shed_limit"] is None


def test_deadline_expires_queued_request(cfg):
    eng = _engine(cfg, capacity=1, default_max_new=2, endpoint_id="ep-dl")
    p = np.arange(4, dtype=np.int32) + 1
    req = eng.submit(p, deadline_s=0.01)
    assert wait_until(lambda: time.time() > req.deadline, timeout=5)
    eng.start(None)
    t = threading.Thread(target=eng.run, daemon=True)
    t.start()
    assert req.wait(30)
    assert req.status == "EXPIRED"
    assert eng.stats()["expired_total"] == 1
    eng.drain()
    t.join(10)
    assert not t.is_alive()


def test_submit_validation(cfg, engine):
    with pytest.raises(UserError):
        engine.submit([])                          # empty prompt
    with pytest.raises(UserError):
        engine.submit(np.arange(4), max_new=MAX_SEQ)   # exceeds max_seq
    with pytest.raises(UserError):
        engine.submit([cfg.vocab_size + 7])        # out-of-vocab token
    with pytest.raises(UserError):
        engine.start(np.zeros(5, np.float32))      # wrong weights size


def test_release_frees_buffers_and_fails_queued(cfg):
    eng = _engine(cfg, capacity=1, default_max_new=2, endpoint_id="ep-rel")
    req = eng.submit(np.arange(4, dtype=np.int32) + 1)
    eng.start(None)
    assert eng._cache is not None
    eng.release()
    assert eng._cache is None and eng.params is None
    assert req.status == "FAILED"
    with pytest.raises(EndpointClosed):
        eng.submit([1, 2])


def test_add_slot_grows_capacity_at_next_start(cfg):
    eng = _engine(cfg, capacity=1, default_max_new=2, endpoint_id="ep-add")
    eng.start(None)
    eng.add_slot(2)
    assert eng.capacity == 1 and eng.stats()["pending_slots"] == 2
    eng.start(None)
    assert eng.capacity == 3
    assert eng._cache["k"].shape[1] == 3 and eng._cache["pos"].shape == (3,)


def test_same_seed_same_tokens(cfg):
    """Deploy-from-arch is deterministic: same seed, same tokens."""
    prompt = np.arange(5, dtype=np.int32) + 3
    outs = []
    for _ in range(2):
        eng = _engine(cfg, capacity=1, seed=7, endpoint_id="ep-seed")
        eng.start(None)
        outs.append(_serve(eng, [eng.submit(prompt, max_new=4)])[0].tokens)
    assert outs[0] == outs[1]


def test_default_device_is_cuda_without_fallback(cfg, monkeypatch):
    """Built without ``device=``, the engine runs on CUDA; with none
    present it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg, device="cuda")


def test_unported_family_raises_user_error():
    with pytest.raises(UserError, match="encoder-decoder"):
        InferenceEngine(reduce_for_smoke(get_arch("whisper-large-v3")),
                        device="cpu")
