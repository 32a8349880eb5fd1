"""The plain references against the port on the CPU at tiny width, in
f32: the served logits through prefill (a batch of two, whose expert
capacity drops pairs) and decode, the training loss and gradient, and the
PS's int8 wire and Adam round."""
import numpy as np
import pytest
import torch

from bench import weights
from bench.runners import port_config
from bench.reference import lm as ref_lm
from bench.reference import ps as ref_ps
from bench.tests import tiny

SEED = 2 ** 31 + 99


def port_model(cj):
    from repro_torch.models import make_model
    cfg = port_config(cj)
    model = make_model(cfg, opts={"remat": "none"})
    params = model.init(torch.Generator().manual_seed(0))
    spec = weights.spec_of(cj)
    weights.fill_tree(spec, params, SEED)
    return model, params, spec, cfg


def getter(spec):
    return lambda path, idx: weights.draw(spec, path, idx, SEED, "cpu",
                                          torch.float32)


@pytest.mark.parametrize("name,cf", [("grok-1-L4", 1.25), ("grok-1-L4", 0.5),
                                     ("stablelm-2-1.6b-L12", None)])
def test_serve_logits_match_the_port(name, cf):
    cj = tiny.config(name, "float32")
    if cf is not None:
        cj["capacity_factor"] = cf
    model, params, spec, cfg = port_model(cj)
    g = np.random.default_rng(1)
    P, n = 12, 5
    prompts = [g.integers(0, spec.vocab, P) for _ in range(2)]
    served = g.integers(0, spec.vocab, (2, n))
    cache = model.empty_cache(2, P + n, "cpu")
    with torch.no_grad():
        lg, cache = model.prefill(
            params, {"tokens": torch.as_tensor(np.stack(prompts))},
            cache=cache, slots=torch.arange(2))
        got = [lg[:, -1]]
        for j in range(n - 1):
            lg, cache = model.decode(params, cache, {
                "tokens": torch.as_tensor(served[:, j:j + 1])})
            got.append(lg[:, -1])
    got = torch.stack(got, 1)                              # (2, n, V)
    want = ref_lm.serve_logits(spec, getter(spec), prompts,
                               {0: served[0], 1: served[1]})
    for b in range(2):
        torch.testing.assert_close(got[b], want[b], rtol=1e-4, atol=1e-4)


def test_capacity_drops_in_the_tiny_case():
    cj = tiny.config("grok-1-L4", "float32")
    spec = weights.spec_of(cj)
    x = torch.randn(24, spec.d)
    cap = ref_lm.capacity(24, 2, spec.experts, 0.5)
    idx, _ = ref_lm.route(x, torch.randn(spec.d, spec.experts), 2)
    counts = torch.bincount(idx.reshape(-1), minlength=spec.experts)
    assert counts.max() > cap             # the 0.5 case above drops pairs


def test_loss_and_grad_match_the_port():
    from repro_torch.runtime.learner import LMPlugin
    cj = tiny.config("stablelm-2-1.6b-L12", "float32")
    spec = weights.spec_of(cj)
    plugin = LMPlugin({}, cfg=port_config(cj), device="cpu")
    theta = weights.flat_vector(spec, SEED, "cpu")
    g = np.random.default_rng(2)
    doc = g.integers(0, spec.vocab, (1, 65))
    batch = {"tokens": doc[:, :-1], "labels": doc[:, 1:]}
    loss, grad = plugin.flat_loss_grad(theta, batch)
    want_loss, want_grad = ref_lm.loss_and_grad(spec, theta, batch["tokens"],
                                                batch["labels"])
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    torch.testing.assert_close(grad.float(), want_grad, rtol=1e-4,
                               atol=1e-6)


def test_ps_round_matches_the_port():
    from repro_torch.core.compression import compress_with_feedback
    from repro_torch.kernels.ref import ps_aggregate_ref
    g = torch.Generator().manual_seed(3)
    n = 1000
    grads = [torch.randn(n, generator=g) for _ in range(2)]
    errs = [torch.zeros(ref_ps.padded(n)) for _ in range(2)]
    perr = [torch.zeros(ref_ps.padded(n)) for _ in range(2)]
    theta = torch.randn(n, generator=g)
    server = ref_ps.AdamServer(theta, lr=1e-2)
    p, m, v = theta.clone(), torch.zeros(n), torch.zeros(n)
    for step in (1, 2):
        wires, rows = [], []
        for i in range(2):
            wires.append(ref_ps.wire(grads[i] * step, errs[i]))
            x = torch.zeros(ref_ps.padded(n))
            x[:n] = grads[i] * step
            _, _, perr[i], w = compress_with_feedback(x, perr[i])
            rows.append(w[:n])
            assert torch.equal(wires[-1], rows[-1])
            assert torch.equal(errs[i], perr[i])
        server.round(wires)
        ps_aggregate_ref(torch.stack(rows), p, m, v, step, solver="adam",
                         lr=1e-2)
    torch.testing.assert_close(server.theta, p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(server.m, m)
