"""One initial weights vector for both packages' plans in parity tests,
and the M-RoPE positions of the vlm parity tests.

Torch cannot reproduce ``jax.random``, so a parity run hands the JAX
plugin's initial vector to the port: ``use_jax_vector`` patches both
packages' ``PLUGINS`` so that the JAX plans reuse one LM plugin (its
jits compile once) and the port's plugins return that vector from
``flat_state``."""
import numpy as np
import torch

from repro.runtime import learner as jax_learner
from repro_torch.runtime import learner as port_learner


def use_jax_vector(monkeypatch, manifest, jax_lm):
    """Patch ``PLUGINS`` of both packages for ``manifest``'s framework;
    returns the initial vector (numpy, f32)."""
    fw = manifest["framework"]["name"]
    if fw == "repro-lm":
        monkeypatch.setitem(jax_learner.PLUGINS, fw, lambda cfg: jax_lm)
        jp = jax_lm
    else:
        jp = jax_learner.PLUGINS[fw](
            {k: v for k, v in manifest["framework"].items() if k != "name"})
    flat = jp.flat_state(int(manifest.get("seed", 0)))
    monkeypatch.setitem(port_learner.PLUGINS, fw,
                        from_jax(port_learner.PLUGINS[fw], flat))
    return flat


def from_jax(cls, flat):
    """``cls`` with ``flat_state`` returning ``flat`` on its device."""
    class FromJax(cls):
        def flat_state(self, seed):
            return torch.from_numpy(flat.copy()).to(self.device)
    return FromJax


def vision_positions(B, S, grid):
    """M-RoPE (t, h, w) positions of a ``grid`` x ``grid`` patch image at
    the start of each sequence, text after it from max + 1 (Qwen2-VL's
    scheme), slot b shifted by b: (3, B, S) int32."""
    n = grid * grid
    img = np.stack([np.zeros(n), np.arange(n) // grid, np.arange(n) % grid])
    text = np.arange(S - n) + grid
    pos = np.concatenate([img, np.stack([text] * 3)], axis=1)
    return (pos[:, None, :] + np.arange(B)[None, :, None]).astype(np.int32)
