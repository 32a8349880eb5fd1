"""The plain reference of the software parameter server's round, as the
configuration states it: each learner's gradient, plus its error-feedback
residual, goes on the wire as int8 in blocks of 256 values with one f32
scale a block (absmax / 127, rounded half to even, clipped to +-127); the
residual keeps what the wire lost; the server takes the mean of the
learners' dequantized pushes and makes one Adam step with bias
correction.

Imports torch only: nothing of the program or of JAX.
"""
from __future__ import annotations

from typing import List

import torch

BLOCK = 256


def padded(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def wire(g: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """The dequantized int8 push of ``g`` (F,) f32; ``err`` (padded,) is
    updated in place with what the wire dropped."""
    y = err.clone()
    y[: g.numel()] += g
    yb = y.view(-1, BLOCK)
    scale = yb.abs().amax(dim=1, keepdim=True) / torch.full_like(
        yb[:, :1], 127.0)
    q = torch.clamp(torch.round(yb / scale.clamp(min=1e-30)), -127, 127)
    w = (q * scale).view(-1)
    err.copy_(y - w)
    return w[: g.numel()]


class AdamServer:
    """The server's params, moments and step, in f32."""

    def __init__(self, theta: torch.Tensor, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.theta = theta.clone()
        self.m = torch.zeros_like(theta)
        self.v = torch.zeros_like(theta)
        self.t = 0
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def round(self, pushes: List[torch.Tensor]) -> torch.Tensor:
        """One BSP round over the learners' dequantized pushes; returns
        the mean gradient the optimizer took."""
        g = torch.stack(pushes).mean(dim=0)
        self.t += 1
        self.m.mul_(self.b1).add_((1 - self.b1) * g)
        self.v.mul_(self.b2).add_((1 - self.b2) * g * g)
        mh = self.m / (1 - self.b1 ** self.t)
        vh = self.v / (1 - self.b2 ** self.t)
        self.theta.sub_(self.lr * mh / (torch.sqrt(vh) + self.eps))
        return g
