"""The published training step of the FNO surrogates: the autoregressive
rollout loss (relative L2 per sample, summed over the batch, summed over the
rollout's steps), the gradient clipped to a global norm (over the real and
imaginary parts of complex weights alike), then Adam (betas 0.9, 0.999,
eps 1e-8) on every real and imaginary part."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import fno


def lp_loss(pred, target):
    b = pred.shape[0]
    d = torch.linalg.vector_norm((pred - target).reshape(b, -1), dim=1)
    t = torch.linalg.vector_norm(target.reshape(b, -1), dim=1)
    return (d / t).sum()


def rollout_loss(p, xx, yy, cfg, lowp=False):
    """Sum over the rollout's steps of lp_loss(step's frames, target's);
    each step checkpointed to keep the activations of one step."""
    step, total = cfg["Step"], 0.0

    def body(xx, y):
        im = fno.forward(p, xx, cfg, lowp)
        return im, lp_loss(im, y)

    for t in range(cfg["T_out"] // step):
        im, loss = checkpoint(body, xx, yy[..., t * step:(t + 1) * step], use_reentrant=False)
        total = total + loss
        xx = torch.cat((xx[..., step:], im), dim=-1)
    return total


def _real(t):
    return torch.view_as_real(t) if t.is_complex() else t


class Adam:
    """Adam over real views of the parameters, with global-norm clipping."""

    def __init__(self, params, lr, clip, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.clip = params, lr, clip
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(_real(v)) for k, v in params.items()}
        self.v = {k: torch.zeros_like(_real(v)) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        """Clip `grads` (a dict like the params), step; returns the clipped grads."""
        g = {k: _real(v) for k, v in grads.items()}
        norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values()))
        if norm >= self.clip:
            g = {k: x * (self.clip / norm).float() for k, x in g.items()}
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            self.m[k].mul_(self.b1).add_(g[k], alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g[k], g[k], value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt().add_(self.eps)
            _real(p).addcdiv_(self.m[k], denom, value=-self.lr / c1)
        return g
