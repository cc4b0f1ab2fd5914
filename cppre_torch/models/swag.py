"""SWAG (SWA-Gaussian) posterior over a torch model's parameters (port of
`cppre.models.swag`).

Running mean and second moment of the flattened parameter vector, a FIFO
low-rank deviation matrix capped at `max_num_models` columns, and
`sample(scale=0.5)` drawing theta + scale*sqrt(var)*z1 +
scale/sqrt(K-1) * D z2.

The flat vector follows the port's own parameter order
(`model.named_parameters()`), a complex parameter as its interleaved real
and imaginary parts, so it is not cppre's `ravel_pytree` order; `unflatten`
turns a vector back into named parameters, and `load_into` writes one into
a model. The statistics live on the model's device in float32, as cppre's
numpy arrays do on the host; the draws come from a `torch.Generator` on
that device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SWAG"]


class SWAG:
    def __init__(self, model, max_num_models: int = 20, var_clamp: float = 1e-6):
        self._layout = [(name, tuple(p.shape), p.dtype) for name, p in model.named_parameters()]
        self.dim = sum(self._numel(shape, dtype) for _, shape, dtype in self._layout)
        self.device = next(model.parameters()).device
        self.max_num_models = max_num_models
        self.var_clamp = var_clamp
        self.n_models = 0
        self.theta = None
        self.theta_sq = None
        self.D = None  # [dim, <=K] FIFO deviation columns

    @staticmethod
    def _numel(shape, dtype):
        return int(np.prod(shape, dtype=np.int64)) * (2 if dtype.is_complex else 1)

    def flatten(self, model) -> torch.Tensor:
        """The model's parameters as one float32 vector, in the port's order."""
        with torch.no_grad():
            return torch.cat([(torch.view_as_real(p) if p.is_complex() else p).reshape(-1)
                              for _, p in model.named_parameters()]).float()

    def unflatten(self, w) -> dict:
        """A flat vector as {parameter name: tensor} in the model's shapes."""
        out, i = {}, 0
        for name, shape, dtype in self._layout:
            n = self._numel(shape, dtype)
            piece = w[i:i + n]
            if dtype.is_complex:
                piece = torch.view_as_complex(piece.reshape(shape + (2,)).contiguous())
            out[name] = piece.reshape(shape)
            i += n
        return out

    @torch.no_grad()
    def load_into(self, model, w):
        """Write a flat vector into `model`'s parameters in place."""
        params = dict(model.named_parameters())
        for name, value in self.unflatten(w).items():
            params[name].copy_(value)
        return model

    def collect_model(self, model):
        """Fold one parameter snapshot into the running statistics."""
        w = self.flatten(model)
        if self.theta is None:
            self.theta = w.clone()
            self.theta_sq = w**2
        else:
            self.n_models += 1
            n = self.n_models
            self.theta = (self.theta * n + w) / (n + 1)
            self.theta_sq = (self.theta_sq * n + w**2) / (n + 1)
        dev = (w - self.theta)[:, None]
        if self.D is None:
            self.D = dev
        elif self.D.shape[1] < self.max_num_models:
            self.D = torch.cat([self.D, dev], dim=1)
        else:
            self.D = torch.cat([self.D[:, 1:], dev], dim=1)

    def sample_vector(self, generator=None, scale: float = 0.5):
        """One posterior draw as a flat vector, z1 [dim] then z2 [K] drawn
        from `generator`."""
        variance = torch.clamp(self.theta_sq - self.theta**2, min=self.var_clamp)
        z1 = torch.randn(self.dim, generator=generator, device=self.theta.device)
        w = self.theta + scale * torch.sqrt(variance) * z1
        if self.D is not None and self.D.shape[1] > 1:
            z2 = torch.randn(self.D.shape[1], generator=generator, device=self.D.device)
            w = w + scale / np.sqrt(self.D.shape[1] - 1) * (self.D @ z2)
        return w

    def sample(self, generator=None, scale: float = 0.5):
        """Draw one posterior parameter set {name: tensor}."""
        return self.unflatten(self.sample_vector(generator, scale))

    # -- persistence: the statistics in an npz, as cppre keeps them ----------
    def save(self, path: str):
        host = lambda t: None if t is None else t.detach().cpu().numpy()
        np.savez(path, theta=host(self.theta), theta_sq=host(self.theta_sq), D=host(self.D),
                 n_models=self.n_models, max_num_models=self.max_num_models,
                 var_clamp=self.var_clamp)

    def load(self, path: str):
        z = np.load(path, allow_pickle=True)
        dev = lambda a: torch.as_tensor(a, device=self.device)
        self.theta = dev(z["theta"])
        self.theta_sq = dev(z["theta_sq"])
        self.D = None if z["D"].ndim == 0 else dev(z["D"])
        self.n_models = int(z["n_models"])
        self.max_num_models = int(z["max_num_models"])
        self.var_clamp = float(z["var_clamp"])
        return self
