"""Carry weights and normalizers of the JAX package into the port.

`fno2d_from_jax(params_np, model)` writes the flax `cppre.models.FNO2d`
params pytree (numpy leaves; the caller runs `jax.device_get`) into a
`cppre_torch.models.FNO2d`. It is the inverse of
`cppre.utils.torch_compat.fno_params_from_torch`, so flax -> port ->
`fno_params_from_torch(port.state_dict(), template)` returns the flax
params bit for bit. No JAX import is needed here.

`normalizer_from_jax(norm)` rebuilds a `cppre` affine normalizer through
`from_ab`.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fno2d_from_jax", "normalizer_from_jax"]


def _dense(p):
    """flax Dense {kernel [in, out], bias} -> (weight [out, in], bias)."""
    return np.asarray(p["kernel"]).T, np.asarray(p["bias"])


def fno2d_from_jax(params_np, model):
    """Load flax FNO2d params (`{"params": ...}` or the inner tree, numpy
    leaves) into the port's `model` in place; returns the model."""
    tp = params_np["params"] if set(params_np) == {"params"} else params_np
    new = {}
    for name in ("fc0_time", "fc1_time", "fc2_time"):
        new[f"{name}.weight"], new[f"{name}.bias"] = _dense(tp[name])
    for i in range(6):
        bp = tp[f"f{i}"]
        sp = bp["SpectralConv2d_0"]
        for k in (1, 2):
            new[f"f{i}.conv.weights{k}"] = (np.asarray(sp[f"weights{k}_re"])
                                            + 1j * np.asarray(sp[f"weights{k}_im"]))
        for torch_name, path in (("mlp.mlp1", ("_ChannelMLP_0", "Dense_0")),
                                 ("mlp.mlp2", ("_ChannelMLP_0", "Dense_1")),
                                 ("w", ("_Channel1x1_0", "Dense_0")),
                                 ("b", ("_Channel1x1_1", "Dense_0"))):
            w, b = _dense(bp[path[0]][path[1]])
            new[f"f{i}.{torch_name}.weight"] = w.reshape(w.shape + (1, 1, 1))
            new[f"f{i}.{torch_name}.bias"] = b
    state = model.state_dict()
    missing = set(state) - set(new)
    if missing:
        raise ValueError(f"no flax leaf for port parameters {sorted(missing)[:4]}")
    with torch.no_grad():
        for key, value in new.items():
            dst = state[key]
            src = torch.from_numpy(np.array(value)).to(dst.dtype)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape mismatch at {key}: flax {tuple(src.shape)} vs "
                                 f"port {tuple(dst.shape)} — same T_in/step/modes/"
                                 f"num_vars/width_time?")
            dst.copy_(src)
    return model


def normalizer_from_jax(norm, device=None):
    """A `cppre` normalizer (any affine one) as the port's, via `from_ab`."""
    from ..train.normalizers import _AffineNormalizer

    return _AffineNormalizer.from_ab(np.asarray(norm.a), np.asarray(norm.b), device)
