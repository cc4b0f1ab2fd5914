"""Carry weights and normalizers of the JAX package into the port.

`fno2d_from_jax(params_np, model)` writes the flax `cppre.models.FNO2d`
params pytree (numpy leaves; the caller runs `jax.device_get`) into a
`cppre_torch.models.FNO2d`; `fno1d_from_jax` does the same for `FNO1d`.
Each is the inverse of `cppre.utils.torch_compat.fno_params_from_torch`,
so flax -> port -> `fno_params_from_torch(port.state_dict(), template)`
returns the flax params bit for bit. `fno2d_bayes_from_jax` loads
`cppre.models.variants.FNO2dBayesian` (its head's mu and log-sigma too),
`cae_from_jax` and `inr_from_jax` the Grad-Shafranov surrogates (flax
conv kernels HWIO, dense kernels [in, out]), `odefunc_from_jax` the
neural-ODE vector field `cppre.node.ODEFunc`. No JAX import is needed here.

`normalizer_from_jax(norm)` rebuilds a `cppre` affine normalizer through
`from_ab`, on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["cae_from_jax", "fno1d_from_jax", "fno2d_bayes_from_jax", "fno2d_from_jax",
           "inr_from_jax", "normalizer_from_jax", "odefunc_from_jax"]


def _dense(p):
    """flax Dense {kernel [in, out], bias} -> (weight [out, in], bias)."""
    return np.asarray(p["kernel"]).T, np.asarray(p["bias"])


def _tree(params_np):
    return params_np["params"] if set(params_np) == {"params"} else params_np


def _fno_arrays(params_np, spectral: str, n_weights: int, ones: int,
                head=("fc1_time", "fc2_time")) -> dict:
    """The port's state of a flax FNO tree whose blocks hold `spectral` with
    `n_weights` complex weights, and 1x1 channel maps with `ones` trailing
    1s; the head's layers named in `head` are plain Dense layers."""
    tp = _tree(params_np)
    new = {}
    for name in ("fc0_time",) + tuple(head):
        new[f"{name}.weight"], new[f"{name}.bias"] = _dense(tp[name])
    for i in range(6):
        bp = tp[f"f{i}"]
        sp = bp[spectral]
        for k in range(1, n_weights + 1):
            new[f"f{i}.conv.weights{k}"] = (np.asarray(sp[f"weights{k}_re"])
                                            + 1j * np.asarray(sp[f"weights{k}_im"]))
        for torch_name, path in (("mlp.mlp1", ("_ChannelMLP_0", "Dense_0")),
                                 ("mlp.mlp2", ("_ChannelMLP_0", "Dense_1")),
                                 ("w", ("_Channel1x1_0", "Dense_0")),
                                 ("b", ("_Channel1x1_1", "Dense_0"))):
            w, b = _dense(bp[path[0]][path[1]])
            new[f"f{i}.{torch_name}.weight"] = w.reshape(w.shape + (1,) * ones)
            new[f"f{i}.{torch_name}.bias"] = b
    return new


_FNO_HINT = "same T_in/step/modes/num_vars/width_time?"


def _load(model, new: dict, hint: str):
    """Copy the numpy arrays of `new` into `model`'s state, which must name
    exactly the same keys at the same shapes."""
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
                                 f"port {tuple(dst.shape)} — {hint}")
            dst.copy_(src)
    return model


def fno2d_from_jax(params_np, model):
    """Load flax FNO2d params (`{"params": ...}` or the inner tree, numpy
    leaves) into the port's `FNO2d` in place; returns the model."""
    return _load(model, _fno_arrays(params_np, "SpectralConv2d_0", 2, 3), _FNO_HINT)


def fno1d_from_jax(params_np, model):
    """Load flax FNO1d params (`{"params": ...}` or the inner tree, numpy
    leaves) into the port's `FNO1d` in place; returns the model."""
    return _load(model, _fno_arrays(params_np, "SpectralConv1d_0", 1, 2), _FNO_HINT)


def fno2d_bayes_from_jax(params_np, model):
    """Load flax `FNO2dBayesian` params into the port's `FNO2dBayesian` in
    place: the FNO2d body as `fno2d_from_jax`, and each `BayesDense` head
    layer's weight_mu / weight_log_sigma [in, out] as [out, in], its
    bias_mu / bias_log_sigma as they are. Returns the model."""
    new = _fno_arrays(params_np, "SpectralConv2d_0", 2, 3, head=())
    for name in ("fc1_time", "fc2_time"):
        p = _tree(params_np)[name]
        for kind in ("mu", "log_sigma"):
            new[f"{name}.weight_{kind}"] = np.asarray(p[f"weight_{kind}"]).T
            new[f"{name}.bias_{kind}"] = np.asarray(p[f"bias_{kind}"])
    return _load(model, new, _FNO_HINT)


def cae_from_jax(params_np, model):
    """Load flax `ConvAutoencoder` params (`Conv_0..3`, `Dense_0..1`,
    `ConvTranspose_0..2`) into the port's `ConvAutoencoder` in place: conv
    kernels HWIO -> [out, in, kh, kw], transposed-conv kernels
    [kh, kw, in, out] -> [in, out, kh, kw], dense [in, out] -> [out, in].
    Returns the model."""
    tp = _tree(params_np)
    hwio = lambda k: np.asarray(k).transpose(3, 2, 0, 1)
    new = {}
    for i, name in enumerate(("enc.0", "enc.1", "enc.2", "head")):
        new[f"{name}.weight"] = hwio(tp[f"Conv_{i}"]["kernel"])
        new[f"{name}.bias"] = np.asarray(tp[f"Conv_{i}"]["bias"])
    for i, name in enumerate(("fc_in", "fc_out")):
        new[f"{name}.weight"], new[f"{name}.bias"] = _dense(tp[f"Dense_{i}"])
    for i in range(3):
        p = tp[f"ConvTranspose_{i}"]
        new[f"dec.{i}.weight"] = np.asarray(p["kernel"]).transpose(2, 3, 0, 1)
        new[f"dec.{i}.bias"] = np.asarray(p["bias"])
    return _load(model, new, "same n_params/latent/base and grid?")


def inr_from_jax(params_np, model):
    """Load flax `INR` params (`Dense_0..depth`, the last the head) into
    the port's `INR` in place. Returns the model."""
    tp = _tree(params_np)
    new = {}
    for i in range(model.depth):
        new[f"layers.{i}.weight"], new[f"layers.{i}.bias"] = _dense(tp[f"Dense_{i}"])
    new["head.weight"], new["head.bias"] = _dense(tp[f"Dense_{model.depth}"])
    return _load(model, new, "same n_params/width/depth/n_freqs?")


def odefunc_from_jax(params_np, model):
    """Load flax `ODEFunc` params (`Dense_0..2`, kernel [in, out]) into the
    port's `ODEFunc` in place (weight = kernel^T). Returns the model."""
    tp = _tree(params_np)
    new = {}
    for i in range(3):
        new[f"dense{i}.weight"], new[f"dense{i}.bias"] = _dense(tp[f"Dense_{i}"])
    return _load(model, new, "same hidden_dim/state_dim/time_dependent?")


def normalizer_from_jax(norm, device="cuda"):
    """A `cppre` normalizer (any affine one) as the port's, via `from_ab`."""
    from ..train.normalizers import _AffineNormalizer

    return _AffineNormalizer.from_ab(np.asarray(norm.a), np.asarray(norm.b), device)
