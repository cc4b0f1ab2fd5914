"""Checkpointing: model weights (`torch.save` of a state_dict) + normalizer stats (npz).

Reference contract: weights-only `torch.save` of `<Model>_<Case>_<runname>.pth`
paired with `<...>_norms.npz` holding `{in_a, in_b, out_a, out_b}`. The norms
file is the same one `cppre.utils.checkpoint` writes, so bundles of the two
packages share it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["checkpoint_name", "save_checkpoint", "load_checkpoint",
           "save_norms", "load_norms"]


def checkpoint_name(model: str, case: str, run_name: str) -> str:
    return f"{model}_{case}_{run_name}"


def save_checkpoint(path: str, model) -> str:
    """Write `model.state_dict()` (or a state_dict) to `<path>.pth`."""
    if not path.endswith(".pth"):
        path = path + ".pth"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = model.state_dict() if hasattr(model, "state_dict") else model
    torch.save({k: v.detach().cpu() for k, v in state.items()}, path)
    return path


def load_checkpoint(path: str, model):
    """Load `<path>.pth` into `model` (weights only, no pickled code) and
    return the model."""
    if not path.endswith(".pth"):
        path = path + ".pth"
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state)
    return model


def save_norms(path: str, in_normalizer, out_normalizer) -> str:
    """np.savez(in_a, in_b, out_a, out_b) — the reference's exact keys."""
    if not path.endswith(".npz"):
        path = path + "_norms.npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.savez(path, in_a=arr(in_normalizer.a), in_b=arr(in_normalizer.b),
             out_a=arr(out_normalizer.a), out_b=arr(out_normalizer.b))
    return path


def load_norms(path: str, device="cuda"):
    """Returns (in_normalizer, out_normalizer) rebuilt from the npz, their
    coefficients on `device` (the card unless the caller asks for the CPU)."""
    from ..train.normalizers import _AffineNormalizer

    if not path.endswith(".npz"):
        path = path + "_norms.npz"
    z = np.load(path)
    return (_AffineNormalizer.from_ab(z["in_a"], z["in_b"], device),
            _AffineNormalizer.from_ab(z["out_a"], z["out_b"], device))
