"""Faults planted underneath the timed path, which the check must catch.

Each is a way the program could go wrong where it produces an answer: an
answer altered where it is produced, a training step that returns its
state unchanged, half of the batch left out with the mean taken over the
rest; and two of the fused forward's own, under every served rollout: a
block that loses its bias branch b(grid), and a head (K5) that leaves out
its gelu. `planted(name)` patches the program for the duration of a block.
The CPU tests drive whole runs through them; `readings.py --faults` reads
them on the card.
"""

from __future__ import annotations

import contextlib


def _serve_answer_altered(patch):
    from cppre_torch import deploy

    predict = deploy.CalibratedSurrogate.predict

    def altered(self, a):
        out = predict(self, a)
        out["prediction"][0, 0, 3, 3, -1] += 0.05 * out["prediction"].abs().max()
        return out

    patch(deploy.CalibratedSurrogate, "predict", altered)


def _judge_answer_altered(patch):
    from cppre_torch.cp import inductive

    real = inductive.filter_sims_joint
    patch(inductive, "filter_sims_joint", lambda sets, y: ~real(sets, y))


def _bias_branch_dropped(patch):
    import torch

    from cppre_torch.models import fused

    real = fused._bias_branch
    patch(fused, "_bias_branch", lambda block, grid_c: torch.zeros_like(real(block, grid_c)))


def _head_gelu_dropped(patch):
    import torch.nn.functional as F

    from cppre_torch.models import fused

    patch(fused, "projection2d_fused", lambda z, fc1, fc2: F.linear(
        F.linear(z, fc1.weight, fc1.bias), fc2.weight, fc2.bias))


def _state_unchanged(patch):
    from cppre_torch.train import loops

    patch(loops.Optimizer, "step", lambda self: None)


def _half_batch(patch):
    from cppre_torch.train import losses

    real = losses.lp_loss

    def half(pred, target, p=2, size_average=False):
        h = pred.shape[0] // 2
        return 2 * real(pred[:h], target[:h], p, size_average)

    patch(losses, "lp_loss", half)


FAULTS = {"serve_answer_altered": _serve_answer_altered,
          "judge_answer_altered": _judge_answer_altered,
          "bias_branch_dropped": _bias_branch_dropped,
          "head_gelu_dropped": _head_gelu_dropped,
          "state_unchanged": _state_unchanged,
          "half_batch": _half_batch}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` planted, restored when the block ends."""
    undo = []

    def patch(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    try:
        FAULTS[name](patch)
        yield
    finally:
        for obj, attr, old in reversed(undo):
            setattr(obj, attr, old)
