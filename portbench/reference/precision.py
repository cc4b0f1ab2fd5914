"""The control's precision: float32 operands rounded to TF32.

TF32 keeps float32's 8-bit exponent and 10 of its 23 mantissa bits; a
tensor-core product rounds its operands so and accumulates in float32.
`tf32(x, True)` rounds x to the nearest TF32 value (ties away from zero),
on any device, so the control reads the same on the card and the CPU; under
autograd the gradient flowing back through it is rounded too, as the
backward's products would round their operands.
"""

from __future__ import annotations

import torch


def _round(x):
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g)


def tf32(x, lowp: bool):
    return _TF32.apply(x) if lowp else x
