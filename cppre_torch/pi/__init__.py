"""Physics-informed (fine-)tuning: the PRE as the training loss (port of
`cppre.pi`).

PI losses are ordinary differentiable functions of the rollout output.
Config `basic` trains from scratch with the PI loss; `finetune` starts
from a model pretrained on the data loss. On the card the wave PI
operator is kernel K8 on the zero-padded field (`losses.StencilOperator`),
whose backward is K8 again; the FNO rollout runs K4/K5 forward and K6/K7
backward (`models.make_fused_train_apply`).
"""

from .losses import StencilOperator, make_combined_loss, make_pi_loss, make_pisl_loss
from .train import finetune_physics_informed

__all__ = [
    "StencilOperator",
    "make_pi_loss",
    "make_pisl_loss",
    "make_combined_loss",
    "finetune_physics_informed",
]
