"""CP-driven active learning: acquisition functions and the AL loop (port
of `cppre.al`).

Three acquisition strategies over a fresh LHS candidate pool (joint-CP or
marginal-CP rejection, PRE ranking by mean |residual|, random) feed the
chosen parameters back through the solver into the training set, which
fine-tunes the surrogate, over n_iterations rounds. On the card a 2-D FNO
rolls out through K4/K5 and fine-tunes through K4-K7; the wave case's
residual is K8.
"""

from .acquisition import acquire_cp, acquire_cp_marginal, acquire_pre, acquire_rand
from .loop import active_learning_loop

__all__ = ["acquire_cp", "acquire_cp_marginal", "acquire_pre", "acquire_rand",
           "active_learning_loop"]
