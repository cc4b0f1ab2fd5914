"""Neural-ODE studies: train NODEs on classic ODEs, analyse them with
ConvOperator0d (port of `cppre.node`).

An MLP vector field integrated by adaptive Dormand-Prince 5(4), step for
step the algorithm of `jax.experimental.ode.odeint` that `cppre` calls
(`models.odeint`, batched over samples, differentiated by autograd through
the accepted steps), ground truths from the closed forms, residuals from
ConvOperator0d composite kernels and integrate(differentiate(u))
inversion round trips. Plain torch: `cppre` has no Pallas kernel here.
"""

from .models import ODEFunc, fit_node, neural_odeint
from .problems import (bessel_solution, cauchy_euler_solution, dho_residual_kernel, dho_solution,
                       sho_residual_kernel, sho_solution)

__all__ = [
    "ODEFunc",
    "neural_odeint",
    "fit_node",
    "sho_solution",
    "dho_solution",
    "bessel_solution",
    "cauchy_euler_solution",
    "sho_residual_kernel",
    "dho_residual_kernel",
]
