"""The program's NS momentum residual: kernel K2, as `cppre_torch.experiments.ns.run` calls it."""


def port(r):
    from cppre_torch.ops.kernels import ns_momentum_residual_fused

    dt, dx, dy, nu = r["dt"], r["dx"], r["dy"], r["nu"]
    return lambda fields: ns_momentum_residual_fused(fields, dt, dx, dy, nu)
