"""The program's wave residual: kernel K8 on the composite stencil, as
`cppre_torch.experiments.wave.run` calls it."""


def port(r):
    from cppre_torch.ops.kernels import wave_residual_fused
    from cppre_torch.residuals.wave import PRE_Wave

    kernel = PRE_Wave(r["dt"], r["dx"], c=r["c"]).D.kernel
    return lambda fields: wave_residual_fused(fields[:, 0], kernel)
