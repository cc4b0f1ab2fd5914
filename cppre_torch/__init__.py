"""cppre_torch — CP-PRE in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch port of `cppre`. Module paths and public names mirror the JAX
package, so `cppre.X` pairs with `cppre_torch.X`, and public functions keep
its tensor layouts: `[B, Nvar, Nx, Ny, T]` for the FNO and
`[B, Nvar, Nt, Nx, Ny]` for the stencil operators and residuals.

Every kernel lives beside a plain PyTorch version of the same math
(`cppre_torch.ops.kernels`). A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises. The CUDA sources are compiled with
`nvcc` on first use (`cppre_torch.ops.kernels._build`). Entry points that
make tensors of their own (`FNO2d`, `load_norms`, `normalizer_from_jax`,
the normalizers' `from_ab` and `Identity`, the solvers, `run_2d_cp`, the
experiments' `run`) put them on the card unless the caller passes
`device="cpu"`.

Numerics: training, the rollout and the CP path run in full float32. Callers on the GPU
keep `torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32` False, as `chip_smoke.py` does.
"""

__version__ = "0.1.0"
