"""The rest of the operator library of cppre_torch against cppre: the FFT
operators (`fft_conv`, `spectral_differentiate`, `spectral_integrate`,
`FFTConv1d/2d`), the ConvOperator family (0d, 1d, 2d, Spatial; direct and
spectral), `BoundaryManager`, the `vector` and `vector_spatial` operators
and the dense finite-difference matrices.

Inputs come from numpy seeds and go through both packages on the CPU.

Tolerances:
* the FFT operators: 1e-5 of max|cppre| (float32 FFTs of two libraries);
* the operators' `forward`, `differentiate` and `integrate`, the boundary
  padding and the vector operators: 1e-6 of max|cppre|; the composite
  advection operator's `integrate` at 1e-6 of max outside the stencil's
  null modes (`null_free`), and at 1e-5 with eps 1e-2;
* `finite_difference_matrix_1d/2d`: exact (the same numpy code).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppre.ops import boundary as jboundary
from cppre.ops import convops as jconvops
from cppre.ops import fftconv as jfft
from cppre.ops import findiff_matrix as jfindiff
from cppre.ops import vector as jvector
from cppre.ops import vector_spatial as jvector_spatial
from cppre_torch.ops import (BoundaryManager, ConvOperator0d, ConvOperator1d, ConvOperator2d,
                             ConvOperatorSpatial, FFTConv1d, FFTConv2d, fft_conv,
                             finite_difference_matrix_1d, finite_difference_matrix_2d,
                             spectral_differentiate, spectral_integrate)
from cppre_torch.ops import vector, vector_spatial


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run torch on one thread (the 1-D files import this fixture). Their
    solvers and operators make thousands of small calls, and with torch's
    default pool in every test worker the pools spin against each other:
    a Burgers solve beside five others took 424 s each on 8 threads and
    0.5 s on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arr(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _j(fn, *arrays, **static):
    """cppre's `fn` on `arrays`, compiled once (keywords are static)."""
    return jax.jit(partial(fn, **static))(*(jnp.asarray(a) for a in arrays))


def _close(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


FFT_CASES = {
    "groups1": dict(shape=(2, 3, 17), k=(4, 3, 3), kw={}),
    "groups2": dict(shape=(2, 4, 16), k=(6, 2, 3), kw=dict(groups=2, padding=1)),
    "dilation2": dict(shape=(2, 2, 15), k=(3, 2, 3), kw=dict(dilation=2, padding=2)),
    "stride2": dict(shape=(1, 2, 20), k=(2, 2, 5), kw=dict(stride=2, padding=2)),
    "same": dict(shape=(2, 1, 13), k=(1, 1, 4), kw=dict(padding="same")),
    "reflect": dict(shape=(2, 1, 14), k=(1, 1, 5), kw=dict(padding=2, padding_mode="reflect")),
    "replicate": dict(shape=(2, 2, 11, 9), k=(1, 2, 3, 3),
                      kw=dict(padding=(1, 2), padding_mode="replicate")),
    "constant2d": dict(shape=(1, 2, 12, 10), k=(3, 2, 3, 5), kw=dict(padding=(1, 2))),
    "inverse": dict(shape=(2, 1, 24), k=(1, 1, 3), kw=dict(padding=1, inverse=True)),
    "inverse2d": dict(shape=(1, 1, 10, 12), k=(1, 1, 3, 3), kw=dict(padding=1, inverse=True)),
}


@pytest.mark.parametrize("case", sorted(FFT_CASES))
def test_fft_conv_matches_cppre(case):
    c = FFT_CASES[case]
    x, k, b = _arr(1, c["shape"]), _arr(2, c["k"]), _arr(3, (c["k"][0],))
    if c["kw"].get("inverse"):
        k = np.abs(k) + 1.0  # a spectrum away from 0, so 1/(K+eps) is well conditioned
    got = fft_conv(torch.tensor(x), torch.tensor(k), torch.tensor(b), **c["kw"])
    want = _j(jfft.fft_conv, x, k, b, **c["kw"])
    _close(got, want, 1e-5)


@pytest.mark.parametrize("n", [16, 17])
@pytest.mark.parametrize("rank", [1, 2])
def test_spectral_differentiate_and_integrate_match_cppre(n, rank):
    """Odd and even lengths, correlation, a vector coefficient, both crops,
    and `integrate` with and without its padding."""
    shape = (2, 1) + (n,) * rank
    x = _arr(4, shape)
    kern = np.asarray(ConvOperator1d("x", 1).kernel if rank == 2 else
                      ConvOperator0d(1).kernel)
    vec = _arr(5, (n,) * rank)
    for corr in (False, True):
        for slice_pad in (False, True):
            _close(spectral_differentiate(torch.tensor(x), kern, corr, slice_pad),
                   _j(jfft.spectral_differentiate, x, kern, correlation=corr,
                      slice_pad=slice_pad), 1e-5)
        _close(spectral_differentiate(torch.tensor(x), kern, corr, vector=torch.tensor(vec)),
               _j(lambda f, k, v: jfft.spectral_differentiate(f, k, corr, vector=v), x, kern,
                  vec), 1e-5)
    # a kernel with a spectrum away from 0 for the deconvolution
    kinv = np.zeros_like(kern)
    kinv[(1,) * rank] = 1.0
    kinv = kinv + 0.1 * kern
    for pad in (True, False):
        for slice_pad in (False, True):
            _close(spectral_integrate(torch.tensor(x), kinv, slice_pad=slice_pad, pad=pad),
                   _j(jfft.spectral_integrate, x, kinv, slice_pad=slice_pad, pad=pad), 1e-5)


@pytest.mark.parametrize("ndim", [1, 2])
def test_fftconv_layers_match_cppre(ndim):
    """FFTConv1d/2d with the same weights: the port's parameters copied
    into cppre's params dict."""
    make, jmake = (FFTConv1d, jfft.FFTConv1d) if ndim == 1 else (FFTConv2d, jfft.FFTConv2d)
    layer = make(4, 6, 3, padding=1, groups=2, device="cpu",
                 generator=torch.Generator().manual_seed(7))
    jlayer = jmake(4, 6, 3, padding=1, groups=2)
    params = {"weight": jnp.asarray(layer.weight.detach().numpy()),
              "bias": jnp.asarray(layer.bias.detach().numpy())}
    assert jlayer.init(0)["weight"].shape == tuple(layer.weight.shape)
    x = _arr(8, (2, 4) + (12,) * ndim)
    _close(layer(torch.tensor(x)), jax.jit(jlayer.apply)(params, jnp.asarray(x)), 1e-5)


def _boundary(mode):
    """A 3x3 BoundaryManager in `mode` on every side, or mixed sides."""
    pair = []
    for mod in (jboundary, None):
        bm = (mod.BoundaryManager if mod else BoundaryManager)((3, 3))
        if mode == "mixed":
            bm.set_boundary_type("left", "dirichlet", 0.5)
            bm.set_boundary_type("right", "neumann")
            bm.set_boundary_type("top", "symmetric")
            bm.set_boundary_type("bottom", "periodic")
        else:
            bm.set_all_boundaries(mode, 0.25)
        pair.append(bm)
    return pair


BC_MODES = ["dirichlet", "neumann", "periodic", "symmetric", "free_slip", "outflow", "mixed"]


@pytest.mark.parametrize("mode", BC_MODES)
def test_boundary_manager_matches_cppre(mode):
    jbm, bm = _boundary(mode)
    x = _arr(9, (2, 3, 7, 6))
    _close(bm.pad_signal(torch.tensor(x)), jbm.pad_signal(jnp.asarray(x)), 0)
    _close(bm.pad(torch.tensor(x[0, 0])), jbm.pad(jnp.asarray(x[0, 0])), 0)
    kern = _arr(10, (3, 3))
    conv = lambda z: jbm.apply_convolution(z, kern)
    _close(bm.apply_convolution(torch.tensor(x), kern), _j(conv, x), 1e-6)
    _close(bm.apply_convolution(torch.tensor(x[0, 0]), kern), _j(conv, x[0, 0]), 1e-6)


def _ops(kind):
    """(port operator, cppre operator, input shape) per kind."""
    if kind == "0d":
        return ConvOperator0d(2), jconvops.ConvOperator0d(2), (3, 19)
    if kind == "1d-t":
        return ConvOperator1d("t", 1), jconvops.ConvOperator1d("t", 1), (3, 11, 14)
    if kind == "1d-x":
        return ConvOperator1d("x", 2, 0.5), jconvops.ConvOperator1d("x", 2, 0.5), (3, 11, 14)
    if kind == "1d-xt":
        return (ConvOperator1d(("x", "t"), 2, taylor_order=4),
                jconvops.ConvOperator1d(("x", "t"), 2, taylor_order=4), (2, 12, 13))
    if kind == "2d":
        return ConvOperator2d("y", 1), jconvops.ConvOperator2d("y", 1), (2, 7, 8, 9)
    if kind == "2d-xy":
        return (ConvOperator2d(("x", "y"), 2), jconvops.ConvOperator2d(("x", "y"), 2),
                (2, 6, 9, 8))
    raise ValueError(kind)


OP_KINDS = ["0d", "1d-t", "1d-x", "1d-xt", "2d", "2d-xy"]


@pytest.mark.parametrize("kind", OP_KINDS)
def test_conv_operators_match_cppre(kind):
    """forward (direct and spectral), differentiate and integrate."""
    op, jop, shape = _ops(kind)
    x = _arr(11, shape)
    tx = torch.tensor(x)
    _close(op(tx), _j(jop, x), 1e-6)
    sp, jsp = type(op)(conv="spectral"), type(jop)(conv="spectral")
    sp.kernel, jsp.kernel = op.kernel, jop.kernel
    _close(sp(tx), _j(jsp, x), 1e-6)
    _close(op.differentiate(tx), _j(jop.differentiate, x), 1e-6)
    _close(op.differentiate(tx, correlation=True, slice_pad=False),
           _j(jop.differentiate, x, correlation=True, slice_pad=False), 1e-6)
    # a difference stencil's spectrum is 0 at the zero mode, where the
    # default eps (1e-6) amplifies the field's mean 1e6-fold; eps 1e-2
    # keeps every other mode in view
    _close(op.integrate(tx), _j(jop.integrate, x), 1e-6)
    _close(op.integrate(tx, eps=1e-2, slice_pad=True),
           _j(jop.integrate, x, eps=1e-2, slice_pad=True), 1e-6)


def null_free(z, nd=2):
    """`z` [B, *grid] less, per sample, its least-squares fit on the 2^nd
    patterns prod_i (+-1)^(n_i) over the last `nd` axes (1, (-1)^t,
    (-1)^x, (-1)^(t+x), ...): the modes where a difference stencil such as
    D_t + c D_x has a zero spectrum (the zero and Nyquist modes). There
    `integrate` divides the FFT's rounding of the kernel's spectrum (~3e-8
    in float32, and 0 in another library) by eps = 1e-6, so each FFT
    library gives its own values there."""
    z = np.asarray(z, dtype=np.float64)
    grid = z.shape[-nd:]
    axes = np.meshgrid(*(np.arange(n) for n in grid), indexing="ij")
    basis = np.stack([np.prod([(-1.0) ** (a * bit) for a, bit in zip(axes, bits)], axis=0)
                      for bits in np.ndindex(*(2,) * nd)], -1).reshape(-1, 2 ** nd)
    flat = z.reshape(-1, int(np.prod(grid))).T
    coef = np.linalg.lstsq(basis, flat, rcond=None)[0]
    return (flat - basis @ coef).T.reshape(z.shape)


@pytest.mark.parametrize("shape", [(3, 20, 30), (3, 10, 197), (3, 11, 196)])
def test_composite_operator_integrate_matches_cppre(shape):
    """The advection operator D_t + c D_x, as `PRE_Advection` composes it:
    forward and the deconvolution of residual bounds, held at 1e-6 of
    max|cppre| once the stencil's null modes are taken out (`null_free`);
    at eps 1e-2, where no mode is near-singular but the deconvolution
    still scales the field's rounding up to 100-fold, at 1e-5 of max."""
    op, jop = ConvOperator1d(), jconvops.ConvOperator1d()
    t, x = ConvOperator1d("t", 1), ConvOperator1d("x", 1)
    op.kernel = t.kernel + np.float32(0.4) * x.kernel
    jop.kernel = jnp.asarray(t.kernel) + 0.4 * jnp.asarray(x.kernel)
    u = _arr(12, shape)
    _close(op(torch.tensor(u)), jop(jnp.asarray(u)), 1e-6)
    r = np.asarray(jop(jnp.asarray(u))) + 0.1
    got, want = op.integrate(torch.tensor(r)), np.asarray(jop.integrate(jnp.asarray(r)))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(null_free(got.numpy()), null_free(want), rtol=0,
                               atol=1e-6 * np.abs(want).max())
    _close(op.integrate(torch.tensor(r), eps=1e-2), jop.integrate(jnp.asarray(r), eps=1e-2),
           1e-5)


@pytest.mark.parametrize("domain,order,mode", [
    ("x", 1, None), ("y", 1, "dirichlet"), (("x", "y"), 2, "periodic"), ("x", 2, "mixed"),
    ("y", 2, "neumann"), (("x", "y"), 2, "symmetric")])
def test_conv_operator_spatial_matches_cppre(domain, order, mode):
    bm, jbm = _boundary(mode)[::-1] if mode else (None, None)
    op = ConvOperatorSpatial(domain, order, scale=0.7, boundary=bm)
    jop = jconvops.ConvOperatorSpatial(domain, order, scale=0.7, boundary=jbm)
    x = _arr(13, (2, 2, 9, 8))
    _close(op(torch.tensor(x)), _j(jop, x), 1e-6)


def test_conv_operator_spatial_learnable_scale():
    """A scale with requires_grad takes F.conv2d and differentiates into the
    scale: d/ds sum(s K * x) = sum(K * x)."""
    x = torch.tensor(_arr(14, (2, 1, 8, 8)))
    scale = torch.tensor(0.5, requires_grad=True)
    op = ConvOperatorSpatial("x", 1, scale=scale)
    out = op(x)
    out.sum().backward()
    fixed = ConvOperatorSpatial("x", 1, scale=1.0)(x)
    np.testing.assert_allclose(out.detach().numpy(), 0.5 * fixed.numpy(), rtol=0,
                               atol=1e-6 * fixed.abs().max().item())
    np.testing.assert_allclose(scale.grad.item(), fixed.sum().item(), rtol=1e-5)


def test_vector_operators_match_cppre():
    a, b = _arr(15, (2, 2, 6, 7, 8)), _arr(16, (2, 2, 6, 7, 8))
    ta, tb, ja, jb = torch.tensor(a), torch.tensor(b), jnp.asarray(a), jnp.asarray(b)
    for name in ("dot", "cross", "cross_true", "vectorize"):
        _close(getattr(vector, name)(ta, tb), getattr(jvector, name)(ja, jb), 1e-6)
    _close(vector.Divergence()(ta[0], tb[0]), jvector.Divergence()(ja[0], jb[0]), 1e-6)
    _close(vector.Gradient()(ta[0]), jvector.Gradient()(ja[0]), 1e-6)
    _close(vector.Curl()(ta[0], tb[0]), jvector.Curl()(ja[0], jb[0]), 1e-6)
    _close(vector.Laplace()(ta[0], tb[0]), jvector.Laplace()(ja[0], jb[0]), 1e-6)


@pytest.mark.parametrize("bc", ["periodic", "dirichlet"])
def test_vector_spatial_operators_match_cppre(bc):
    a, b = _arr(17, (2, 2, 9, 10)), _arr(18, (2, 2, 9, 10))
    ta, tb, ja, jb = torch.tensor(a), torch.tensor(b), jnp.asarray(a), jnp.asarray(b)
    for name in ("dot", "cross", "vectorize"):
        _close(getattr(vector_spatial, name)(ta, tb), getattr(jvector_spatial, name)(ja, jb),
               1e-6)
    u, v, ju, jv = ta[:, :1], tb[:, :1], ja[:, :1], jb[:, :1]
    for name in ("Gradient", "Divergence", "Curl", "VectorGradient"):
        op = getattr(vector_spatial, name)(boundary_cond=bc)
        jop = getattr(jvector_spatial, name)(boundary_cond=bc)
        args, jargs = ((u,), (ju,)) if name == "Gradient" else ((u, v), (ju, jv))
        _close(op(*args), jop(*jargs), 1e-6)
    for scalar in (True, False):
        _close(vector_spatial.Laplace(boundary_cond=bc, scalar=scalar)(u, v),
               jvector_spatial.Laplace(boundary_cond=bc, scalar=scalar)(ju, jv), 1e-6)


def test_finite_difference_matrices_match_cppre_exactly():
    s1 = ConvOperator0d(2).kernel
    np.testing.assert_array_equal(finite_difference_matrix_1d(9, s1),
                                  jfindiff.finite_difference_matrix_1d(9, s1))
    s2 = ConvOperator1d(("x", "t"), 2).kernel
    np.testing.assert_array_equal(finite_difference_matrix_2d(5, 6, s2),
                                  jfindiff.finite_difference_matrix_2d(5, 6, s2))
    # and the matrix is the operator: zero-padded 'same' convolution
    x = _arr(19, (5, 6))
    want = (finite_difference_matrix_2d(5, 6, s2) @ x.reshape(-1).astype(np.float64))
    got = ConvOperator1d(("x", "t"), 2)(torch.tensor(x[None]))[0].numpy().reshape(-1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
