"""cppre_torch operators, NS residual and the NS kernels' plain paths vs cppre.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side of every Pallas kernel runs as tests/test_pallas_kernels.py runs
it on the CPU (interpret=True). Tolerances:
* operators and residuals: 1e-6 of max|ref| (the repo's rule for operator
  changes, CLAUDE.md) — both sides run the same shift-add taps in float32;
* joint-CP scores and qhat: 1e-5 relative (the one-pass moments of the
  kernel path sum in another order than the two-pass std);
* bfloat16-staged diff: qhat within the 1e-3 gate of bench.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import cppre.ops.convops as jconv
import cppre.ops.stencils as jst
from cppre.cp.inductive import calibrate as jcalibrate
from cppre.cp.inductive import modulation_func as jmod
from cppre.cp.inductive import ncf_metric_joint as jncf
from cppre.ops.pallas import ns_momentum_residual_fused as j_ns_res
from cppre.ops.pallas.stencil_kernels import ns_joint_cp_diff_stats as j_diff_stats
from cppre.ops.pallas.stencil_kernels import ns_joint_cp_scores_fused as j_scores
from cppre.residuals.ns import PRE_NS as JPRE_NS
from cppre_torch.cp import calibrate
from cppre_torch.ops import convops, stencils
from cppre_torch.ops import kernels as K
from cppre_torch.residuals import PRE_NS

OP_TOL = 1e-6
DT, DX, DY, NU = 0.01, 0.02, 0.03, 1e-3


def _fields(seed, shape=(3, 3, 6, 12, 10)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("deriv,taylor", [(0, 2), (1, 2), (1, 4), (1, 6), (2, 2), (2, 4),
                                          (2, 6), (3, 2), (3, 4), (4, 2)])
def test_stencil_tables_equal(deriv, taylor):
    np.testing.assert_array_equal(stencils.stencil_1d(deriv, taylor),
                                  jst.stencil_1d(deriv, taylor))
    dims = (1, 2) if deriv == 2 and taylor in (2, 4, 6) else (1,)
    for d in dims:
        st = stencils.stencil_time_space(d, deriv, taylor)
        np.testing.assert_array_equal(st, jst.stencil_time_space(d, deriv, taylor))
        for axis in (0, 1, 2):
            for legacy in (False, True):
                np.testing.assert_array_equal(stencils.embed_kernel_3d(st, axis, legacy),
                                              jst.embed_kernel_3d(st, axis, legacy))


@pytest.mark.parametrize("domain,order", [("t", 1), ("x", 1), ("y", 1), ("t", 2),
                                          (("x", "y"), 2), (("x", "y"), 1)])
@pytest.mark.parametrize("legacy", [False, True])
def test_conv_operator2d_matches_cppre(domain, order, legacy):
    f = _fields(1, (2, 6, 12, 10))
    ours = convops.ConvOperator2d(domain, order, scale=0.7, legacy_y_axis=legacy)
    ref = jconv.ConvOperator2d(domain, order, scale=0.7, legacy_y_axis=legacy)
    if ref.kernel is None:     # bare operator: invalid (domain, order) combination
        assert ours.kernel is None
        return
    np.testing.assert_array_equal(ours.kernel, np.asarray(ref.kernel))
    _close(ours(torch.tensor(f)).numpy(), ref(jnp.asarray(f)), OP_TOL)


@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_direct_conv_matches_cppre(same, as_tensor):
    """A NumPy kernel takes the shift-add, a torch kernel F.conv3d (TF32
    off); both equal cppre's direct convolution."""
    f = _fields(2, (2, 6, 12, 10))
    k = (stencils.embed_kernel_3d(stencils.stencil_time_space(1, 2), 2)
         - 0.3 * stencils.embed_kernel_3d(stencils.stencil_time_space(2, 2), 0))
    kernel = torch.tensor(k) if as_tensor else k
    got = convops.direct_conv(torch.tensor(f), kernel, same=same).numpy()
    _close(got, jconv.direct_conv(jnp.asarray(f), k, same=same), OP_TOL)


@pytest.mark.parametrize("boundary", [False, True])
@pytest.mark.parametrize("legacy", [False, True])
def test_pre_ns_matches_cppre(boundary, legacy):
    f = _fields(3)
    ours = PRE_NS(DT, DX, DY, NU, legacy_y_axis=legacy)
    ref = JPRE_NS(DT, DX, DY, NU, legacy_y_axis=legacy)
    t, j = torch.tensor(f), jnp.asarray(f)
    _close(ours.residual_momentum(t, boundary).numpy(), ref.residual_momentum(j, boundary),
           OP_TOL)
    _close(ours.residual_continuity(t, boundary).numpy(),
           ref.residual_continuity(j, boundary), OP_TOL)
    for wall in ("top", "bottom", "left", "right"):
        np.testing.assert_array_equal(ours.periodic_bc_residual(t[:, 0], wall).numpy(),
                                      np.asarray(ref.periodic_bc_residual(j[:, 0], wall)))


def test_ns_momentum_residual_plain_path():
    """K2's plain path equals cppre's PRE_NS and its Pallas kernel."""
    f = _fields(4, (3, 4, 6, 12, 10))            # Nvar > 3: the extra field is ignored
    got = K.ns_momentum_residual_fused(torch.tensor(f), DT, DX, DY, NU).numpy()
    assert got.shape == (3, 4, 10, 8)
    _close(got, JPRE_NS(DT, DX, DY, NU).residual_momentum(jnp.asarray(f)), OP_TOL)
    _close(got, j_ns_res(jnp.asarray(f), DT, DX, DY, NU, interpret=True), OP_TOL)
    np.testing.assert_array_equal(
        got, K.ns_momentum_residual_plain(torch.tensor(f), DT, DX, DY, NU).numpy())


def test_ns_joint_cp_plain_path_matches_cppre():
    """K1's plain path: diff and moments equal cppre's Pallas kernel
    (interpret mode); scores and qhat equal modulation_func +
    ncf_metric_joint and cppre's fused scores."""
    truth = _fields(5, (6, 3, 6, 12, 10))
    pred = truth + 0.1 * _fields(6, truth.shape)
    tt, tp = torch.tensor(truth), torch.tensor(pred)
    jt, jp = jnp.asarray(truth), jnp.asarray(pred)
    d, s, q = K.ns_joint_cp_diff_stats(tt, tp, DT, DX, DY, NU)
    jd, js, jq = j_diff_stats(jt, jp, DT, DX, DY, NU, interpret=True)
    _close(d.numpy(), jd, OP_TOL)
    _close(s.numpy(), js, 1e-5)
    _close(q.numpy(), jq, 1e-5)

    scores = K.ns_joint_cp_scores_fused(tt, tp, DT, DX, DY, NU, eps=1e-6)
    pre = JPRE_NS(DT, DX, DY, NU)
    ro, rp = pre.residual_momentum(jt), pre.residual_momentum(jp)
    ref = jncf(ro, rp, jmod(ro, rp) + 1e-6)
    _close(scores.numpy(), ref, 1e-5)
    _close(scores.numpy(), j_scores(jt, jp, DT, DX, DY, NU, interpret=True), 1e-5)
    for alpha in (0.1, 0.3):
        np.testing.assert_allclose(float(calibrate(scores, 6, alpha)),
                                   float(jcalibrate(ref, 6, alpha)), rtol=1e-5)


def test_ns_joint_cp_bf16_diff_and_samples_per_block():
    """bfloat16 staging: diff stored narrow, moments from the float32 diff,
    qhat within 1e-3 of cppre's bf16 kernel and of float32. The result does
    not depend on samples_per_block."""
    truth = _fields(7, (6, 3, 6, 12, 10))
    pred = truth + 0.1 * _fields(8, truth.shape)
    tt, tp = torch.tensor(truth), torch.tensor(pred)
    d16, s16, q16 = K.ns_joint_cp_diff_stats(tt, tp, DT, DX, DY, NU, diff_dtype=torch.bfloat16)
    d32, s32, q32 = K.ns_joint_cp_diff_stats(tt, tp, DT, DX, DY, NU)
    assert d16.dtype == torch.bfloat16 and s16.dtype == torch.float32
    assert torch.equal(d16, d32.to(torch.bfloat16))
    assert torch.equal(s16, s32) and torch.equal(q16, q32)
    s_bf = K.ns_joint_cp_scores_fused(tt, tp, DT, DX, DY, NU, diff_dtype=torch.bfloat16)
    s_f32 = K.ns_joint_cp_scores_fused(tt, tp, DT, DX, DY, NU)
    j_bf = j_scores(jnp.asarray(truth), jnp.asarray(pred), DT, DX, DY, NU, interpret=True,
                    diff_dtype=jnp.bfloat16)
    q_bf = float(calibrate(s_bf, 6, 0.1))
    np.testing.assert_allclose(q_bf, float(jcalibrate(j_bf, 6, 0.1)), rtol=1e-3)
    np.testing.assert_allclose(q_bf, float(calibrate(s_f32, 6, 0.1)), rtol=1e-2)
    for g in (2, 3):
        assert torch.equal(K.ns_joint_cp_scores_fused(tt, tp, DT, DX, DY, NU,
                                                      samples_per_block=g), s_f32)


def test_kernel_wrappers_route_by_device():
    """A CPU tensor takes the plain version without counting a launch; a
    device that is neither CPU nor CUDA raises instead of falling back."""
    K.reset_launch_counts()
    f = torch.tensor(_fields(9, (2, 3, 5, 8, 9)))
    K.ns_momentum_residual_fused(f, DT, DX, DY, NU)
    K.ns_joint_cp_diff_stats(f, f, DT, DX, DY, NU)
    K.ns_joint_cp_scores_fused(f, f, DT, DX, DY, NU, single_pass=True)
    K.fused_stencil_residual(f[:, 0], np.ones((3, 3, 3), np.float32))
    K.ns_joint_cp_diff_stats_chunked(f, f, DT, DX, DY, NU)
    K.ns_joint_cp_scores_flat(f, f, DT, DX, DY, NU)
    assert K.launch_counts() == {k: 0 for k in K.KERNELS}
    assert set(K.KERNELS) == {f"K{i}" for i in range(1, 13)} | {"K8-bwd"}
    meta = torch.empty((2, 3, 5, 8, 9), device="meta")
    with pytest.raises(ValueError):
        K.ns_momentum_residual_fused(meta, DT, DX, DY, NU)
    with pytest.raises(ValueError):
        K.ns_joint_cp_diff_stats(meta, meta, DT, DX, DY, NU)
    with pytest.raises(ValueError):
        K.ns_momentum_residual_fused(f[:, :2], DT, DX, DY, NU)    # needs u, v, p
