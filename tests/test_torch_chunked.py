"""K3 of cppre_torch (`*_joint_cp_diff_stats_chunked`) and the routing of the
joint-CP entries between K1 and K3 (`routing_decision`), against cppre on
the CPU.

Inputs come from numpy seeds and go through both packages; the port's
wrappers take their plain versions on a CPU tensor, and cppre runs its
chunked Pallas kernel in interpret mode at its own test shapes and
`t_block=4` (`tests/test_pallas_kernels.py`). Tolerance: the diff, sum and
sum of squares each within 2e-6 of its max|cppre|, not cppre's own 1e-6
absolute on the diff (and rtol 2e-6, atol 1e-5 on the sums): that compares
two of cppre's interpret-mode kernels, which round alike, while the
interpret-mode kernel rounds its float32 terms otherwise than XLA's
whole-array lowering (up to 1.6e-6 of max apart at these shapes), and at
the MHD magnitudes (|diff| up to ~1e4) 1e-6 absolute is below one float32
ulp. The port's plain version agrees with cppre's whole-array path bit for
bit at these shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppre.ops.pallas import stencil_kernels as jsk
from cppre.ops.stencils import embed_kernel_3d, stencil_2d
from cppre_torch.ops import kernels as K
from cppre_torch.ops.kernels import stencil_kernels as sk

ARGS = (0.01, 0.02, 0.02)
WAVE_KERNEL = (embed_kernel_3d(np.asarray(stencil_2d(2)), 2)
               - 0.25 * embed_kernel_3d(np.asarray(stencil_2d(2)), 0))


def _pair(seed, shape, offset=0.0):
    rng = np.random.default_rng(seed)
    t = (rng.standard_normal(shape) + offset).astype(np.float32)
    p = (t + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return t, p


def _assert_diff_stats(got, want):
    d, s, q = (np.asarray(a) for a in want)
    assert tuple(got[0].shape) == d.shape and tuple(got[1].shape) == s.shape
    for a, b in zip(got, (d, s, q)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-6 * np.abs(b).max())


def test_ns_chunked_matches_cppre():
    """Uneven chunks: 13 - 2 = 11 interior frames in blocks of 4 (4, 4, 3)."""
    t, p = _pair(3, (4, 3, 13, 16, 24))
    got = K.ns_joint_cp_diff_stats_chunked(torch.tensor(t), torch.tensor(p), *ARGS, t_block=4)
    want = jsk.ns_joint_cp_diff_stats_chunked(jnp.asarray(t), jnp.asarray(p), *ARGS, t_block=4,
                                              interpret=True)
    _assert_diff_stats(got, want)
    plain = K.ns_joint_cp_diff_stats_chunked_plain(torch.tensor(t), torch.tensor(p), *ARGS,
                                                   t_block=4)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


@pytest.mark.parametrize("equation", K.MHD_EQUATIONS)
def test_mhd_chunked_matches_cppre(equation):
    t, p = _pair(5, (3, 6, 11, 16, 24), offset=2.0)
    got = K.mhd_joint_cp_diff_stats_chunked(torch.tensor(t), torch.tensor(p), equation,
                                            t_block=4)
    want = jsk.mhd_joint_cp_diff_stats_chunked(jnp.asarray(t), jnp.asarray(p), equation,
                                               t_block=4, interpret=True)
    _assert_diff_stats(got, want)
    # K3's outputs are K1's
    for a, b in zip(got, K.mhd_joint_cp_diff_stats(torch.tensor(t), torch.tensor(p), equation)):
        assert torch.equal(a, b)


def test_wave_chunked_matches_cppre():
    t, p = _pair(6, (3, 11, 16, 24))
    got = K.wave_joint_cp_diff_stats_chunked(torch.tensor(t), torch.tensor(p), WAVE_KERNEL,
                                             t_block=4)
    want = jsk.wave_joint_cp_diff_stats_chunked(jnp.asarray(t), jnp.asarray(p), WAVE_KERNEL,
                                                t_block=4, interpret=True)
    _assert_diff_stats(got, want)
    wide = np.zeros((5, 5, 5), np.float32)
    wide[2, 2, 2] = 1.0
    for fn in (K.wave_joint_cp_diff_stats_chunked, K.wave_joint_cp_diff_stats_chunked_plain):
        with pytest.raises(ValueError, match="3-wide"):
            fn(torch.tensor(t), torch.tensor(p), wide)


def test_chunk_t_block_fits_shared_memory():
    """t_block is cut to at most 8 frames, the interior's length, and what
    fits 227 KB of shared memory: 2 slots x 2 tensors x nvar x (t_block + 2)
    frames of a 10 x 34 window, as cppre cuts its t_block to fit VMEM."""
    assert sk._chunk_t_block(5, 3, 19) == 5
    assert sk._chunk_t_block(5, 6, 19) == 5          # 228 480 B of 232 448
    assert sk._chunk_t_block(8, 6, 19) == 5
    assert sk._chunk_t_block(20, 1, 24) == 8
    assert sk._chunk_t_block(5, 3, 2) == 2
    with pytest.raises(ValueError):
        sk._chunk_t_block(0, 3, 19)
    with pytest.raises(ValueError):
        sk._chunk_t_block(1, 15, 19)                  # 15 variables do not fit


def test_routing_decision_is_a_pure_function_of_the_shape():
    """K1 at every shape timed on the card: the flagship K1 shapes and the
    grid-scaling shapes (scripts/bench_scaling.py), whatever `has_chunked`
    and the output shape say."""
    for shape in [(12, 3, 21, 512, 512), (25, 6, 21, 256, 256), (12, 1, 26, 512, 512),
                  (100, 3, 21, 100, 100), (1000, 1, 20, 64, 64), (100, 6, 20, 128, 128)]:
        assert K.routing_decision(shape) == "paired"
        assert K.routing_decision(shape, has_chunked=False) == "paired"
    assert K.routing_decision((12, 1, 26, 512, 512), out_shape=(22, 508, 508)) == "paired"


@pytest.mark.parametrize("route", ["paired", "chunked"])
@pytest.mark.parametrize("diff_dtype", [None, torch.bfloat16])
def test_routed_scores_equal_the_k1_route(monkeypatch, route, diff_dtype):
    """The routed diff-stats and scores follow `routing_decision`; through
    either route they equal K1's (on the CPU both take the plain version),
    the bfloat16 cast applied after K3. A wave kernel wider than 3 has no
    chunked instance and stays on K1."""
    monkeypatch.setattr(sk, "routing_decision", lambda shape, out_shape=None,
                        has_chunked=True: route if has_chunked else "paired")
    t, p = _pair(7, (3, 3, 6, 12, 20))
    tt, tp = torch.tensor(t), torch.tensor(p)
    res = sk._ns_cell(*ARGS, 1e-3)
    d1, s1, q1, m1 = sk._joint_cp_diff_stats(tt, tp, res, diff_dtype=diff_dtype, centred=True)
    routed = K.ns_joint_cp_diff_stats(tt, tp, *ARGS, 1e-3, diff_dtype=diff_dtype)
    assert routed[0].dtype == (diff_dtype or torch.float32)
    for a, b in zip(routed, (d1, s1, q1)):
        assert torch.equal(a, b)
    scores = K.ns_joint_cp_scores_fused(tt, tp, *ARGS, 1e-3, diff_dtype=diff_dtype)
    assert torch.equal(scores, sk._scores_from_diff_stats(d1, m1, 3, 1e-6))
    assert torch.equal(scores, K.ns_joint_cp_scores_plain(tt, tp, *ARGS, 1e-3,
                                                          diff_dtype=diff_dtype))
    wide = np.zeros((5, 5, 5), np.float32)
    wide[2, 2, 2], wide[0, 2, 2] = 1.0, -0.5
    w = torch.tensor(t[:, 0])
    assert torch.equal(K.wave_joint_cp_scores_fused(w, w + 0.1, wide),
                       K.wave_joint_cp_scores_plain(w, w + 0.1, wide))
