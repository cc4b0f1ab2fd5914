"""The port's parallel layer (`cppre_torch.parallel`, `mesh=`) against cppre
and against the port's unsharded functions.

The port runs SPMD, so its side runs in spawned gloo ranks (2, 3 and 4
ranks over FileStores under the test's tmp dir; `tests/torch_ranks.py`,
torch on one thread, no JAX), kept up for the whole file; cppre's side runs
here on conftest's 8 virtual CPU devices. Inputs are made from seeds with
numpy; FNO weights are drawn by the port and carried into flax by cppre's
importer. Tolerances, each cppre's own gate where it has one:
* sharded_calibrate: equal to `calibrate` (the port's and cppre's) exactly;
* sharded_fused_cp_scores: 2e-5 relative to the port's unsharded scores
  (the ranks' moments combine in another order), 2e-4 to cppre's (its
  one-pass variance);
* the halo stencils: bit for bit against the port's `direct_conv`, 1e-6
  (1-D) and 1e-5 (2-D) against cppre's;
* the sharded FFT: 1e-4 against numpy's fft2 and cppre's, the round trip
  1e-5; the spectral convolution 1e-4 against a roll-sum oracle;
* make_pp_fno_apply: 5e-6 against cppre's `model.apply`, the input
  gradient 2e-5 against `jax.grad`;
* the train step on dp = 2: loss 1e-6 and weights 1e-5 relative to the
  unsharded step (a two-part gradient sum);
* run_2d_cp and CalibratedSurrogate with mesh=: equal to the unsharded run;
  evaluate_uq_methods: L2 1e-6 relative, coverages equal.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cppre.models import FNO2d as JFNO2d
from cppre.ops.pallas import stencil_kernels as jsk
from cppre.ops.stencils import embed_kernel_3d, stencil_time_space
from cppre.parallel import (fft2_sharded as j_fft2_sharded, fno_param_shardings as j_shardings,
                            make_mesh as j_make_mesh, stencil_conv_sharded as j_halo,
                            stencil_conv_sharded_2d as j_halo_2d)
from cppre.cp import calibrate as j_calibrate
from cppre.utils import fno_params_from_torch
from cppre_torch.cp import calibrate
from cppre_torch.models import FNO2d
from cppre_torch.ops.convops import direct_conv
from cppre_torch.ops.kernels import stencil_kernels as sk
from cppre_torch.parallel import multihost
from cppre_torch.uq.eval import evaluate_uq_methods
from torch_ranks import World

DT = DX = DY = 0.01


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{n: World(n)}: the three worlds start at once (their ranks' imports
    overlap), and close at the end of the file."""
    root = str(tmp_path_factory.mktemp("ranks"))
    started = {n: World(n, root) for n in (2, 3, 4)}

    def get(n):
        return started[n]

    yield get
    for w in started.values():
        w.close()


def _rng(seed):
    return np.random.default_rng(seed)


def _j_mesh(shape, names):
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


# ---- mesh and calibration --------------------------------------------------

def test_mesh_axes_coordinates_and_device(worlds):
    got = worlds(4).call("mesh_shape", 2, 2)
    assert [g[0] for g in got] == [{"dp": 2, "tp": 2}] * 4
    assert [(g[1], g[2]) for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert {g[3] for g in got} == {"cpu"}


@pytest.mark.parametrize("n_cal", [37, 100, 104, 400])
@pytest.mark.parametrize("alpha", [0.05, 0.1, 0.5, 0.9])
def test_sharded_calibrate_exact_uneven_shards(worlds, n_cal, alpha):
    rng = _rng(n_cal * 7 + int(alpha * 100))
    for shape in [(n_cal,), (n_cal, 5, 3)]:
        scores = rng.random(shape).astype(np.float32)
        want = calibrate(torch.from_numpy(scores), n_cal, alpha).numpy()
        np.testing.assert_array_equal(want, np.asarray(j_calibrate(jnp.asarray(scores), n_cal,
                                                                   alpha)))
        for whole, split in worlds(4).call("calibrate", scores, alpha, 4):
            np.testing.assert_array_equal(whole, want)
            np.testing.assert_array_equal(split, want)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 70), alpha=st.floats(0.01, 0.99), seed=st.integers(0, 2**16))
def test_sharded_calibrate_property(worlds, n, alpha, seed):
    """Any n (fewer than the ranks too: empty blocks) and alpha: exact."""
    scores = _rng(seed).random((n, 2)).astype(np.float32)
    want = calibrate(torch.from_numpy(scores), n, alpha).numpy()
    for whole, split in worlds(4).call("calibrate", scores, alpha, 4):
        np.testing.assert_array_equal(whole, want)
        np.testing.assert_array_equal(split, want)


# ---- joint-CP scores over K1's diff stats -----------------------------------

def _pair(n, seed=23, shape=(3, 9, 16, 24)):
    rng = _rng(seed)
    t = rng.standard_normal((n,) + shape).astype(np.float32)
    return t, t + 0.01 * rng.standard_normal(t.shape).astype(np.float32)


@pytest.mark.parametrize("dp,centred", [(2, False), (4, False), (4, True)])
def test_sharded_cp_scores_match_unsharded_and_cppre(worlds, dp, centred):
    t, p = _pair(16)
    ref = sk.ns_joint_cp_scores_fused(torch.from_numpy(t), torch.from_numpy(p), DT, DX, DY,
                                      eps=1e-6).numpy()
    j_ref = np.asarray(jsk.ns_joint_cp_scores_fused(jnp.asarray(t), jnp.asarray(p), DT, DX, DY))
    for scores, rows, q in worlds(dp).call("cp_scores", t, p, dp, centred=centred):
        assert rows == 16 // dp
        np.testing.assert_allclose(scores, ref, rtol=2e-5)
        np.testing.assert_allclose(scores, j_ref, rtol=2e-4)
        np.testing.assert_array_equal(q, calibrate(torch.from_numpy(scores), 16, 0.1).numpy())


@pytest.mark.parametrize("n", [5, 13])
def test_sharded_cp_scores_uneven_batch(worlds, n):
    """No rank pads: blocks of 2, 2, 1, 0 (n = 5) and 4, 4, 4, 1 (n = 13)
    rows, and the combined centred moments give the unsharded scores."""
    t, p = _pair(n, seed=n, shape=(3, 5, 8, 8))
    ref = sk.ns_joint_cp_scores_fused(torch.from_numpy(t), torch.from_numpy(p), DT, DX, DY,
                                      eps=1e-6).numpy()
    got = worlds(4).call("cp_scores", t, p, 4, centred=True)
    assert [g[1] for g in got] == ([2, 2, 1, 0] if n == 5 else [4, 4, 4, 1])
    for scores, _, _ in got:
        assert scores.shape == (n,)
        np.testing.assert_allclose(scores, ref, rtol=2e-5)


# ---- halo stencils -------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("domain_axis", [0, 2])
def test_halo_stencil_matches_direct_conv_and_cppre(worlds, n, domain_axis):
    field = _rng(0).standard_normal((2, 6, 64, 32)).astype(np.float32)
    k = np.asarray(embed_kernel_3d(stencil_time_space(2, 2), domain_axis))
    ref = direct_conv(torch.from_numpy(field), k).numpy()
    j_ref = np.asarray(jax.jit(lambda f: j_halo(f, k, _j_mesh((n,), ("sp",)), axis="sp"))(
        jnp.asarray(field)))
    for got in worlds(n).call("halo", field, k, n):
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(got, j_ref, atol=1e-6)


def test_halo_stencil_2d_corner_taps(worlds):
    rng = _rng(2)
    field = rng.standard_normal((2, 6, 32, 16)).astype(np.float32)
    k = rng.standard_normal((3, 3, 3)).astype(np.float32)
    ref = direct_conv(torch.from_numpy(field), k).numpy()
    j_ref = np.asarray(jax.jit(lambda f: j_halo_2d(f, k, _j_mesh((2, 2), ("spx", "spy")),
                                                   axes=("spx", "spy")))(jnp.asarray(field)))
    for got, block in worlds(4).call("halo_2d", field, k, 2, 2):
        assert block == (2, 6, 16, 8)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(got, j_ref, atol=1e-5)


def test_halo_wider_than_shard_rejected(worlds):
    k = np.zeros((7, 7, 7), np.float32)
    k[3, 3, 3] = 1.0
    for msg in worlds(4).call("halo_too_wide", np.ones((1, 4, 8, 8), np.float32), k, 4):
        assert msg is not None and "halo" in msg


# ---- sharded FFT ---------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_fft2_sharded_roundtrip_and_parity(worlds, n):
    x = _rng(3).standard_normal((3, 32, 16)).astype(np.float32)
    j_X = np.asarray(jax.jit(lambda a: j_fft2_sharded(a, _j_mesh((n,), ("sp",)), axis="sp"))(
        jnp.asarray(x)))
    for X, back, x_block, back_block in worlds(n).call("fft", x, n):
        assert X.dtype == np.complex64 and x_block == (3, 32, 16 // n)
        assert back_block == (3, 32 // n, 16)
        np.testing.assert_allclose(X, np.fft.fft2(x), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(X, j_X, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(back.real, x, atol=1e-5)


def test_spectral_circular_conv_sharded(worlds):
    rng = _rng(4)
    field = rng.standard_normal((2, 32, 16)).astype(np.float32)
    kernel = rng.standard_normal((3, 3)).astype(np.float32)
    ref = np.zeros_like(field)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            ref += kernel[1 + di, 1 + dj] * np.roll(field, (-di, -dj), axis=(-2, -1))
    for got in worlds(4).call("spectral_conv", field, kernel, 4):
        np.testing.assert_allclose(got, ref, atol=1e-4)


# ---- pipeline, tensor-parallel layout, training -------------------------------

def _fno_pair(cfg=(1, 1, 4, 4, 1, 8), nx=16, seed=1):
    """(flax model, flax variables, the port's state dict and cfg), one set
    of weights drawn by the port."""
    t_in, step, m1, m2, nv, w = cfg
    jm = JFNO2d(T_in=t_in, step=step, modes1=m1, modes2=m2, num_vars=nv, width_time=w)
    model = FNO2d(*cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, nv, nx, nx, t_in), jnp.float32))
    v = jax.device_get(fno_params_from_torch(model.state_dict(), template))
    return jm, v, {k: t.numpy() for k, t in model.state_dict().items()}, cfg


@pytest.mark.parametrize("pp", [2, 3])
def test_pp_fno_forward_matches_cppre(worlds, pp):
    jm, v, state, cfg = _fno_pair()
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 1, 16, 16, 1)))
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    for out, _ in worlds(pp).call("pp", state, cfg, x, 1, pp):
        np.testing.assert_allclose(out, ref, atol=5e-6)


def test_pp_fno_dp_uneven_batch_and_input_grad(worlds):
    jm, v, state, cfg = _fno_pair()
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (5, 1, 16, 16, 1)))
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    g_ref = np.asarray(jax.jit(jax.grad(lambda xx: jnp.sum(jm.apply(v, xx) ** 2)))(
        jnp.asarray(x)))
    for out, grad in worlds(4).call("pp", state, cfg, x, 2, 2, grad=True):
        np.testing.assert_allclose(out, ref, atol=5e-6)
        np.testing.assert_allclose(grad, g_ref, atol=2e-5)


def _port_name(flax_key):
    """cppre's keystr of an FNO2d leaf -> the port's state-dict name."""
    parts = re.findall(r"\['([^']+)'\]", flax_key)[1:]
    if parts[0].startswith("fc"):
        return f"{parts[0]}.{'weight' if parts[1] == 'kernel' else 'bias'}"
    blk, mod = parts[0], parts[1]
    if mod == "SpectralConv2d_0":
        return f"{blk}.conv.{parts[2][:8]}"
    sub = {("_ChannelMLP_0", "Dense_0"): "mlp.mlp1", ("_ChannelMLP_0", "Dense_1"): "mlp.mlp2",
           ("_Channel1x1_0", "Dense_0"): "w", ("_Channel1x1_1", "Dense_0"): "b"}[mod, parts[2]]
    return f"{blk}.{sub}.{'weight' if parts[3] == 'kernel' else 'bias'}"


@pytest.mark.parametrize("width,step", [(16, 1), (6, 3)])
def test_fno_param_shardings_report_matches_cppre(worlds, width, step):
    """The same sharded/replicated decision for every parameter as cppre's
    for its flax counterparts (out channels at the port's own dims)."""
    cfg = (1, step, 4, 4, 3, width)
    _, v, _, _ = _fno_pair(cfg)
    _, j_log = j_shardings(v, j_make_mesh(8, dp=4, tp=2), report=True)
    log = worlds(4).call("param_report", cfg, 2, 2)[0]
    want = {}
    for key, decision in j_log.items():
        want.setdefault(_port_name(key), set()).add(decision.split("(")[0])
    assert set(want) == set(log)
    for name, decision in log.items():
        assert want[name] == {decision.split("(")[0]}, name
    assert any(d.startswith("replicated(out") for d in log.values()) == (width % 2 == 1 or
                                                                           step % 2 == 1)


def test_sharded_train_step_matches_unsharded(worlds):
    _, _, state, cfg = _fno_pair(seed=5)
    rng = _rng(6)
    xx = rng.standard_normal((4, 1, 16, 16, 1)).astype(np.float32)
    yy = rng.standard_normal((4, 1, 16, 16, 3)).astype(np.float32)
    for (loss, full, weights), (loss1, full1, weights1) in worlds(2).call(
            "train_step", state, cfg, xx, yy, 2):
        np.testing.assert_allclose(loss, loss1, rtol=1e-6)
        np.testing.assert_allclose(full, full1, rtol=1e-6)
        assert any(not np.array_equal(weights[k], state[k]) for k in state)
        for k in weights:
            np.testing.assert_allclose(weights[k], weights1[k], rtol=1e-5, atol=1e-7)


# ---- multihost -----------------------------------------------------------------

def test_multihost_initialize_plumbing(monkeypatch):
    """Arguments forwarded to init_process_group, the single-process no-op,
    benign double initialisation swallowed, anything else surfaced."""
    import torch.distributed as dist

    calls = []

    def fake_init(backend, init_method=None, world_size=-1, rank=-1):
        calls.append((backend, init_method, world_size, rank))

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    multihost.initialize(num_processes=1)
    assert calls == []
    multihost.initialize("10.0.0.1:1234", 4, 2)
    assert calls == [("nccl", "tcp://10.0.0.1:1234", 4, 2)]
    multihost.initialize("10.0.0.1:1234", 4, 2, device_type="cpu")
    assert calls[-1] == ("gloo", "tcp://10.0.0.1:1234", 4, 2)

    def raising(exc):
        def init(*a, **k):
            raise exc
        return init

    monkeypatch.setattr(dist, "init_process_group",
                        raising(RuntimeError("trying to initialize the default process group "
                                             "twice: already initialized")))
    multihost.initialize("10.0.0.1:1234", 4, 2)
    monkeypatch.setattr(dist, "init_process_group",
                        raising(RuntimeError("coordinator unreachable")))
    with pytest.raises(RuntimeError, match="unreachable"):
        multihost.initialize("10.0.0.1:1234", 4, 2)
    monkeypatch.setattr(dist, "init_process_group",
                        raising(ValueError("bad coordinator address")))
    with pytest.raises(ValueError, match="bad coordinator"):
        multihost.initialize("not-an-address", 4, 2)
    multihost.initialize()   # no explicit arguments: a single process, a no-op


# ---- mesh= in the entry points -----------------------------------------------

def test_run_2d_cp_mesh_matches_unsharded(worlds):
    """wave.run(mesh=) at dp = 2, n_cal + n_pred = 35 (uneven), on the
    unsharded run's trained weights: the same qhat and coverages."""
    for r1, r2 in worlds(2).call("run_2d_cp", 2):
        np.testing.assert_allclose(r2["qhat"], r1["qhat"], rtol=1e-5)
        for k in ("coverage_aer_pre", "coverage_pre", "coverage_aer_pre_holdout"):
            np.testing.assert_array_equal(r2[k], r1[k])
        np.testing.assert_array_equal(r2["pred_pred"], r1["pred_pred"])


def test_calibrated_surrogate_mesh_matches_unsharded(worlds, tmp_path):
    _, _, state, _ = _fno_pair(cfg=(1, 1, 4, 4, 3, 8))
    results = worlds(2).call("surrogate", state, (1, 1, 4, 4, 3, 8), 2, str(tmp_path))
    for plain, sharded, loaded in results:
        for a, b in ((plain, sharded), (plain, loaded)):
            np.testing.assert_allclose(b[0], a[0], rtol=1e-6)        # qhat
            np.testing.assert_allclose(b[1], a[1], rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(b[2], a[2], rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(b[3], a[3])


def test_evaluate_uq_methods_mesh_matches_unsharded(worlds):
    _, _, state, _ = _fno_pair(cfg=(1, 1, 4, 4, 3, 8))
    for plain, sharded in worlds(2).call("uq", state, (1, 1, 4, 4, 3, 8), 2,
                                         ["Deterministic", "PRE"]):
        for method in ("Deterministic", "PRE"):
            np.testing.assert_allclose(sharded[method]["l2"], plain[method]["l2"], rtol=1e-6)
            assert sharded[method]["coverage"] == plain[method]["coverage"]
            assert sharded[method]["joint_coverage"] == plain[method]["joint_coverage"]


def test_evaluate_uq_methods_mesh_refuses_batch_chunk():
    with pytest.raises(ValueError, match="exclusive"):
        evaluate_uq_methods(methods=["PRE"], model_factory=None, test_a=np.zeros((2, 1)),
                            test_u=np.zeros((2, 1)), step=1, T_out=1, batch_chunk=1,
                            mesh=object())
