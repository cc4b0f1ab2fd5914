"""The plain reference agrees with the program's CPU path at a tiny size, for
each entry a cell drives; and it imports nothing of the program."""

import pytest
import torch

from portbench import core, fields
from portbench.reference import cp as ref_cp
from portbench.reference import fno as ref_fno
from portbench.reference import ns_momentum, train as ref_train, wave
from portbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("name", ["ns-serve", "wave-serve"])
@pytest.mark.parametrize("served", [True, False])
def test_fno_forward_matches_port(name, served):
    from cppre_torch.models import make_fused_apply
    from portbench.clients import surrogate

    cell = tiny_cell(name)
    c = cell.config
    w = surrogate.weights(cell, 3, CPU, served=served)
    model = surrogate.port_model(cell, w, CPU).eval()
    x = torch.rand((3, c["Variables"], c["Nx"], c["Ny"], c["T_in"]),
                   generator=torch.Generator().manual_seed(0))
    ref = ref_fno.forward(w, x, c)
    with torch.no_grad():
        assert _rel(model(x), ref) < 1e-5
        assert _rel(make_fused_apply(model)(x), ref) < 1e-5


def test_residuals_match_port():
    from cppre_torch.ops.kernels import ns_momentum_residual_fused, wave_residual_fused
    from cppre_torch.residuals.wave import PRE_Wave

    g = torch.Generator().manual_seed(1)
    f = torch.randn((2, 3, 6, 9, 8), generator=g)
    r = {"dt": 0.01, "dx": 0.01, "dy": 0.02, "nu": 1e-3}
    assert _rel(ns_momentum_residual_fused(f, 0.01, 0.01, 0.02, 1e-3),
                ns_momentum.residual(f, r)) < 1e-6
    r = {"dt": 0.05, "dx": 0.03125, "c": 1.0}
    k = PRE_Wave(r["dt"], r["dx"], c=r["c"]).D.kernel
    assert _rel(wave_residual_fused(f[:, 0], k), wave.residual(f[:, :1], r)) < 1e-5


def test_joint_cp_matches_port():
    from cppre_torch.cp.inductive import calibrate, modulation_func, ncf_metric_joint

    for n in (7, 100, 1000):
        res = torch.randn((n, 3, 4, 5), generator=torch.Generator().manual_seed(n))
        mod = modulation_func(res, None)
        q = calibrate(ncf_metric_joint(res, None, mod), n, 0.1)
        q_ref, mod_ref = ref_cp.calibrate(res, 0.1)
        assert _rel(mod, mod_ref.float()) < 1e-6
        assert abs(float(q) - float(q_ref)) / float(q_ref) < 1e-6


def test_train_steps_match_port():
    from cppre_torch.models import make_fused_train_apply
    from cppre_torch.train.loops import make_optimizer, make_train_step
    from cppre_torch.train.losses import lp_loss
    from portbench.clients import surrogate

    cell = tiny_cell("wave-train")
    c = cell.config
    w = surrogate.weights(cell, 5, CPU, served=False)
    model = surrogate.port_model(cell, w, CPU).train()
    g = torch.Generator().manual_seed(2)
    xx = torch.rand((4, 1, c["Nx"], c["Ny"], 1), generator=g)
    yy = torch.rand((4, 1, c["Nx"], c["Ny"], c["T_out"]), generator=g)
    opt = make_optimizer(model.parameters(), 0.005, grad_clip=2.0)
    step = make_train_step(make_fused_train_apply(model), opt, 1, c["T_out"], lp_loss)
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref_opt = ref_train.Adam(p, 0.005, 2.0)
    for _ in range(2):
        loss, _ = step(xx, yy)
        ref_loss = ref_train.rollout_loss(p, xx, yy, c)
        ref_opt.step(dict(zip(p, torch.autograd.grad(ref_loss, list(p.values())))))
        ref_loss = float(ref_loss.detach())
        assert abs(float(loss) - ref_loss) / ref_loss < 1e-5
    for k, v in model.named_parameters():
        assert _rel(v.detach(), p[k].detach()) < 1e-4, k


def test_tf32_rounds_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0])
    from portbench.reference.precision import tf32

    assert tf32(x, True).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0]
    assert tf32(x, False) is x


def test_weights_are_seeded_at_the_init_scale():
    specs = ref_fno.param_specs({"Width_time": 4, "Variables": 1, "Modes": 2, "T_in": 1,
                                 "Step": 1})
    a = fields.weights(9, specs, CPU)
    b = fields.weights(9, specs, CPU)
    s = fields.weights(9, specs, CPU, symmetric=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(s["fc1_time.weight"], a["fc1_time.weight"])
    assert float(a["fc1_time.weight"].abs().max()) <= 1 / 2
    assert float(a["f0.conv.weights1"].real.min()) >= 0
    assert float(s["f0.conv.weights1"].real.min()) < 0
    assert float(s["f0.conv.weights1"].real.abs().max()) <= 1 / 4


def test_reference_imports_nothing_of_the_program(tmp_path):
    assert core.reference_imports() == []
    ref = tmp_path / "reference"
    ref.mkdir()
    (ref / "bad.py").write_text("import cppre_torch.models\nfrom jax import numpy\n")
    assert len(core.reference_imports(tmp_path)) == 2


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    import sys
    import types

    assert "cppre" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cppre_torch_x", types.ModuleType("cppre_torch_x"))
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cppre.ops", types.ModuleType("cppre.ops"))
    assert core.forbidden_modules() == ["cppre"]
