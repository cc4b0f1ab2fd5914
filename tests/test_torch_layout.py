"""The port's layout against cppre's: every module of `cppre` has a
`cppre_torch` module of the same path exporting the same public names,
and the port imports nothing of JAX or of `cppre`.

The only gaps allowed:
* modules given no port: `utils/{torch_compat,tpu_bench,jax_cache}.py`;
* `ops/pallas/*` pairs with `ops/kernels/*`, less the TPU VMEM estimates.
"""

import importlib
import pathlib
import pkgutil
import re

import pytest

import cppre

ROOT = pathlib.Path(__file__).resolve().parents[1]

WAITING = ()
NO_PORT = ("cppre.utils.torch_compat", "cppre.utils.tpu_bench", "cppre.utils.jax_cache")
# names whose module waits or has no port, re-exported by a package
NAME_GAPS = {
    "cppre.utils": {"fno_params_from_torch", "load_torch_fno"},
    "cppre.ops.pallas": {"single_pass_fits"},
    "cppre.ops.pallas.fno_block": {"fused_block_vmem_est", "fused_block_bwd_vmem_est"},
}


def _modules():
    names = [m.name for m in pkgutil.walk_packages(cppre.__path__, "cppre.")]
    return ["cppre"] + sorted(n for n in names if not n.startswith(WAITING + NO_PORT))


def _port_name(name):
    return "cppre_torch" + name[len("cppre"):].replace(".ops.pallas", ".ops.kernels")


@pytest.mark.parametrize("name", _modules())
def test_every_module_has_its_port_with_the_same_names(name):
    ref = importlib.import_module(name)
    port = importlib.import_module(_port_name(name))
    want = set(getattr(ref, "__all__", ())) - NAME_GAPS.get(name, set())
    missing = want - set(getattr(port, "__all__", ()))
    assert not missing, f"{_port_name(name)} lacks {sorted(missing)}"
    for n in want:
        assert hasattr(port, n), f"{_port_name(name)}.{n} is listed but not defined"


def test_waiting_modules_are_still_missing():
    """No module waits for a later slice; the modules given no port stay
    absent."""
    assert WAITING == ()
    for name in NO_PORT:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(_port_name(name))


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|optax|cppre)(?:[.\s,]|$)", re.M)
_DYNAMIC = re.compile(r"import_module\(\s*[\"'](jax|flax|optax|cppre)(?:[.\"'])")


def test_the_port_imports_no_jax_and_no_cppre():
    files = sorted((ROOT / "cppre_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 80
    bad = []
    for f in files:
        text = f.read_text()
        for m in list(_IMPORT.finditer(text)) + list(_DYNAMIC.finditer(text)):
            line = text.count("\n", 0, m.start()) + 1
            bad.append(f"{f.relative_to(ROOT)}:{line}: {m.group(0).strip()}")
    assert not bad, bad
