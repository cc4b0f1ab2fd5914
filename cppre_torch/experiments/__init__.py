"""CP experiments, one module per PDE family (`ns`, `wave`, `mhd`, `jorek`
over the shared 2-D engine `base2d.run_2d_cp`; `advection`, `burgers`;
`gs`, Grad-Shafranov),
the offline `Expts_initial` pipelines (`initial`), active learning
(`al_advection`, `al_more`), physics-informed training (`pi_advection`,
`pi_wave`), the CP engine (`pipeline`) and the smoke run of every
pipeline (`run_all`).

The family modules load on first access (`cppre_torch.experiments.jorek`),
so `python -m cppre_torch.experiments.<family>` runs each as a script.
"""

import importlib

from .common import latin_hypercube, stacked_fields, unstack_fields

_FAMILIES = ("advection", "al_advection", "al_more", "burgers", "gs", "initial", "jorek",
             "mhd", "ns", "pi_advection", "pi_wave", "pipeline", "run_all", "wave")
__all__ = list(_FAMILIES) + ["latin_hypercube", "stacked_fields", "unstack_fields"]


def __getattr__(name):
    if name in _FAMILIES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
