from .inductive import (
    calibrate,
    cp_quantile_level,
    emp_cov,
    emp_cov_joint,
    filter_sims_joint,
    filter_sims_within_bounds,
    modulation_func,
    ncf_metric_joint,
)

__all__ = [
    "calibrate",
    "cp_quantile_level",
    "emp_cov",
    "emp_cov_joint",
    "filter_sims_joint",
    "filter_sims_within_bounds",
    "modulation_func",
    "ncf_metric_joint",
]
