"""UQ comparison entry point (port of `cppre.uq.run_eval`):
``python -m cppre_torch.uq.run_eval Wave [config.yaml]``.

Load the YAML config (the port's copy under `uq/configs/`), build the
case's data and PRE, train (or load) each UQ variant, then run the
bootstrap comparison protocol (`uq.eval.evaluate_uq_methods`). Entries of
`Runs:` name checkpoints written by `cppre_torch.utils.checkpoint`; missing
ones train in-script.

Training: the dropout-free variants (the base FNO behind Deterministic,
AER and PRE, the ensemble members, SWAG, MLE and the Bayesian body) train
through `models.fused.make_fused_train_apply`, kernels K4-K7 on the card;
the dropout FNO trains through its own forward (deterministic, as in
cppre). Everything runs on `device`, the card unless the caller asks for
the CPU. `Train Precision` other than "highest" is refused.
"""

from __future__ import annotations

import os

import torch

from ..models import FNO2d, make_fused_train_apply
from ..models.swag import SWAG
from ..models.variants import FNO2dBayesian, make_dropout_fno, make_mle_fno
from ..train.loops import fit, make_optimizer
from ..train.losses import lp_loss
from ..train.normalizers import MinMaxNormalizer
from ..utils.checkpoint import checkpoint_name, load_checkpoint, save_checkpoint
from ..utils.config import load_config
from . import data_loaders
from .eval import evaluate_uq_methods
from .train import fit_swag, make_bayesian_train_step, make_mle_train_step

__all__ = ["run"]

_CASES = {"Wave": data_loaders.load_wave, "Navier-Stokes": data_loaders.load_ns,
          "MHD": data_loaders.load_mhd}


def _fit_generic(model, apply_fn, a, u, cfg, make_step, seed=0, draws=False):
    """Train `model` in place with `make_step(apply_fn, optimizer, step,
    T_out)`'s steps over epochs of whole minibatches; a CPU generator
    seeded with `seed` orders them, and with `draws` a generator on the
    data's device seeded with seed + 1 feeds each step's draws."""
    T_out, step = cfg["T_out"], cfg["Step"]
    bs = min(cfg["Batch Size"], a.shape[0])
    opt = make_optimizer(model.parameters(), cfg["Learning Rate"], cfg["Scheduler Step"],
                         cfg["Scheduler Gamma"], max(a.shape[0] // bs, 1))
    train_step = make_step(apply_fn, opt, step, T_out)
    gen = torch.Generator().manual_seed(seed)
    draw_gen = torch.Generator(device=a.device).manual_seed(seed + 1) if draws else None
    for _ in range(cfg["Epochs"]):
        perm = torch.randperm(a.shape[0], generator=gen).to(a.device)
        for i in range(0, a.shape[0] - bs + 1, bs):
            idx = perm[i:i + bs]
            args = (a[idx], u[idx]) + ((draw_gen,) if draws else ())
            train_step(*args)
    return model


def run(case: str = "Wave", config_path: str | None = None, overrides: dict | None = None,
        verbose: bool = True, on_method_done=None, skip=(), device="cuda", case_data=None):
    """The comparison on `case` ("Wave", "Navier-Stokes" or "MHD"): returns
    `evaluate_uq_methods`' {method: stats}. `case_data` is the case's
    in-distribution (data, pre, sim_cfg) as its `data_loaders` loader
    returns it for the config's n_total and Seed, so that runs of one case
    (other methods, `Dist: out`) share one simulation; None simulates it."""
    cfg_file = config_path or os.path.join(
        os.path.dirname(__file__), "configs",
        f"{'NS' if case == 'Navier-Stokes' else case}_FNO.yaml")
    cfg = load_config(cfg_file)
    cfg.update(overrides or {})
    seed = cfg.get("Seed", 0)
    train_prec = cfg.get("Train Precision", "highest")
    if train_prec != "highest":
        raise NotImplementedError(
            f"Train Precision {train_prec!r} waits for the port's training options (ROADMAP "
            f"Queue 1 item 8); the port trains in full float32 ('highest')")

    # The in-distribution data always backs training, the normalizers and
    # the PRE's physics; `Dist` selects only the evaluation data.
    dist = cfg.get("Dist", "in")
    data, pre, sim_cfg = case_data or _CASES[case]("in", n=cfg.get("n_total", 60), seed=seed,
                                                   device=device)
    cfg = {**sim_cfg, **cfg}
    T_in, T_out, step = cfg["T_in"], cfg["T_out"], cfg["Step"]
    a_all, u_all = data[..., :T_in], data[..., T_in:T_in + T_out]
    norm_in, norm_out = MinMaxNormalizer(a_all), MinMaxNormalizer(u_all)
    a_all, u_all = norm_in.encode(a_all), norm_out.encode(u_all)
    n_train = cfg.get("n_train_eval", data.shape[0] // 2)
    tr_a, tr_u = a_all[:n_train], u_all[:n_train]
    if dist == "out":
        # the shifted-physics eval pool, encoded with the in-dist normalizers
        n_pool = cfg.get("n_eval_pool", cfg.get("n_total", 60) - n_train)
        data_out, _, _ = _CASES[case]("out", n=n_pool, seed=seed, device=device)
        te_a = norm_in.encode(data_out[..., :T_in])
        te_u = norm_out.encode(data_out[..., T_in:T_in + T_out])
    else:
        te_a, te_u = a_all[n_train:], u_all[n_train:]
        # `n_eval_extra`: fresh in-dist sims at disjoint seeds appended to
        # the eval pool only, generated in chunks of `n_eval_extra_chunk`
        # (whose size is part of the protocol: the chunk seeds follow it)
        n_extra = int(cfg.get("n_eval_extra", 0) or 0)
        chunk = int(cfg.get("n_eval_extra_chunk", 100) or n_extra or 1)
        off = 0
        while off < n_extra:
            m = min(chunk, n_extra - off)
            data_x, _, _ = _CASES[case]("in", n=m, seed=seed + 7919 + off, device=device)
            te_a = torch.cat([te_a, norm_in.encode(data_x[..., :T_in])])
            te_u = torch.cat([te_u, norm_out.encode(data_x[..., T_in:T_in + T_out])])
            off += m

    kw = dict(T_in=T_in, step=step, modes1=cfg["Modes"], modes2=cfg["Modes"],
              num_vars=cfg["Variables"], width_time=cfg["Width_time"])
    run_names = cfg.get("Runs") or {}
    bs = min(cfg["Batch Size"], n_train)
    fit_kw = dict(epochs=cfg["Epochs"], batch_size=bs, step=step, T_out=T_out,
                  loss_func=lp_loss, lr=cfg["Learning Rate"])
    init = lambda s: dict(device=device, generator=torch.Generator().manual_seed(s))

    # Trained-weights disk cache (opt-in via `train_cache_dir`), keyed by a
    # fingerprint of every config field that determines the weights; Dist is
    # pinned to "in", since training is always in-distribution.
    cache_dir = cfg.get("train_cache_dir")
    if cache_dir:
        import hashlib
        import json

        fp_src = {k: cfg.get(k) for k in (
            "Case", "Epochs", "Batch Size", "Learning Rate", "Scheduler Step",
            "Scheduler Gamma", "T_in", "T_out", "Step", "Modes", "Width_time", "Variables",
            "Seed", "n_total", "n_train_eval", "Train Precision", "n_ensemble")}
        fp_src["Dist"] = "in"
        fp = hashlib.sha1(json.dumps(fp_src, sort_keys=True, default=str)
                          .encode()).hexdigest()[:12]

    def cache_path(tag):
        return os.path.join(cache_dir, f"uq_{cfg['Case']}_{tag}_{fp}")

    def cached(tag, model, train):
        """`model` with the cached weights of `tag`, else trained by
        `train(model)` and then cached."""
        if cache_dir and os.path.exists(cache_path(tag) + ".pth"):
            if verbose:
                print(f"[train-cache] {tag} <- {cache_path(tag)}.pth", flush=True)
            return load_checkpoint(cache_path(tag), model)
        train(model)
        if cache_dir:
            save_checkpoint(cache_path(tag), model)
        return model

    def fit_fno(model, fit_seed):
        fit(make_fused_train_apply(model), model, tr_a, tr_u, tr_a[-2:], tr_u[-2:],
            seed=fit_seed, **fit_kw)

    memo = {}

    def base_model():
        if "base" not in memo:
            memo["base"] = cached("base", FNO2d(**kw, **init(seed)), lambda m: fit_fno(m, seed))
        return memo["base"]

    def maybe_load(model, uq):
        """Load the checkpoint that `Runs:` names for `uq`, if it exists."""
        name = run_names.get(uq)
        if not name:
            return None
        path = checkpoint_name(cfg.get("Model", "FNO"), cfg["Case"], name)
        if not os.path.exists(path + ".pth"):
            return None
        return load_checkpoint(path, model)

    def model_factory(uq: str):
        if uq in ("Deterministic", "AER", "PRE"):
            loaded = maybe_load(FNO2d(**kw, **init(0)), uq)
            return (loaded if loaded is not None else base_model()), None
        if uq == "Dropout":
            model = make_dropout_fno(**kw, **init(seed))
            return cached("dropout", model,
                          lambda m: fit(m, m, tr_a, tr_u, tr_a[-2:], tr_u[-2:], seed=seed,
                                        **fit_kw)), None
        if uq == "Bayesian":
            model = FNO2dBayesian(**kw, **init(seed))
            make_step = lambda fn, opt, s, t: make_bayesian_train_step(fn, opt, s, t,
                                                                       model=model)
            return cached("bayesian", model, lambda m: _fit_generic(
                m, make_fused_train_apply(m), tr_a, tr_u, cfg, make_step, seed,
                draws=True)), None
        if uq == "MLE":
            model = make_mle_fno(**kw, **init(seed))
            return cached("mle", model, lambda m: _fit_generic(
                m, make_fused_train_apply(m), tr_a, tr_u, cfg, make_mle_train_step,
                seed)), None
        if uq == "Ensemble":
            members = [cached(f"ens{s}", FNO2d(**kw, **init(seed + 100 + s)),
                              lambda m, s=s: fit_fno(m, seed + s))
                       for s in range(cfg.get("n_ensemble", 5))]
            return members[0], members
        if uq == "SWAG":
            model = FNO2d(**kw, **init(seed))
            if cache_dir and os.path.exists(cache_path("swag") + ".npz"):
                if verbose:
                    print(f"[train-cache] swag <- {cache_path('swag')}.npz", flush=True)
                swag = SWAG(model).load(cache_path("swag") + ".npz")
            else:
                swag = fit_swag(make_fused_train_apply(model), model, tr_a, tr_u,
                                seed=seed, **fit_kw)
                if cache_dir:
                    os.makedirs(cache_dir, exist_ok=True)
                    swag.save(cache_path("swag") + ".npz")
            return model, swag
        raise ValueError(f"unknown UQ method {uq}")

    return evaluate_uq_methods(
        methods=[m for m in cfg["UQ"] if m not in set(skip)],
        model_factory=model_factory, test_a=te_a, test_u=te_u, step=step, T_out=T_out,
        alpha=cfg.get("alpha", 0.1), samples=cfg.get("samples", 10), runs=cfg.get("runs", 10),
        n_eval=cfg.get("n_eval", 300), pre=pre, seed=seed, verbose=verbose,
        on_method_done=on_method_done, batch_chunk=cfg.get("batch_chunk"))


if __name__ == "__main__":
    import sys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(sys.argv[1] if len(sys.argv) > 1 else "Wave", sys.argv[2] if len(sys.argv) > 2 else None)
