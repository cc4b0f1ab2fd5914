"""Shared plotting helpers (port of `cppre.utils.plot_tools`).

`subplots_2d`: imshow grid with per-panel colorbars; `subplots_1d`:
per-timestep line plots from a {label: [..., T, X]} dict; `coverage_figure`:
empirical coverage against 1 - alpha; `wall_contour_figure`: the EFIT
residual / error-bar overlay; `save_experiment_artifacts`: an experiment's
figure set. They take tensors (on any device) or arrays. matplotlib is
imported inside the functions, so library use without plots never needs
it; a plot without it raises the ImportError.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["subplots_2d", "subplots_1d", "coverage_figure",
           "wall_contour_figure", "save_experiment_artifacts"]


def _np(x):
    """A tensor or an array-like as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def wall_contour_figure(R, Z, field, qhat, wall=None, levels: int = 10,
                        title: str = "Residual and Error Bar",
                        save_path: str | None = None):
    """EFIT-style residual/error-bar contour overlay on the tokamak
    cross-section: blue contours of the per-cell field (e.g. a prediction
    residual), red contours of the per-cell CP bound qhat, and the tokamak
    wall polyline in black, equal aspect, R/Z axes.

    `field`/`qhat` are [NR, NZ] on the (R, Z) grid (1-D coordinates);
    `wall` is an [N, 2] (R, Z) polyline, by default a D-shaped wall hugging
    the grid's extent."""
    import matplotlib.pyplot as plt

    R, Z = _np(R).reshape(-1), _np(Z).reshape(-1)
    field = _np(field)
    qhat = np.broadcast_to(_np(qhat), field.shape)
    fig, ax = plt.subplots(figsize=(5, 6))
    # contour expects [len(Z), len(R)]: transpose the [NR, NZ] fields
    ax.contour(R, Z, field.T, colors="blue", alpha=0.4, levels=levels)
    ax.contour(R, Z, qhat.T, colors="red", alpha=0.4, levels=levels)
    if wall is None:
        # synthetic D-shaped first wall: elongated, slightly triangular
        r0, z0 = R.mean(), Z.mean()
        a = 0.55 * (R.max() - R.min())
        b = 0.55 * (Z.max() - Z.min())
        th = np.linspace(0, 2 * np.pi, 128)
        wall = np.stack([r0 + a * np.cos(th + 0.3 * np.sin(th)),
                         z0 + b * np.sin(th)], axis=1)
    wall = _np(wall)
    ax.plot(wall[:, 0], wall[:, 1], linewidth=4, color="black", label="tokamak")
    ax.axis("equal")
    ax.set_xlabel("R")
    ax.set_ylabel("Z")
    ax.set_title(title)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


def subplots_2d(values, titles=None, flatten: bool = False, suptitle: str | None = None,
                cmap: str = "viridis", save_path: str | None = None):
    """Grid of imshow panels with colorbars, at most four a row."""
    import matplotlib.pyplot as plt

    values = [_np(v) for v in values]
    n = len(values)
    ncols = min(n, 4)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 3.5 * nrows), squeeze=False)
    for i, v in enumerate(values):
        ax = axes[i // ncols][i % ncols]
        im = ax.imshow(v, cmap=cmap, origin="lower")
        if titles:
            ax.set_title(titles[i])
        fig.colorbar(im, ax=ax, fraction=0.046)
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    if suptitle:
        fig.suptitle(suptitle)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


def subplots_1d(x, values: dict, indices, suptitle: str | None = None,
                save_path: str | None = None):
    """Per-timestep line plots: values = {label: array[..., T, X]} sliced at
    each t in `indices`."""
    import matplotlib.pyplot as plt

    n = len(indices)
    ncols = min(n, 4)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 3 * nrows), squeeze=False)
    for i, t in enumerate(indices):
        ax = axes[i // ncols][i % ncols]
        for label, arr in values.items():
            arr = _np(arr)
            y = arr[t] if arr.ndim >= 2 else arr
            ax.plot(_np(x), y, label=label)
        ax.set_title(f"t = {t}")
        ax.legend(fontsize=7)
    if suptitle:
        fig.suptitle(suptitle)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


def coverage_figure(alphas, coverages: dict, title: str | None = None,
                    save_path: str | None = None):
    """Empirical coverage against 1 - alpha with the ideal diagonal, the
    figure every reference experiment saves. `coverages` maps a legend
    label to a coverage array over `alphas` (None entries are skipped)."""
    import matplotlib.pyplot as plt

    alphas = _np(alphas)
    fig, ax = plt.subplots(figsize=(5, 4.2))
    ideal = 1 - alphas
    ax.plot(ideal, ideal, "k--", label="ideal")
    for label, cov in coverages.items():
        if cov is not None:
            ax.plot(ideal, _np(cov), marker="o", ms=3, label=label)
    ax.set_xlabel("1 - alpha")
    ax.set_ylabel("empirical coverage")
    if title:
        ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


def save_experiment_artifacts(results: dict, out_dir: str, case: str):
    """Write an experiment's figure set to `out_dir`:
    `{case}_{mode}_coverage.pdf` (the coverage sweep) and, where the
    results hold 5-D prediction fields, `{case}_{mode}_fields.pdf` (three
    frames of the first prediction)."""
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    mode = results.get("mode", "joint")
    covs = {"AER+PRE": results.get("coverage_aer_pre"),
            "PRE": results.get("coverage_pre")}
    if results.get("coverage_aer_pre_holdout") is not None:
        covs["AER+PRE (holdout mod)"] = results["coverage_aer_pre_holdout"]
    fig = coverage_figure(results["alphas"], covs, title=f"{case} ({mode} CP)",
                          save_path=os.path.join(out_dir, f"{case}_{mode}_coverage.pdf"))
    plt.close(fig)
    pred = results.get("pred_pred")
    if pred is not None and np.ndim(pred) == 5:
        p = _np(pred[0, 0])
        idx = [0, p.shape[-1] // 2, p.shape[-1] - 1]
        fig = subplots_2d([p[..., i] for i in idx], titles=[f"t={i}" for i in idx],
                          suptitle=f"{case} prediction rollout",
                          save_path=os.path.join(out_dir, f"{case}_{mode}_fields.pdf"))
        plt.close(fig)
