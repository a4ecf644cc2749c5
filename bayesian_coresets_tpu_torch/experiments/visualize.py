"""Coreset visualization: data, weighted coreset points, posterior ellipses.

Port of ``bayesian_coresets_tpu/experiments/visualize.py``, host only
(NumPy, pickle, and matplotlib imported inside the functions that draw); it
reads the ``coreset_data.pk`` of either package's ``gaussian`` driver.
Covers the reference's ``examples/gaussian/plot_coreset_pts.py:32-110``:
scatter the dataset, overlay coreset points sized by weight, and draw 2-sigma
posterior ellipses (true posterior vs coreset posterior) for each recorded
build size.  For d > 2 a random 2D projection is used, as in the reference's
``plot_gaussian_projected2d`` (examples/common/plotting.py:160-183).

Run: python -m bayesian_coresets_tpu_torch.experiments.visualize results/coreset_data.pk
"""

from __future__ import annotations

import pickle
import sys

import numpy as np

from .plotting import PALETTE, plot_gaussian_ellipse


def plot_coreset_pts(coreset_data_path: str, out_prefix: str = "coreset_pts",
                     seed: int = 0, max_panels: int = 6):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(coreset_data_path, "rb") as f:
        (x, mu0, Sig0, Sig, mup, Sigp, w, p, muw, Sigw) = pickle.load(f)

    d = x.shape[1]
    if d > 2:
        rng = np.random.default_rng(seed)
        proj = np.linalg.qr(rng.normal(size=(d, 2)))[0]     # random 2D frame
    else:
        proj = np.eye(2)

    x2 = x @ proj
    mup2 = mup @ proj
    Sigp2 = proj.T @ Sigp @ proj

    sizes = list(range(len(w)))[-max_panels:]
    fig, axes = plt.subplots(1, len(sizes), figsize=(5 * len(sizes), 5),
                             squeeze=False)
    for ax, m in zip(axes[0], sizes):
        ax.scatter(x2[:, 0], x2[:, 1], s=4, color="#cccccc", label="data")
        if len(w[m]) > 0:
            p2 = np.atleast_2d(p[m]) @ proj
            ax.scatter(p2[:, 0], p2[:, 1], s=4 + 40 * np.asarray(w[m]) / max(np.max(w[m]), 1e-9),
                       color=PALETTE[1], label="coreset")
        plot_gaussian_ellipse(ax, mup2, Sigp2, PALETTE[0], lw=2, label="posterior")
        muw2 = muw[m] @ proj
        Sigw2 = proj.T @ Sigw[m] @ proj
        plot_gaussian_ellipse(ax, muw2, Sigw2, PALETTE[3], lw=2, ls="--",
                              label="coreset posterior")
        ax.set_title(f"size {int((np.asarray(w[m]) > 0).sum())}")
        ax.legend(fontsize=8)
    fig.tight_layout()
    out = f"{out_prefix}.png"
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def plot_linreg_surface(basis_locs, basis_scales, theta, pts=None, wts=None,
                        out_path: str = "linreg_surface.png", grid_n: int = 120,
                        extent=(-2.5, 2.5)):
    """Predicted-response contour map with coreset points overlaid.

    Covers the reference's housing-price contour plots
    (examples/linear_regression/plot_coreset_pts.py:53-118, which used
    skimage): evaluate the RBF regression surface mean on a lat/lon grid
    with matplotlib contours; scatter coreset points sized by weight.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    g = np.linspace(extent[0], extent[1], grid_n)
    xx, yy = np.meshgrid(g, g)
    locs = np.stack([xx.ravel(), yy.ravel()], axis=1)
    feats = np.exp(-((locs[:, None, :] - basis_locs[None, :, :]) ** 2).sum(-1)
                   / (2.0 * np.asarray(basis_scales)[None, :] ** 2))
    surface = (feats @ np.asarray(theta)).reshape(grid_n, grid_n)

    fig, ax = plt.subplots(figsize=(7, 6))
    cs = ax.contourf(xx, yy, surface, levels=30, cmap="viridis")
    fig.colorbar(cs, ax=ax, label="predicted response")
    if pts is not None and len(pts) > 0:
        pts = np.atleast_2d(pts)
        sizes = 10 + 60 * np.asarray(wts) / max(np.max(wts), 1e-9) if wts is not None else 20
        ax.scatter(pts[:, 0], pts[:, 1], s=sizes, c="#D55E00",
                   edgecolors="white", linewidths=0.5, label="coreset")
        ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_housing_prices(data=None, out_path: str = "housing_prices.png",
                        power: int = 3, seed: int = 0, n: int = 20000):
    """Price-colored location scatter of the housing dataset.

    Covers the reference's ``examples/data/plot_housing_prices.py``: sort by
    price, map normalized log-price through a cubic to a red-blue ramp, and
    scatter (lon, lat).  ``data`` rows are [lat, lon, price-like]; omitted,
    the synthetic stand-in is generated (the reference's ``prices2018.npy``
    is not shipped with either repo).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if data is None:
        from .datasets import gen_synthetic_housing
        data = gen_synthetic_housing(np.random.default_rng(seed), n)
    data = np.asarray(data)
    data = data[np.argsort(data[:, 2])]
    logp = np.log(np.clip(data[:, 2], 1e-12, None))
    c = ((logp - logp.min()) / max(logp.max() - logp.min(), 1e-12)) ** power
    colors = np.stack([c, np.zeros_like(c), 1.0 - c], axis=1)

    fig, ax = plt.subplots(figsize=(7, 6))
    ax.scatter(data[:, 1], data[:, 0], s=4, c=colors, alpha=0.25, linewidths=0)
    ax.set_xlabel("lon")
    ax.set_ylabel("lat")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] == "housing":
        out = plot_housing_prices(out_path=argv[1] if len(argv) > 1
                                  else "housing_prices.png")
    else:
        path = argv[0] if argv else "results/coreset_data.pk"
        out = plot_coreset_pts(path)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
