"""Quantile plots for experiment results (matplotlib).

Port of ``bayesian_coresets_tpu/experiments/plotting.py`` (reference Bokeh
helpers, examples/common/plotting.py:7-158): generic ``plot`` grouping rows
by a legend column, with optional groupby aggregation to 10/50/90
percentile bands, log axes, and the colorblind palette, written as a
PNG/PDF.  It takes the :class:`.results.Table` that ``load_matching``
returns; matplotlib is imported inside the functions that draw, so
importing this module needs neither matplotlib nor a display.
"""

from __future__ import annotations

import ast

import numpy as np

# Wong colorblind-safe palette (reference plotting.py:47-51)
PALETTE = ["#0072B2", "#E69F00", "#009E73", "#D55E00", "#CC79A7",
           "#56B4E9", "#F0E442", "#000000"]


def _col_numeric(table, col):
    vals = table[col]
    if vals.dtype == object:
        def parse(v):
            if isinstance(v, str):
                try:
                    return np.asarray(ast.literal_eval(v), dtype=float)
                except (ValueError, SyntaxError):
                    return np.nan
            return v
        vals = [parse(v) for v in vals]
    return np.asarray(vals, dtype=float)


def _groups(table, col):
    """(key, rows) for each distinct non-missing value of ``col``, in
    sorted order (pandas' ``groupby``)."""
    keys = table[col]
    present = [k for k in keys if not (isinstance(k, float) and np.isnan(k))]
    for name in sorted(set(present)):
        yield name, table.take(np.array([k == name for k in keys], dtype=bool))


def plot(arguments, table, out_path: str | None = None):
    """Generic experiment plot (reference plotting.py:73-138 semantics)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    x_col, y_col = arguments.plot_x, arguments.plot_y
    legend_col = arguments.plot_legend
    groups = _groups(table, legend_col) if legend_col else [(None, table)]

    for ci, (name, g) in enumerate(groups):
        color = PALETTE[ci % len(PALETTE)]
        x = _col_numeric(g, x_col)
        y = _col_numeric(g, y_col)
        if arguments.groupby:
            xs, med, lo, hi = [], [], [], []
            for _, rows in _groups(g, arguments.groupby):
                xs.append(np.median(_col_numeric(rows, x_col)))
                yy = _col_numeric(rows, y_col)
                med.append(np.percentile(yy, 50))
                lo.append(np.percentile(yy, 10))
                hi.append(np.percentile(yy, 90))
            order = np.argsort(xs)
            xs = np.asarray(xs)[order]
            med = np.asarray(med)[order]
            lo = np.asarray(lo)[order]
            hi = np.asarray(hi)[order]
            ax.plot(xs, med, color=color, label=str(name), lw=2)
            ax.fill_between(xs, lo, hi, color=color, alpha=0.25)
        elif arguments.plot_type == "line":
            order = np.argsort(x)
            ax.plot(x[order], y[order], color=color, label=str(name), lw=2)
        else:
            ax.scatter(x, y, color=color, label=str(name), s=16)

    if arguments.plot_x_type == "log":
        ax.set_xscale("log")
    if arguments.plot_y_type == "log":
        ax.set_yscale("log")
    ax.set_xlabel(arguments.plot_x_label or x_col)
    ax.set_ylabel(arguments.plot_y_label or y_col)
    if arguments.plot_title:
        ax.set_title(arguments.plot_title)
    if legend_col:
        ax.legend()
    fig.tight_layout()
    out = out_path or getattr(arguments, "plot_out", None) or \
        f"plot_{y_col}_vs_{x_col}.png"
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def plot_gaussian_ellipse(ax, mu, Sig, color, n_std: float = 2.0, **kw):
    """Posterior covariance ellipse (reference plotting.py:140-158)."""
    vals, vecs = np.linalg.eigh(np.asarray(Sig))
    t = np.linspace(0, 2 * np.pi, 200)
    circ = np.stack([np.cos(t), np.sin(t)])
    pts = (vecs * n_std * np.sqrt(np.maximum(vals, 0))) @ circ
    ax.plot(np.asarray(mu)[0] + pts[0], np.asarray(mu)[1] + pts[1],
            color=color, **kw)
