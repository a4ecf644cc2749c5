"""Dataset preparation utilities.

Port of ``bayesian_coresets_tpu/experiments/data_prep.py``, host only
(NumPy and ``csv``).  Covers the reference's ``examples/data`` prep
scripts (SURVEY.md §2.3 C31):
- ``convert_mnist_to_2class``: collapse an MNIST-style .npz into a binary
  +-1-labeled design matrix with an intercept column
  (reference convert_mnist_to_2class.py).
- ``process_housing_prices``: join UK price-paid CSV rows with a
  postcode -> (lat, lon) geocoding table into the ``prices2018.npy``
  [lat, lon, price] array (reference process_housing_prices.py).  The raw
  inputs are not distributed; this reimplements the transform for users who
  have them.

Run: python -m bayesian_coresets_tpu_torch.experiments.data_prep mnist in.npz out.npz
"""

from __future__ import annotations

import sys

import numpy as np


def convert_mnist_to_2class(in_path: str, out_path: str,
                            class_a: int = 0, class_b: int = 1) -> str:
    """Binary MNIST subset: keep two digit classes, flatten, append intercept,
    store y in {-1, +1}."""
    with np.load(in_path) as data:
        X = np.asarray(data["X"] if "X" in data else data["x_train"])
        y = np.asarray(data["y"] if "y" in data else data["y_train"])
    keep = (y == class_a) | (y == class_b)
    X = X[keep].reshape(keep.sum(), -1).astype(np.float64)
    X = X / max(X.max(), 1.0)
    X = np.hstack([X, np.ones((X.shape[0], 1))])
    yy = np.where(y[keep] == class_b, 1.0, -1.0)
    np.savez_compressed(out_path, X=X, y=yy)
    return out_path


def process_housing_prices(prices_csv: str, postcode_csv: str,
                           out_path: str = "prices2018.npy") -> str:
    """Join price-paid rows (postcode, price) with postcode geocodes
    (postcode, lat, lon) -> [lat, lon, price] array."""
    import csv

    geocode = {}
    with open(postcode_csv, newline="") as f:
        for row in csv.reader(f):
            if len(row) >= 3:
                try:
                    geocode[row[0].replace(" ", "").upper()] = (
                        float(row[1]), float(row[2]))
                except ValueError:
                    continue
    rows = []
    with open(prices_csv, newline="") as f:
        for row in csv.reader(f):
            if len(row) < 4:
                continue
            pc = row[3].replace(" ", "").upper()
            if pc in geocode:
                try:
                    price = float(row[1])
                except ValueError:
                    continue
                lat, lon = geocode[pc]
                rows.append((lat, lon, price))
    if not rows:
        raise ValueError("no joined rows; check input formats")
    np.save(out_path, np.asarray(rows, dtype=np.float64))
    return out_path


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return
    cmd = argv[0]
    if cmd == "mnist":
        print(convert_mnist_to_2class(*argv[1:]))
    elif cmd == "housing":
        print(process_housing_prices(*argv[1:]))
    else:
        raise SystemExit(f"unknown command {cmd!r} (mnist | housing)")


if __name__ == "__main__":
    main()
