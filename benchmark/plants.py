"""Faults planted in the program under test, to show that a Hilbert cell's
check fails them.  Each is a context manager that patches the program for
the block and restores it after; on the card the graphs captured with the
fault are dropped on both sides of the block.

- ``unchanged``: every build returns its state unchanged (no iteration runs).
- ``half_rows``: half of the rows are left out of the build, and the mean
  is taken over the rest: the build runs on the first half, and its
  weights are doubled so that they stand for the whole.
- ``half_rows_strided``: the same with every other row left out.
- ``select_off_by_one``: the select's answer is altered where it is
  produced: the row after the one it chose, written into the index buffer of
  ``giga_select.giga_select_into``, which every GIGA select of the program
  calls, the card's fused step and the plain route alike.
- ``point_altered``: the coreset's answer is altered where it is produced:
  the first atom's point is not the data's row.
"""

from __future__ import annotations

import contextlib

import numpy as np


def _release():
    from bayesian_coresets_tpu_torch.ops import graphs
    graphs.release()


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    _release()
    try:
        yield
    finally:
        setattr(obj, name, old)
        _release()


@contextlib.contextmanager
def unchanged():
    from bayesian_coresets_tpu_torch.ops import snnls

    def build(consts, state, itrs, *args, **kw):
        return state

    with _patched(snnls, "build", build):
        yield


@contextlib.contextmanager
def half_rows():
    from bayesian_coresets_tpu_torch.coresets import hilbert

    cls = hilbert.HilbertCoreset
    init, get = cls.__init__, cls.get

    def init_half(self, data, *args, **kw):
        init(self, data[:data.shape[0] // 2], *args, **kw)

    def get_doubled(self):
        wts, pts, idcs = get(self)
        return 2.0 * wts, pts, idcs

    with _patched(cls, "__init__", init_half), _patched(cls, "get", get_doubled):
        yield


@contextlib.contextmanager
def half_rows_strided():
    from bayesian_coresets_tpu_torch.coresets import hilbert

    cls = hilbert.HilbertCoreset
    init, get = cls.__init__, cls.get

    def init_even(self, data, *args, **kw):
        even = data[::2]
        init(self, even.contiguous() if hasattr(even, "contiguous")
             else np.ascontiguousarray(even), *args, **kw)

    def get_doubled(self):
        wts, pts, idcs = get(self)
        return 2.0 * wts, pts, 2 * idcs

    with _patched(cls, "__init__", init_even), _patched(cls, "get", get_doubled):
        yield


@contextlib.contextmanager
def select_off_by_one():
    from bayesian_coresets_tpu_torch.ops import giga_select

    select_into = giga_select.giga_select_into

    def off_by_one(Vsel, dirs, norms, valid, idx, score):
        select_into(Vsel, dirs, norms, valid, idx, score)
        idx.add_(1).remainder_(Vsel.shape[0])

    with _patched(giga_select, "giga_select_into", off_by_one):
        yield


@contextlib.contextmanager
def point_altered():
    from bayesian_coresets_tpu_torch.coresets import hilbert

    cls = hilbert.HilbertCoreset
    sync = cls._sync

    def sync_altered(self):
        sync(self)
        if len(self.pts):
            self.pts = np.array(self.pts, copy=True)
            self.pts[0] = self.pts[0] + 1.0

    with _patched(cls, "_sync", sync_altered):
        yield


PLANTS = {"unchanged": unchanged, "half_rows": half_rows, "half_rows_strided": half_rows_strided,
          "select_off_by_one": select_off_by_one, "point_altered": point_altered}
