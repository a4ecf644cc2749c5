"""Carry values from the JAX package into this one.

Each function takes the JAX package's NamedTuple with every field already
converted to a numpy array (e.g. ``type(x)(*map(np.asarray, x))``) and
returns the port's counterpart as tensors on ``device``.  The JAX package
pads the selection copy to 1024-row and 128-lane tiles for the TPU
(ops/snnls.py:123-128); that padding is stripped and the copy re-padded to
this package's own column multiple.  This module imports no JAX: it reads
attributes only, so it also takes the port's own values converted to numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.laplace import LaplaceResult
from ..ops.giga_select import col_multiple
from ..ops.snnls import SNNLSConsts, SNNLSState, _pad_cols


def _t(x, device, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)   # a copy


def snnls_consts(c, device="cpu") -> SNNLSConsts:
    """SNNLSConsts (V, b, norms, bnorm, valid, Vsel) from numpy fields.

    An empty ``Vsel`` (the JAX package's zero-row "select reads V"
    sentinel) becomes the port's f32 select, which reads V.  int8-resident
    constants (V itself int8) are not ported and raise.
    """
    V = np.asarray(c.V)
    if V.dtype != np.float32:
        raise ValueError(f"only f32 V is supported (int8-resident constants are "
                         f"not ported); got {V.dtype}")
    n, S = V.shape
    Vt = _t(V, device)
    Vsel = np.asarray(c.Vsel)
    if Vsel.shape[0] == 0:
        sel = Vt
    else:
        # ml_dtypes' bfloat16 has no torch counterpart in numpy: go by bits
        if Vsel.dtype.name == "bfloat16":
            sel = _t(Vsel[:n, :S].view(np.int16), device).view(torch.bfloat16)
        else:
            sel = _t(Vsel[:n, :S], device)
    sel = _pad_cols(sel, col_multiple(sel.dtype)).contiguous()
    return SNNLSConsts(Vt, _t(c.b, device), _t(c.norms, device),
                       _t(c.bnorm, device), _t(c.valid, device, torch.bool), sel)


def snnls_state(s, device="cpu") -> SNNLSState:
    """SNNLSState (w, xw, idcs, size, itr, fail, done) from numpy fields;
    the sampling solvers' ``cts`` and ``key`` are dropped."""
    i32 = torch.int32
    return SNNLSState(_t(s.w, device), _t(s.xw, device), _t(s.idcs, device, i32),
                      _t(s.size, device, i32), _t(s.itr, device, i32),
                      _t(s.fail, device, i32), _t(s.done, device, torch.bool))


def laplace_result(r, device="cpu") -> LaplaceResult:
    """LaplaceResult (mu, USig, LSigInv) from numpy fields."""
    return LaplaceResult(_t(r.mu, device), _t(r.USig, device), _t(r.LSigInv, device))
