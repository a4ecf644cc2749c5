"""Carry values from the JAX package into this one: solver state and
constants (whole, or one rank's shard), the Laplace fit, MCMC states and results, the probe's packed
buffer, the Gaussian posterior basis, and SparseVI's slot state.

Each function takes the JAX package's NamedTuple with every field already
converted to a numpy array (e.g. ``type(x)(*map(np.asarray, x))``) and
returns the port's counterpart as tensors on ``device``.  The JAX package
pads the selection copy to 1024-row and 128-lane tiles for the TPU
(ops/snnls.py:123-128); that padding is stripped and the copy re-padded to
this package's own column multiple (int8-resident constants keep theirs,
see :func:`snnls_consts`).  This module imports no JAX: it reads
attributes only, so it also takes the port's own values converted to numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mcmc.integrators import IntegratorState
from ..mcmc.sample import MCMCResult
from ..models.gaussian import PosteriorBasis
from ..models.laplace import LaplaceResult
from ..ops.giga_select import col_multiple
from ..ops.snnls import SNNLSConsts, SNNLSState, _pad_cols


def _t(x, device, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)   # a copy


def snnls_consts(c, device="cpu") -> SNNLSConsts:
    """SNNLSConsts (V, b, norms, bnorm, valid, ps, Vsel) from numpy fields.

    An empty ``Vsel`` (the JAX package's zero-row "select reads V"
    sentinel) becomes the port's f32 select, which reads V.  int8-resident
    constants (V itself int8, from the JAX package's
    ``make_consts_quantized``) are carried with their padding kept: the
    JAX package's 1024-multiple rows stay as rows with ``valid`` False and
    norm 1, and its 128-multiple columns (a multiple of this package's 16)
    stay zero, with ``b`` zero there; the select then reads V itself, as the
    port's own int8-resident constants do.  ``ps`` (n entries for the
    sampling solvers, none otherwise) is carried as it is.
    """
    V = np.asarray(c.V)
    if V.dtype not in (np.float32, np.int8):
        raise ValueError(f"V must be float32 or int8 (int8-resident); got {V.dtype}")
    n, S = V.shape
    Vt = _t(V, device)
    b = _t(c.b, device)
    Vsel = np.asarray(c.Vsel)
    if V.dtype == np.int8:
        Vt = sel = _pad_cols(Vt, col_multiple(torch.int8)).contiguous()
        b = torch.nn.functional.pad(b, (0, Vt.shape[1] - b.shape[0]))
    elif Vsel.shape[0] == 0:
        sel = Vt
    else:
        # ml_dtypes' bfloat16 has no torch counterpart in numpy: go by bits
        if Vsel.dtype.name == "bfloat16":
            sel = _t(Vsel[:n, :S].view(np.int16), device).view(torch.bfloat16)
        else:
            sel = _t(Vsel[:n, :S], device)
    sel = _pad_cols(sel, col_multiple(sel.dtype)).contiguous()
    return SNNLSConsts(Vt, b, _t(c.norms, device), _t(c.bnorm, device),
                       _t(c.valid, device, torch.bool), _t(np.asarray(c.ps)[:n], device), sel)


def sharded_consts(c, mesh, device="cpu", shard_proj: bool = False) -> SNNLSConsts:
    """This rank's shard (``parallel.shard_consts``) of solver constants
    from the JAX package's ``make_sharded_consts`` or
    ``make_consts_quantized`` output, numpy fields of the global (padded)
    problem, as :func:`snnls_consts` carries them.  Rows the JAX package
    padded stay rows with ``valid`` False; where its row count does not
    divide the mesh's data axis, this package pads further alike.  With
    ``shard_proj`` (the JAX package's ``make_sharded_consts(...,
    shard_proj=True)``, whose S is padded to ``lcm(proj, 128)`` for int8
    and to ``proj`` otherwise), the rank's column block of that padded S."""
    from ..parallel.coreset import shard_consts

    return shard_consts(snnls_consts(c, device), mesh, shard_proj)


def snnls_state(s, device="cpu") -> SNNLSState:
    """SNNLSState (w, xw, cts, idcs, size, itr, fail, done) from numpy
    fields.  The JAX package's PRNG ``key`` has no counterpart: the port's
    sampling solvers draw from a ``torch.Generator`` handed to ``build``."""
    i32 = torch.int32
    return SNNLSState(_t(s.w, device), _t(s.xw, device), _t(s.cts, device),
                      _t(s.idcs, device, i32),
                      _t(s.size, device, i32), _t(s.itr, device, i32),
                      _t(s.fail, device, i32), _t(s.done, device, torch.bool))


def laplace_result(r, device="cpu") -> LaplaceResult:
    """LaplaceResult (mu, USig, LSigInv) from numpy fields."""
    return LaplaceResult(_t(r.mu, device), _t(r.USig, device), _t(r.LSigInv, device))


def packed_buffer(P, device="cpu") -> torch.Tensor:
    """The probe's packed int4 copy (probe_int4_pallas.py:121): (n, S/2)
    int8, two signed nibbles a byte, as a contiguous int8 tensor."""
    P = np.asarray(P)
    if P.dtype != np.int8 or P.ndim != 2:
        raise ValueError(f"a packed buffer is a 2-D int8 array; got {P.dtype} {P.shape}")
    return _t(P, device)


def integrator_state(s, device="cpu") -> IntegratorState:
    """IntegratorState (z, r, logp, grad) from numpy fields: one chain's
    (d,) arrays or vmapped chains' (C, d), as the port's (C, d) batch."""
    z = np.asarray(s.z)
    lead = (lambda x: np.asarray(x)[None]) if z.ndim == 1 else np.asarray
    return IntegratorState(*(_t(lead(x), device) for x in (s.z, s.r, s.logp, s.grad)))


def mcmc_result(r, device="cpu") -> MCMCResult:
    """MCMCResult (samples, accept_prob, num_divergent, step_size, inv_mass)
    from numpy fields; the JAX package records no tree depth."""
    return MCMCResult(*(_t(getattr(r, f), device) for f in
                        ("samples", "accept_prob", "num_divergent", "step_size", "inv_mass")))


def posterior_basis(b, device="cpu") -> PosteriorBasis:
    """PosteriorBasis (Uinv, UinvT, lam, r0, Siginv) from numpy fields.

    Where the eigenbasis is not unique (repeated eigenvalues), carrying the
    JAX package's basis across makes exact tangent features comparable
    elementwise, not only up to a rotation."""
    return PosteriorBasis(*(_t(getattr(b, f), device) for f in PosteriorBasis._fields))


def svi_state(wts, idcs, size, device="cpu"):
    """SparseVI slot state ``(wts, idcs, size)`` from the JAX package's
    arrays: f32 weights and int64 indices as tensors on ``device`` (empty
    slots hold -1), and ``size`` as a host integer."""
    return (_t(wts, device, torch.float32), _t(np.asarray(idcs).astype(np.int64), device),
            int(np.asarray(size)))
