"""The plain reference of a Hilbert coreset build, in float64 PyTorch.

It imports nothing of the program under test and takes nothing the program
made: it projects the data itself, through the log-likelihood of its own
that it is given (``models/<model>.py``'s ``loglik``), forms the system
itself, and runs its own GIGA (reference ``bayesiancoresets/snnls/giga.py``
and ``snnls.py`` of trevorcampbell/bayesian-coresets, with the optimal
scaling of the reweight taken as (x . b) / |x|^2).  It reads the program's
answer (weights and indices) only to judge it, by :func:`relative_error`.

Everything runs on the device of the inputs, in blocks of rows, so that the
(n, S) float64 projection is the largest thing it holds.  ``select`` is the
precision of the select, one of :data:`PRECISIONS` or None, exact
(float64).  Every precision selects on the rows rounded as a selection copy
of that type holds them, with the directions rounded alike, and scores the
normalized rows: ``"float32"`` and ``"bfloat16"`` round the rows to the
float type as they are, sum their dots in float64 and divide them by the
rows' norms; ``"int8"`` rounds the normalized rows to integers in [-127,
127], the int8 select that the int8 configurations state, and ``"int4"`` to
integers in [-7, 7], the precision below int8 (the control of a check),
their dots exact.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 1 << 18      # rows per block of the projection and the select
BLOCK_BYTES = 1 << 31     # at most this many bytes of float64 rows a block of a float select
TOL = 1e-6                # the solver tolerance both packages default to
# integer levels of a normalized entry, or the float type entries are rounded to
LEVELS = {"int8": 127, "int4": 7}
FLOATS = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PRECISIONS = (*FLOATS, *LEVELS)


def _rows(data, lo: int, hi: int, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(data[lo:hi]).to(device=dev, dtype=torch.float64)


def project(data, theta: torch.Tensor, dev: torch.device, loglik) -> torch.Tensor:
    """(n, S) float64 feature vectors: each row's log-likelihood
    ``loglik(rows, theta)`` at the S samples, both float64, centered over
    the samples.  ``data`` is a tensor or a numpy array, read in blocks of
    rows."""
    n = data.shape[0]
    th = theta.to(device=dev, dtype=torch.float64)
    V = torch.empty((n, th.shape[0]), dtype=torch.float64, device=dev)
    for lo in range(0, n, BLOCK_ROWS):
        hi = min(n, lo + BLOCK_ROWS)
        ll = loglik(_rows(data, lo, hi, dev), th)
        V[lo:hi] = ll - ll.mean(dim=1, keepdim=True)
    return V


def _integer_dots(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Dots of integer rows with integer directions, exact: float32 holds
    every integer below 2^24, and with entries of at most 127 in magnitude
    and at most 1024 columns no partial sum reaches it.  TF32, which would
    round the entries, is off for the product."""
    if q.shape[1] > 1024:
        raise ValueError("integer dots are exact in float32 up to 1024 columns")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return (q.float() @ d.float()).double()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


class System:
    """A = V^T and b = the sum of the valid rows, with the row norms; a row
    of norm 0 is not selectable (reference hilbert.py:20-22)."""

    def __init__(self, V: torch.Tensor):
        self.V = V
        self.norms = torch.cat([torch.linalg.vector_norm(V[lo:lo + BLOCK_ROWS], dim=1)
                                for lo in range(0, V.shape[0], BLOCK_ROWS)])
        self.valid = self.norms > 0
        self.b = sum(torch.sum(V[lo:lo + BLOCK_ROWS][self.valid[lo:lo + BLOCK_ROWS]], dim=0)
                     for lo in range(0, V.shape[0], BLOCK_ROWS))
        self.bnorm = float(torch.linalg.vector_norm(self.b))
        self._select_copies = {}     # precision -> the rounded selection copy

    def matvec(self, idcs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """A w over the rows ``idcs`` with weights ``w``."""
        return self.V.index_select(0, idcs).T @ w

    def scores(self, dirs: torch.Tensor, select: str | None) -> torch.Tensor:
        """(n, 2) dots of the normalized rows with the unit directions, in
        the precision ``select``."""
        if select is None:
            return self._exact_scores(dirs)
        if select in FLOATS:
            return self._float_scores(dirs, select)
        return self._integer_scores(dirs, select)

    def _exact_scores(self, dirs: torch.Tensor) -> torch.Tensor:
        out = torch.empty((self.V.shape[0], 2), dtype=torch.float64, device=self.V.device)
        safe = torch.where(self.valid, self.norms, 1.0)
        for lo in range(0, self.V.shape[0], BLOCK_ROWS):
            out[lo:lo + BLOCK_ROWS] = (self.V[lo:lo + BLOCK_ROWS] @ dirs) \
                / safe[lo:lo + BLOCK_ROWS, None]
        return out

    def select_copy(self, select: str) -> torch.Tensor:
        """The rows rounded as a selection copy of the precision ``select``
        holds them: the float type's values of the rows, or int8 integers of
        the normalized rows for the integer precisions."""
        if select in self._select_copies:
            return self._select_copies[select]
        if select in FLOATS:
            q = self.V.to(FLOATS[select])
        else:
            levels, safe = LEVELS[select], torch.where(self.valid, self.norms, 1.0)
            q = torch.empty(self.V.shape, dtype=torch.int8, device=self.V.device)
            for lo in range(0, self.V.shape[0], BLOCK_ROWS):
                blk = self.V[lo:lo + BLOCK_ROWS] / safe[lo:lo + BLOCK_ROWS, None]
                q[lo:lo + BLOCK_ROWS] = torch.clamp(torch.round(blk * levels),
                                                    -levels, levels).to(torch.int8)
        self._select_copies[select] = q
        return q

    def _float_scores(self, dirs: torch.Tensor, select: str) -> torch.Tensor:
        q = self.select_copy(select)
        d = dirs.to(FLOATS[select]).double()     # the directions rounded alike
        safe = torch.where(self.valid, self.norms, 1.0)
        rows = max(1, min(BLOCK_ROWS, BLOCK_BYTES // (8 * q.shape[1])))
        return torch.cat([(q[lo:lo + rows].double() @ d) / safe[lo:lo + rows, None]
                          for lo in range(0, q.shape[0], rows)])

    def _integer_scores(self, dirs: torch.Tensor, select: str) -> torch.Tensor:
        q, levels = self.select_copy(select), LEVELS[select]
        out = torch.empty((self.V.shape[0], 2), dtype=torch.float64, device=self.V.device)
        dirs = torch.clamp(torch.round(dirs * levels), -levels, levels)  # rounded alike
        for lo in range(0, self.V.shape[0], BLOCK_ROWS):
            out[lo:lo + BLOCK_ROWS] = _integer_dots(q[lo:lo + BLOCK_ROWS], dirs) \
                / (levels * levels)
        return out


def giga(sys_: System, M: int, select: str | None = None, resident: bool = False,
         prefer: torch.Tensor | None = None, tie: float = 0.0):
    """M iterations of GIGA on ``sys_``: (indices, weights) of the atoms of
    positive weight, in the order they were chosen, on the system's device.
    A step that fails (a direction too short, a reweight out of range, or an
    error that grows) ends the build, as the reference's second consecutive
    failure does.  ``resident``: the weights are worked out on the rows as
    the integer selection copy of the precision ``select`` holds them, each
    times its norm over the levels, as int8-resident constants hold them;
    the error is then measured on the exact rows all the same.  ``prefer``: a boolean mask of
    rows; where the best score is tied, within a share ``tie`` of its size,
    by a preferred row, the best preferred row is chosen (a path that
    follows an answer through the ties that rounding breaks either way)."""
    V, dev = sys_.V, sys_.V.device
    if resident:
        if select not in LEVELS:
            raise ValueError(f"resident rows need an integer selection copy, not {select!r}")
        q, row_scale = sys_.select_copy(select), sys_.norms / LEVELS[select]

        def rows(idcs):
            return q.index_select(0, idcs).double() * row_scale.index_select(0, idcs)[:, None]
    else:
        def rows(idcs):
            return V.index_select(0, idcs)

    def matvec(idcs, w):
        return rows(idcs).T @ w

    bn = sys_.b / sys_.bnorm
    err = None
    idcs = torch.zeros(0, dtype=torch.long, device=dev)
    w = torch.zeros(0, dtype=torch.float64, device=dev)
    minus_inf = torch.tensor(-np.inf, dtype=torch.float64, device=dev)
    for _ in range(M):
        xw = matvec(idcs, w) if idcs.numel() else torch.zeros_like(sys_.b)
        nw = float(torch.linalg.vector_norm(xw)) or 1.0
        xwn = xw / nw
        bxw = float(bn @ xwn)
        cdir = bn - bxw * xwn
        cnrm = float(torch.linalg.vector_norm(cdir))
        if cnrm < TOL:
            break
        dots = sys_.scores(torch.stack([cdir / cnrm, xwn], dim=1), select)
        d1 = dots[:, 1]
        stable = (d1 > -1.0 + 1e-14) & (1.0 - d1 * d1 > 0.0)
        den = torch.where(stable, torch.sqrt(torch.clamp_min(1.0 - d1 * d1, 0.0)), np.inf)
        score = torch.where(sys_.valid, dots[:, 0] / den, minus_inf)
        f = int(torch.argmax(score))
        if prefer is not None:
            near = prefer & (score >= score[f] - tie * abs(float(score[f])))
            if bool(near.any()):
                f = int(torch.argmax(torch.where(near, score, minus_inf)))
        nf = float(sys_.norms[f])
        xf = rows(torch.tensor([f], device=dev))[0] / nf
        bxf, wxf = float(bn @ xf), float(xwn @ xf)
        gA, gB = bxf - bxw * wxf, bxw - bxf * wxf
        if gA <= 0.0 or gB < 0.0:
            break
        a, c = gB / (gA + gB), gA / (gA + gB)
        x = a * xwn + c * xf
        scale = float(x @ sys_.b) / float(x @ x)
        alpha, beta = a * scale / nw, c * scale / nf
        hit = (idcs == f).nonzero()
        new_w = alpha * w
        new_idcs = idcs
        if hit.numel():
            new_w[hit[0, 0]] = torch.clamp_min(new_w[hit[0, 0]] + beta, 0.0)
        else:
            new_idcs = torch.cat([idcs, torch.tensor([f], device=dev)])
            new_w = torch.cat([new_w, torch.tensor([max(beta, 0.0)], dtype=torch.float64,
                                                   device=dev)])
        new_err = float(torch.linalg.vector_norm(matvec(new_idcs, new_w) - sys_.b))
        if err is not None and new_err > err * (1.0 + TOL):
            break
        idcs, w, err = new_idcs, new_w, new_err
    keep = w > 0
    return idcs[keep], w[keep]


def relative_error(sys_: System, idcs, w) -> float:
    """|A w - b| / |b| of the weights ``w`` on the rows ``idcs`` (numpy or
    tensors), in float64."""
    dev = sys_.V.device
    idcs = torch.as_tensor(np.asarray(idcs, dtype=np.int64) if not torch.is_tensor(idcs)
                           else idcs, device=dev).long()
    w = torch.as_tensor(w, device=dev).double()
    if idcs.numel() == 0:
        return 1.0
    return float(torch.linalg.vector_norm(sys_.matvec(idcs, w) - sys_.b)) / sys_.bnorm
