"""Hilbert coreset builds through the program's entry: ``HilbertCoreset(...)``
(the projection, the constants and the selection copy, or for a streamed
configuration the chunks, their projection and quantization), ``build(M)``
(the solver loop and its select kernel) and ``get()``.

Job i projects the run's data on its own samples (theta ~ scale * N(0, I),
drawn from the seed and i: a fresh projection per build, as users' trials
draw).  The check draws builds of the window from the seed and holds each
to the plain reference (:mod:`benchmark.reference`) on the same data and
samples: the reference projects again, runs its own GIGA to M, and measures
the error of both answers against the same target, and which of its first
atoms, each the row best aligned with the residual over all the rows, the
answer holds.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import data, reference
from ..harness import sync

KIND = "hilbert"
LEVELS = {"int8": 127}        # levels of the reference's select, by the configuration's
# the reference's first atoms that an answer must hold: sound builds follow the
# reference's path past them, and part from it, if at all, after ten atoms or more
EARLY_ATOMS = 8
# a score within this share of the best is a tie that rounding breaks either
# way: one level of the int8 direction moves a score by about this much
TIE = 1e-3


class Job:
    """One run's builds.  ``cfg`` is the configuration file's dict,
    ``traffic`` the mix's, ``cell`` the cell file's."""

    kind = KIND

    def __init__(self, cfg: dict, traffic: dict, cell: dict, seed: int, dev: torch.device):
        import bayesian_coresets_tpu_torch as bc
        from bayesian_coresets_tpu_torch.models import logistic

        if cfg["model"] != "logistic":
            raise ValueError(f"the hilbert job runs the logistic model, not {cfg['model']!r}")
        self.bc, self.loglik = bc, logistic.log_likelihood
        self.cfg, self.traffic, self.cell, self.seed, self.dev = cfg, traffic, cell, seed, dev
        self.N, self.D, self.S = cfg["N"], cfg["D"], cfg["S"]
        self.M = cfg["coreset_size"]
        self.chunk = cfg.get("stream_chunk_size")
        self.select_dtype = cfg["select_dtype"]
        self.Z = data.logistic_data(seed, self.N, self.D, dev, on_host=self.chunk is not None)
        self.answers = {}           # job index -> (weights, indices, points), numpy
        self.reference_errors = {}  # job index -> the error of the reference's GIGA
        self.spans = []             # with spans on: one dict of seconds per job

    # -- the program's side ---------------------------------------------------

    def theta(self, index: int, stream: int = data.THETA) -> torch.Tensor:
        return data.projection_samples(self.seed, index, self.S, self.D,
                                       self.traffic["projection_scale"], self.dev, stream)

    def _coreset(self, theta: torch.Tensor):
        bc = self.bc

        def sampler(gen, n, wts, pts):
            if n != theta.shape[0]:
                raise ValueError(f"the projector asked for {n} samples, not {theta.shape[0]}")
            return theta

        proj = bc.BlackBoxProjector(sampler, self.S, self.loglik,
                                    generator=torch.Generator(device=self.dev))
        if self.chunk is not None:
            return bc.HilbertCoreset(self.Z, proj, max_active=self.cfg["max_active"],
                                     stream_chunk_size=self.chunk, device=self.dev)
        return bc.HilbertCoreset(self.Z, proj, select_dtype=getattr(torch, self.select_dtype),
                                 max_active=self.cfg["max_active"], device=self.dev)

    def run(self, index: int, spans: bool = False, stream: int = data.THETA) -> int:
        """Build job ``index``'s coreset; returns its work, the points asked
        for (M).  With ``spans`` the construction, the build and the read
        are timed apart, each ended by a synchronize."""
        from bayesian_coresets_tpu_torch.ops import snnls

        theta = self.theta(index, stream)
        t0 = time.perf_counter()
        with record_function("hilbert.construct"):
            coreset = self._coreset(theta)
        if spans:
            sync(self.dev)
            t1 = time.perf_counter()
            snnls.itrs_run = 0
        with record_function("hilbert.build"):
            coreset.build(self.M)
        if spans:
            sync(self.dev)
            t2 = time.perf_counter()
            itrs = snnls.itrs_run
        with record_function("hilbert.get"):
            wts, pts, idcs = coreset.get()
            del coreset
            sync(self.dev)
        if spans:
            self.spans.append({"construct_s": t1 - t0, "build_s": t2 - t1,
                               "get_s": time.perf_counter() - t2, "itrs": itrs})
        self.answers[index] = (np.asarray(wts), np.asarray(idcs), np.asarray(pts))
        return self.M

    def warm(self) -> None:
        """One build on samples of their own: every graph a build of this
        shape captures once is captured here."""
        self.run(0, stream=data.WARM_THETA)
        self.answers.clear()

    def shapes(self) -> dict:
        """What the layers' metrics count from: the selection copy's rows,
        padded width and type, and the directions' length."""
        Sp = -(-self.S // 16) * 16
        return {"n": self.N, "Sp": Sp, "S": self.S,
                "select_dtype": "int8" if self.chunk is not None else self.select_dtype}

    # -- the check ------------------------------------------------------------

    def sample(self, indices) -> list:
        """The window's builds that the check holds to the reference: the
        cell's ``check_builds`` of them, drawn from the seed."""
        indices = sorted(indices)
        k = min(self.cell["check_builds"], len(indices))
        rng = np.random.default_rng(data.subseed(self.seed, data.CHECK))
        return sorted(rng.choice(indices, size=k, replace=False).tolist())

    def reference_answer(self, sys_: reference.System, control: bool = False, M=None, **kw):
        """(indices, weights) of the reference's GIGA to ``M`` (the
        configuration's by default) on ``sys_`` in the configuration's
        precision: an int8 select (rows and directions rounded to 127
        levels), and for int8-resident constants the weights worked out on
        those rows.  ``control``: one precision below, int4 (7 levels)."""
        levels = 7 if control else LEVELS[self.select_dtype]
        return reference.giga(sys_, M or self.M, select_levels=levels,
                              resident=self.chunk is not None, **kw)

    def system(self, index: int) -> reference.System:
        return reference.System(reference.project(self.Z, self.theta(index), self.dev))

    def reference_error(self, index: int, sys_: reference.System) -> float:
        """The error of the reference's GIGA for build ``index``, run once
        and kept."""
        if index not in self.reference_errors:
            self.reference_errors[index] = reference.relative_error(
                sys_, *self.reference_answer(sys_))
        return self.reference_errors[index]

    def early_atoms_missed(self, sys_: reference.System, idcs: np.ndarray) -> int:
        """How many of the first :data:`EARLY_ATOMS` atoms of the reference's
        GIGA, following the answer ``idcs`` through ties, the answer lacks."""
        held = torch.zeros(sys_.V.shape[0], dtype=torch.bool, device=sys_.V.device)
        held[torch.as_tensor(idcs, device=held.device)] = True
        path, _ = self.reference_answer(sys_, M=EARLY_ATOMS, prefer=held, tie=TIE)
        return int((~np.isin(path.cpu().numpy(), idcs)).sum())

    def readings(self, index: int, answer=None, sys_=None) -> dict:
        """The numbers compared for one build: its answer (the program's, or
        ``answer`` in its place) judged on the reference's system (made
        here unless given) against the reference's own GIGA.

        ``error_gap``: |e / e_ref - 1|, e the answer's error |A w - b| / |b|
        and e_ref the reference's, both on the exact rows.  Two-sided: the
        reference runs the configuration's algorithm in its precision, so an
        answer that is better by more than rounding moves the paths apart is
        as far from it as one that is worse.  ``early_atoms_missed``: how
        many of the reference's first :data:`EARLY_ATOMS` atoms the answer
        lacks, the reference taking the answer's atom where the best score
        is tied.  Each is the row best aligned with the residual over all
        the rows, so an answer built on part of the data misses about half
        of them, however its weights are scaled.  ``malformed``: weights not
        finite and positive, more than M atoms, indices repeated or out of
        range, and points that are not the data's rows at the indices."""
        wts, idcs, pts = self.answers[index] if answer is None else answer
        wts, idcs = np.asarray(wts, dtype=np.float64), np.asarray(idcs, dtype=np.int64)
        if sys_ is None:
            sys_ = self.system(index)
        ref_err = self.reference_error(index, sys_)
        err = reference.relative_error(sys_, idcs, wts) if len(idcs) else 1.0
        ok = (idcs >= 0) & (idcs < self.N)
        early_missed = self.early_atoms_missed(sys_, idcs[ok])
        rows = np.asarray(self.Z[torch.as_tensor(idcs[ok]).to(self.Z.device)].cpu()
                          if torch.is_tensor(self.Z) else self.Z[idcs[ok]])
        wrong_rows = int(np.any(rows != np.asarray(pts)[ok], axis=1).sum()) if len(rows) else 0
        malformed = int((~np.isfinite(wts)).sum() + (wts <= 0).sum()
                        + max(0, len(wts) - self.M) + (len(idcs) - len(np.unique(idcs)))
                        + (~ok).sum() + wrong_rows)
        return {"error_gap": abs(err / ref_err - 1.0), "early_atoms_missed": early_missed,
                "malformed": malformed, "error": err, "reference_error": ref_err}

    def control_answer(self, sys_: reference.System):
        """The reference's GIGA one precision below the configuration's, in
        the program's place: (weights, indices, points)."""
        idcs, w = self.reference_answer(sys_, control=True)
        idcs = idcs.cpu().numpy()
        pts = (self.Z[torch.as_tensor(idcs).to(self.Z.device)].cpu().numpy()
               if torch.is_tensor(self.Z) else self.Z[idcs])
        return w.cpu().numpy(), idcs, np.asarray(pts)

    def check(self, indices, control: bool = False) -> tuple[dict, dict]:
        """(the numbers compared, each the worst over the sampled builds;
        what was checked).  ``control``: the control's answers in place of
        the program's."""
        worst = {"error_gap": 0.0, "early_atoms_missed": 0, "malformed": 0}
        seen = []
        for i in self.sample(indices):
            sys_ = self.system(i)
            r = self.readings(i, answer=self.control_answer(sys_) if control else None,
                              sys_=sys_)
            del sys_
            worst["error_gap"] = max(worst["error_gap"], r["error_gap"])
            worst["early_atoms_missed"] = max(worst["early_atoms_missed"], r["early_atoms_missed"])
            worst["malformed"] += r["malformed"]
            seen.append({"build": i, "error": r["error"], "reference_error": r["reference_error"],
                         "early_atoms_missed": r["early_atoms_missed"]})
        return worst, {"builds": seen}
