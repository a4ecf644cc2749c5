"""Hilbert coreset builds through the program's entry: ``HilbertCoreset(...)``
(the projection, the constants and the selection copy, or for a streamed
configuration the chunks, their projection and quantization), ``build(M)``
(the solver loop and its select kernel) and ``get()``.

The configuration's ``model`` names the model (``models/<model>.py``): its
rows, the program's log-likelihood (``PROGRAM_LOGLIK``) and the reference's
in float64 (``loglik``).  Job i projects the run's data on its own samples
(theta ~ scale * N(0, I), drawn from the seed and i: a fresh projection per
build, as users' trials draw).  The check draws builds of the window from
the seed and holds each to the plain reference (:mod:`benchmark.reference`)
on the same data and samples: the reference projects again, runs its own
GIGA to M in the configuration's select precision, and measures the error of
both answers against the same target, and which of its first atoms, each
the row best aligned with the residual over all the rows, the answer holds.

What the benchmark's own tests need of this kind of job: :func:`toy`, the
configuration cut to a toy size for the CPU; :func:`control_size`, the size
at which the control is shown to fail there; :data:`PLANTS`, the faults its
check must fail.  A job whose program side differs (an exact projector, say)
subclasses :class:`Job` and overrides :meth:`Job.inputs`, :meth:`Job.coreset`
and :meth:`Job.reference_rows`; the check's methods stay.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import data, harness, plants, reference
from ..harness import sync

KIND = "hilbert"
# the configuration's select precision -> the reference's select in the
# control, one precision below, and the tie: a score within this share of
# the best is a tie that rounding breaks either way (int8: one level of the
# direction moves a score by about this much)
PRECISIONS = {"float32": {"control": "bfloat16", "tie": 1e-4},
              "bfloat16": {"control": "int8", "tie": 1e-3},
              "int8": {"control": "int4", "tie": 1e-3}}
# the reference's first atoms that an answer must hold, where the cell's file
# sets no "early_atoms": sound int8 builds follow the reference's path past
# them, and part from it, if at all, after ten atoms or more
EARLY_ATOMS = 8
PLANTS = plants.PLANTS      # every fault of benchmark/plants.py


def toy(cfg: dict) -> dict:
    """What a configuration's toy cut for the CPU changes: N and M, and the
    chunk of a streamed one (S and D stay)."""
    if cfg.get("stream_chunk_size"):
        return {"N": 6000, "coreset_size": 40, "stream_chunk_size": 2500}
    return {"N": 3000, "coreset_size": 40}


def control_size(cfg: dict) -> dict:
    """What the toy cut's control test changes: a size at which the
    reference's path is long enough for the control to part from it."""
    return {"N": 20_000, "coreset_size": 200}


class Job:
    """One run's builds.  ``cfg`` is the configuration file's dict,
    ``traffic`` the mix's, ``cell`` the cell file's."""

    kind = KIND

    def __init__(self, cfg: dict, traffic: dict, cell: dict, seed: int, dev: torch.device):
        import bayesian_coresets_tpu_torch as bc

        self.bc, self.model = bc, harness.module("models", cfg["model"])
        path, name = self.model.PROGRAM_LOGLIK.split(":")
        self.loglik = getattr(importlib.import_module(path), name)
        self.cfg, self.traffic, self.cell, self.seed, self.dev = cfg, traffic, cell, seed, dev
        self.N, self.D, self.S = cfg["N"], cfg["D"], cfg["S"]
        self.M = cfg["coreset_size"]
        self.chunk = cfg.get("stream_chunk_size")
        self.select_dtype = cfg["select_dtype"]
        if self.select_dtype not in PRECISIONS:
            raise ValueError(f"no reference select for {self.select_dtype!r}")
        self.Z = self.inputs()
        self.answers = {}           # job index -> (weights, indices, points), numpy
        self.reference_errors = {}  # job index -> the error of the reference's GIGA
        self.spans = []             # with spans on: one dict of seconds per job

    # -- the program's side ---------------------------------------------------

    def inputs(self):
        """The run's data, made once from the seed."""
        return data.dataset(lambda gen, n: self.model.rows(gen, n, self.D), self.seed, self.N,
                            self.dev, on_host=self.chunk is not None)

    def theta(self, index: int, stream: int = data.THETA) -> torch.Tensor:
        return data.projection_samples(self.seed, index, self.S, self.D,
                                       self.traffic["projection_scale"], self.dev, stream)

    def coreset(self, theta: torch.Tensor):
        """The program's coreset of the run's data, projected on ``theta``."""
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
            coreset = self.coreset(theta)
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
        select precision (int8: rows and directions rounded to 127 levels),
        and for int8-resident constants the weights worked out on those
        rows.  ``control``: one precision below (:data:`PRECISIONS`)."""
        select = PRECISIONS[self.select_dtype]["control"] if control else self.select_dtype
        return reference.giga(sys_, M or self.M, select=select,
                              resident=self.chunk is not None, **kw)

    def reference_rows(self, index: int) -> torch.Tensor:
        """(N, S) float64: the reference's projection of build ``index``."""
        return reference.project(self.Z, self.theta(index), self.dev, self.model.loglik)

    def system(self, index: int) -> reference.System:
        return reference.System(self.reference_rows(index))

    def rows_at(self, idcs: np.ndarray) -> np.ndarray:
        """The data's rows at ``idcs``, numpy."""
        if torch.is_tensor(self.Z):
            return self.Z[torch.as_tensor(idcs).to(self.Z.device)].cpu().numpy()
        return np.asarray(self.Z[idcs])

    def reference_error(self, index: int, sys_: reference.System) -> float:
        """The error of the reference's GIGA for build ``index``, run once
        and kept."""
        if index not in self.reference_errors:
            self.reference_errors[index] = reference.relative_error(
                sys_, *self.reference_answer(sys_))
        return self.reference_errors[index]

    def early_atoms(self) -> int:
        """How many of the reference's first atoms an answer must hold: the
        cell's ``early_atoms``, else :data:`EARLY_ATOMS`, and at most M."""
        return min(self.cell.get("early_atoms", EARLY_ATOMS), self.M)

    def early_atoms_missed(self, sys_: reference.System, idcs: np.ndarray) -> int:
        """How many of the first :meth:`early_atoms` atoms of the reference's
        GIGA, following the answer ``idcs`` through ties, the answer lacks."""
        held = torch.zeros(sys_.V.shape[0], dtype=torch.bool, device=sys_.V.device)
        held[torch.as_tensor(idcs, device=held.device)] = True
        path, _ = self.reference_answer(sys_, M=self.early_atoms(), prefer=held,
                                        tie=PRECISIONS[self.select_dtype]["tie"])
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
        many of the reference's first :meth:`early_atoms` atoms the answer
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
        rows = self.rows_at(idcs[ok])
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
        return w.cpu().numpy(), idcs, self.rows_at(idcs)

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
