"""Hilbert-norm coresets: projection + sparse NNLS.

Port of the in-memory path of ``bayesian_coresets_tpu/coresets/hilbert.py``
(reference ``bayesiancoresets/coreset/hilbert.py:6-48``): discretize
log-likelihoods into per-datum feature vectors, form the system
A = vecs.T, b = sum of valid vecs, and hand it to a sparse-NNLS solver:
``snnls`` is GIGA (the default), FrankWolfe, OrthoPursuit,
ImportanceSampling or UniformSampling of :mod:`..ops.snnls`.  Weights map
back through the (optional) subsample indices.

The projection, the system and the solver stay on the data's device: a
tensor's own, else ``device``, else the default device (the CUDA card).
The subsample keeps a fixed shape: the reference's
``np.unique(np.random.randint(...))`` (hilbert.py:16) shrinks the array,
so here duplicate and zero-vector rows are masked ``valid=False`` instead.

``stream_chunk_size`` selects the streamed int8-resident construction of
the JAX package (hilbert.py:57-61, 100-168 there), for datasets whose f32
projection does not fit on the device: the data stays where the caller
keeps it (a numpy array or a CPU tensor), and chunk by chunk goes to the
device, is projected and quantized (:func:`..parallel.streamed.
quantize_chunk`), and is written into one int8 buffer allocated there
beforehand.  Only that buffer (N x S bytes) and the f32 row norms stay; the
solvers run on the int8-resident constants (``make_consts_quantized``).

``mesh`` (``parallel.make_mesh``, under an initialized process group; the
JAX package's hilbert.py:81-92, 170-253) shards the build over the ranks
of the mesh's data axis (on a mesh with other axes too, such as ``{"data":
2, "proj": 2}``, every line along the others runs the same build, as the
JAX facade shards the data axis only; a streamed build takes a 1-D data
mesh).  Every rank passes the same data and a projector
made alike (the same samples, from the same seed), and projects only its
own block of rows (``parallel/coreset.py``'s layout); b is the sum of the
ranks' partial sums, and the solver runs as one rank of the sharded build.
With ``stream_chunk_size`` too, each rank streams its own rows into its
own int8 buffer (:func:`..parallel.streamed.make_streamed_quantized_
consts`).  The JAX package's sharded stream traces the projector inside
``shard_map`` and so falls back to another route when the projector
cannot be traced or is not shard-safe (hilbert.py:215-253 there); here
every rank calls the projector's own ``project``, eagerly, so there is
no such fallback and no re-route.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..ops.snnls import GIGA, make_consts, make_consts_quantized
from ..parallel.comm import Comm
from ..parallel.coreset import local_rows, row_block
from ..parallel.mesh import DATA_AXIS
from ..parallel.streamed import (make_streamed_quantized_consts, stream_quantized,
                                 streamed_row_layout)
from ..utils import config
from ..utils.profiling import span
from .coreset import Coreset
from .projector import Projector

_serials = itertools.count(1)       # HilbertCoreset.serial, the id of its spans


def _device_of(data, device) -> torch.device:
    """The device a construction from ``data`` runs on: ``device``, else a
    tensor's own, else the default device."""
    if device is not None:
        return config.resolve_device(device)
    return data.device if isinstance(data, torch.Tensor) else config.default_device()


class HilbertCoreset(Coreset):
    def __init__(self, data: torch.Tensor, ll_projector: Projector,
                 n_subsample: int | None = None, snnls=GIGA, seed: int = 0,
                 max_active: int | None = None, select_dtype=None,
                 stream_chunk_size: int | None = None, device=None, mesh=None):
        super().__init__()
        self.serial = next(_serials)
        with span("hilbert.init", device=_device_of(data, device), coreset=self.serial):
            self._init(data, ll_projector, n_subsample, snnls, seed, max_active, select_dtype,
                       stream_chunk_size, device, mesh)

    def _init(self, data, ll_projector: Projector, n_subsample, snnls, seed: int, max_active,
              select_dtype, stream_chunk_size, device, mesh):
        if stream_chunk_size is not None:
            if n_subsample is not None:
                raise ValueError("stream_chunk_size and n_subsample are mutually exclusive "
                                 "(subsample the data first instead)")
            self._init_streamed(data, ll_projector, int(stream_chunk_size), snnls, seed,
                                max_active, device, mesh)
            return
        data = config.as_tensor(data, device=device)
        if n_subsample is None:
            sub_idcs = np.arange(data.shape[0])
            uniq = None
        else:
            # reference sampling distribution (randint-with-replacement then
            # dedup, hilbert.py:16) at a fixed shape via masking
            rng = np.random.default_rng(seed)
            sub_idcs = rng.integers(0, data.shape[0], size=n_subsample)
            uniq = np.zeros(n_subsample, dtype=bool)
            uniq[np.unique(sub_idcs, return_index=True)[1]] = True
        lo, per = (0, len(sub_idcs)) if mesh is None else row_block(len(sub_idcs), mesh)
        mine = slice(min(lo, len(sub_idcs)), lo + per)       # this rank's rows
        if n_subsample is None:
            pts = data[mine] if mesh is not None else data
        else:
            pts = data[torch.as_tensor(sub_idcs[mine], device=data.device)]
        with span("hilbert.project"):
            vecs = ll_projector.project(pts)
            valid = (torch.ones(vecs.shape[0], dtype=torch.bool, device=vecs.device)
                     if uniq is None else torch.as_tensor(uniq[mine], device=vecs.device))
            # mask zero vectors instead of pruning (hilbert.py:20-22)
            valid = valid & (torch.sqrt(torch.sum(vecs**2, dim=1)) > 0.0)
            b = vecs[valid].sum(dim=0)
        with span("hilbert.consts"):
            if mesh is None:
                if not bool(valid.any()):
                    raise ValueError("all projected vectors are zero or masked")
                self.snnls = snnls(vecs.T, b, valid=valid, seed=seed,
                                   max_active=max_active, select_dtype=select_dtype)
            else:
                comm = Comm(mesh, DATA_AXIS, per)
                b = comm.sum(b, "setup")
                if not bool(comm.sum(torch.sum(valid).double(), "setup") > 0):
                    raise ValueError("all projected vectors are zero or masked")
                sampling = snnls.method if snnls.method in ("importance", "uniform") else None
                consts = make_consts(local_rows(vecs, 0, per).T, b,
                                     valid=local_rows(valid, 0, per, False),
                                     select_dtype=select_dtype, sampling=sampling, comm=comm)
                self.snnls = snnls.from_consts(consts, seed=seed, max_active=max_active,
                                               mesh=mesh)
        self.sub_idcs = sub_idcs
        self.data = data

    def _init_streamed(self, data, ll_projector: Projector, chunk: int, snnls_cls, seed: int,
                       max_active, device, mesh):
        """Chunked projection -> int8 quantization on the device -> the
        int8-resident solver constants (hilbert.py:100-168 there).  The
        device is ``device``, else a tensor's own, else the default device;
        the data itself is never copied there whole.  With ``mesh`` each
        rank streams its own rows (hilbert.py:170-253 there)."""
        if chunk <= 0:
            raise ValueError(f"stream_chunk_size must be positive; got {chunk}")
        if mesh is not None and tuple(mesh.axis_names) != (DATA_AXIS,):
            raise ValueError(f"a streamed-sharded construction takes a 1-D '{DATA_AXIS}' mesh "
                             "(int8-resident builds are data-parallel only)")
        if not isinstance(data, torch.Tensor):
            data = np.asarray(data)
        dev = _device_of(data, device)

        def rows(lo: int, hi: int) -> torch.Tensor:
            return torch.as_tensor(data[lo:hi]).to(dev)

        n = data.shape[0]
        sampling = snnls_cls.method if snnls_cls.method in ("importance", "uniform") else None
        with span("hilbert.project"):
            # chunks are consistent only if the projector keeps one context
            # across project() calls (a projector that resamples inside
            # project() would put each chunk in another basis): the same
            # row projected twice must give the same vector
            sentinel = rows(0, 1)
            probe = ll_projector.project(sentinel)
            if not torch.equal(probe, ll_projector.project(sentinel)):
                raise ValueError(
                    "stream_chunk_size requires a projector with a fixed context across "
                    "project() calls; this one returned different vectors for the same input "
                    "(does it resample inside project()?)")
            if mesh is not None:
                sl = streamed_row_layout(n, mesh)[3]
                consts = make_streamed_quantized_consts(
                    data[sl], ll_projector.project, chunk, mesh, n, sampling=sampling,
                    S=int(probe.shape[1]), device=dev)
            else:
                buf, norms, b = stream_quantized(rows, n, n, ll_projector.project, chunk, dev)
        with span("hilbert.consts"):
            if mesh is not None:
                self.snnls = snnls_cls.from_consts(consts, seed=seed, max_active=max_active,
                                                   mesh=mesh)
            else:
                valid = norms > 0
                if not bool(valid.any()):
                    raise ValueError("all projected vectors are zero or masked")
                consts = make_consts_quantized(buf, norms, b.float(), valid=valid,
                                               sampling=sampling)
                self.snnls = snnls_cls.from_consts(consts, seed=seed, max_active=max_active)
        self.sub_idcs = np.arange(n)
        self.data = data

    def reset(self):
        self.snnls.reset()
        super().reset()

    def _sync(self):
        with span("hilbert.active", device=self.snnls.consts.V.device, coreset=self.serial):
            # active-set extraction on the device: O(max_active) values
            # cross to the host instead of the (n,) weight vector
            idx, vals = self.snnls.active()
            keep = (idx >= 0) & (idx < len(self.sub_idcs))
            idx, vals = idx[keep], vals[keep]
            order = np.argsort(idx)            # stable order by solver column
            self.wts = vals[order]
            self.idcs = self.sub_idcs[idx[order]]
            if isinstance(self.data, torch.Tensor):
                rows = torch.as_tensor(self.idcs, device=self.data.device)
                self.pts = self.data[rows].cpu().numpy()
            else:                             # a streamed build's data, kept where it was given
                self.pts = self.data[self.idcs]
            self.reached_numeric_limit = self.snnls.reached_numeric_limit

    def _build(self, itrs: int):
        with span("hilbert.solve", device=self.snnls.consts.V.device, coreset=self.serial):
            self.snnls.build(itrs)
            self._sync()

    def _optimize(self):
        self.snnls.optimize()
        self._sync()

    def error(self) -> float:
        return self.snnls.error()
