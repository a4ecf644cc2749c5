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
Mesh-sharded construction is ROADMAP item 16.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.giga_select import col_multiple
from ..ops.snnls import GIGA, make_consts_quantized
from ..parallel.streamed import quantize_chunk, round_up
from ..utils import config
from .coreset import Coreset
from .projector import Projector


class HilbertCoreset(Coreset):
    def __init__(self, data: torch.Tensor, ll_projector: Projector,
                 n_subsample: int | None = None, snnls=GIGA, seed: int = 0,
                 max_active: int | None = None, select_dtype=None,
                 stream_chunk_size: int | None = None, device=None):
        super().__init__()
        if stream_chunk_size is not None:
            if n_subsample is not None:
                raise ValueError("stream_chunk_size and n_subsample are mutually exclusive "
                                 "(subsample the data first instead)")
            self._init_streamed(data, ll_projector, int(stream_chunk_size), snnls, seed,
                                max_active, device)
            return
        data = config.as_tensor(data, device=device)
        if n_subsample is None:
            sub_idcs = np.arange(data.shape[0])
            vecs = ll_projector.project(data)
            valid = torch.ones(data.shape[0], dtype=torch.bool, device=vecs.device)
        else:
            # reference sampling distribution (randint-with-replacement then
            # dedup, hilbert.py:16) at a fixed shape via masking
            rng = np.random.default_rng(seed)
            sub_idcs = rng.integers(0, data.shape[0], size=n_subsample)
            uniq = np.zeros(n_subsample, dtype=bool)
            uniq[np.unique(sub_idcs, return_index=True)[1]] = True
            vecs = ll_projector.project(data[torch.as_tensor(sub_idcs, device=data.device)])
            valid = torch.as_tensor(uniq, device=vecs.device)
        # mask zero vectors instead of pruning (hilbert.py:20-22)
        valid = valid & (torch.sqrt(torch.sum(vecs**2, dim=1)) > 0.0)
        if not bool(valid.any()):
            raise ValueError("all projected vectors are zero or masked")
        b = vecs[valid].sum(dim=0)
        self.snnls = snnls(vecs.T, b, valid=valid, seed=seed,
                           max_active=max_active, select_dtype=select_dtype)
        self.sub_idcs = sub_idcs
        self.data = data

    def _init_streamed(self, data, ll_projector: Projector, chunk: int, snnls_cls, seed: int,
                       max_active, device):
        """Chunked projection -> int8 quantization on the device -> the
        int8-resident solver constants (hilbert.py:100-168 there).  The
        device is ``device``, else a tensor's own, else the default device;
        the data itself is never copied there whole."""
        if chunk <= 0:
            raise ValueError(f"stream_chunk_size must be positive; got {chunk}")
        if isinstance(data, torch.Tensor):
            dev = config.resolve_device(device) if device is not None else data.device
        else:
            data = np.asarray(data)
            dev = config.resolve_device(device) if device is not None else config.default_device()

        def rows(lo: int, hi: int) -> torch.Tensor:
            return torch.as_tensor(data[lo:hi]).to(dev)

        # chunks are consistent only if the projector keeps one context
        # across project() calls (a projector that resamples inside
        # project() would put each chunk in another basis): the same row
        # projected twice must give the same vector
        sentinel = rows(0, 1)
        if not torch.equal(ll_projector.project(sentinel), ll_projector.project(sentinel)):
            raise ValueError(
                "stream_chunk_size requires a projector with a fixed context across "
                "project() calls; this one returned different vectors for the same input "
                "(does it resample inside project()?)")

        n = data.shape[0]
        buf = b = None
        norms = []
        for lo in range(0, n, chunk):
            live = min(chunk, n - lo)
            xc = rows(lo, lo + live)
            if live < chunk:                  # the last chunk, zero-padded to the chunk size
                xc = torch.cat([xc, xc.new_zeros((chunk - live,) + xc.shape[1:])])
            q, nrm, bsum = quantize_chunk(ll_projector.project(xc), live)
            if buf is None:
                # allocated once, columns pre-padded to whole 16-byte rows, so
                # make_consts_quantized uses it as it is
                S = q.shape[1]
                buf = torch.zeros((n, round_up(S, col_multiple(torch.int8))), dtype=torch.int8,
                                  device=dev)
                b = torch.zeros(S, dtype=torch.float64, device=dev)
            buf[lo:lo + live, :S].copy_(q[:live])
            b += bsum
            norms.append(nrm[:live])
            del q, nrm, bsum, xc
        norms = torch.cat(norms)
        valid = norms > 0
        if not bool(valid.any()):
            raise ValueError("all projected vectors are zero or masked")
        sampling = snnls_cls.method if snnls_cls.method in ("importance", "uniform") else None
        consts = make_consts_quantized(buf, norms, b.float(), valid=valid, sampling=sampling)
        self.snnls = snnls_cls.from_consts(consts, seed=seed, max_active=max_active)
        self.sub_idcs = np.arange(n)
        self.data = data

    def reset(self):
        self.snnls.reset()
        super().reset()

    def _sync(self):
        # active-set extraction on the device: O(max_active) values cross
        # to the host instead of the (n,) weight vector
        idx, vals = self.snnls.active()
        keep = (idx >= 0) & (idx < len(self.sub_idcs))
        idx, vals = idx[keep], vals[keep]
        order = np.argsort(idx)            # stable order by solver column
        self.wts = vals[order]
        self.idcs = self.sub_idcs[idx[order]]
        if isinstance(self.data, torch.Tensor):
            self.pts = self.data[torch.as_tensor(self.idcs, device=self.data.device)].cpu().numpy()
        else:                                 # a streamed build's data, kept where it was given
            self.pts = self.data[self.idcs]
        self.reached_numeric_limit = self.snnls.reached_numeric_limit

    def _build(self, itrs: int):
        self.snnls.build(itrs)
        self._sync()

    def _optimize(self):
        self.snnls.optimize()
        self._sync()

    def error(self) -> float:
        return self.snnls.error()
