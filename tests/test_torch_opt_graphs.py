"""SparseVI's and BatchPSVI's Adam steps in segments, on the CPU.

``ops/opt.py::nn_opt`` runs its steps in segments of K; on a CUDA device
each segment is a replayed CUDA graph, here the same segments run
directly.  Every K, and ``graphs=False``, must give what K = 1 gives, bit
for bit: the iterates, the carried state (the warm Laplace mode) and the
generator's state after, for SparseVI and BatchPSVI on the exact Gaussian
family, the Gaussian basis sampler and the logistic driver's warm Laplace
refit.  The steps run under a dispatch mode that raises on every op that
reads a value back to the host (``_linalg_check_errors`` is the read that
``torch.linalg.cholesky`` makes to raise; ``_linalg_eigh`` makes its own);
and the replaying path's bookkeeping (static buffers made once per shape,
the step constants and the slot count copied in per call, the carry
copied out) runs with a stand-in that calls each segment where a card
would capture and replay it.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import bayesian_coresets_tpu_torch as bc
from bayesian_coresets_tpu_torch.coresets import bpsvi, sparsevi
from bayesian_coresets_tpu_torch.experiments.logistic_poisson import laplace_refits
from bayesian_coresets_tpu_torch.models import gaussian, logistic
from bayesian_coresets_tpu_torch.ops import graphs, opt

torch.set_num_threads(1)

SEGMENTS = (3, 7, 50)
HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "_unique", "_unique2",
              "unique_dim", "unique_consecutive", "_linalg_check_errors", "_linalg_eigh"}


def _sched(i):
    return 1.0 / (1.0 + i)


def _problem(kind, n=300, d=5, S=40):
    """(data, family): the exact Gaussian family, the Gaussian basis
    sampler, or the logistic driver's warm Laplace refit."""
    if kind == "logistic":
        x = logistic.gen_synthetic(torch.Generator().manual_seed(5), n, d)
        sampler, warm, init = laplace_refits(logistic, d, torch.device("cpu"))
        return x, bc.coresets.blackbox_family(sampler, S, logistic.log_likelihood,
                                              logistic.grad_z_log_likelihood,
                                              warm_sampler=warm, init_carry=init)
    x = torch.as_tensor((1.0 + np.random.default_rng(0).normal(size=(n, d))).astype(np.float32))
    mu0, eye = torch.zeros(d), torch.eye(d)
    basis = gaussian.posterior_basis(mu0, eye, eye)
    if kind == "exact":
        return x, bc.gaussian_tangent_family(mu0, eye, eye, eye, basis=basis)

    def sampler(g, k, w, p):
        if p.numel() == 0:
            w, p = torch.zeros(1), torch.zeros((1, d))
        return gaussian.sample_weighted_post_basis(g, basis, p, w, k)

    return x, bc.coresets.blackbox_family(
        sampler, S, lambda p, th: gaussian.log_likelihood(p, th, eye, 0.0),
        lambda p, th: gaussian.grad_x_log_likelihood(p, th, eye))


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def _same(a, b):
    """Two nested results equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))
        return
    if isinstance(a, (int, float)):
        assert a == b
        return
    for x, y in zip(a, b, strict=True):
        _same(x, y)


def _svi(kind, segment, graphs=None, cap=8, itrs=4, opt_itrs=17):
    """A build of ``itrs`` selects from empty, then one from its end (a
    resumed build), then the carried state of one more optimize:
    everything bit for bit comparable."""
    x, fam = _problem(kind)
    gen = torch.Generator().manual_seed(2)
    kw = dict(family=fam, n_sub_sel=128, n_sub_opt=128, opt_itrs=opt_itrs, step_sched=_sched,
              graphs=graphs, segment=segment)
    w, i, size = sparsevi.svi_build(x, torch.zeros(cap), torch.full((cap,), -1), 0, gen,
                                    itrs, **kw)
    w2, i2, size2 = sparsevi.svi_build(x, w, i, size, gen, 2, **kw)
    pts = sparsevi._gather_pts(x, i2)
    carry = sparsevi._init_carry(x, fam, w2, pts, size2)
    w3, carry3 = sparsevi._optimize(x, fam, gen, w2, pts, size2, 128, opt_itrs, _sched, carry,
                                    graphs=graphs, segment=segment)
    return (w, i, size, w2, i2, size2, w3, carry3, gen.get_state())


def _bpsvi(kind, segment, graphs=None, sz=6, opt_itrs=17):
    x, fam = _problem(kind)
    gen = torch.Generator().manual_seed(4)
    init = bpsvi.uniform_init_idcs(x.shape[0], sz, gen)
    w, p = bpsvi.bpsvi_build(x, init, gen, family=fam, n_sub_opt=128, opt_itrs=opt_itrs,
                             step_sched=_sched, graphs=graphs, segment=segment)
    return w, p, gen.get_state()


# ------------------------------------------- segments against one step


@pytest.mark.parametrize("segment", SEGMENTS)
@pytest.mark.parametrize("kind", ["exact", "basis", "logistic"])
def test_svi_segments_equal_one_step_segments(kind, segment):
    """SparseVI in segments of 3, 7 (17 steps: a tail) and 50 (one tail
    segment longer than the run) against segments of one step, and
    ``graphs=False``: weights, indices, sizes, a resumed build, the warm
    carry and the generator, bit for bit."""
    ref = _svi(kind, 1)
    _same(_svi(kind, segment), ref)
    _same(_svi(kind, segment, graphs=False), ref)
    assert 0 < ref[2] <= 4 and ref[5] > ref[2] - 1


@pytest.mark.parametrize("segment", SEGMENTS)
@pytest.mark.parametrize("kind", ["exact", "basis", "logistic"])
def test_bpsvi_segments_equal_one_step_segments(kind, segment):
    ref = _bpsvi(kind, 1)
    _same(_bpsvi(kind, segment), ref)
    _same(_bpsvi(kind, segment, graphs=False), ref)
    assert bool(torch.isfinite(ref[0]).all()) and bool((ref[0] >= 0).all())


def test_segments_match_the_unsegmented_recursion():
    """The segmented steps against the recursion written out with Python
    indices (the loop before segments), bit for bit, with a carry."""
    t = torch.as_tensor(np.random.default_rng(1).normal(size=9).astype(np.float32))

    def grad_fn(x, g, aux):
        return x - t + 0.1 * torch.randn(x.shape, generator=g), aux + x

    b1, b2, eps, n = 0.9, 0.999, 1e-8, 23
    g = torch.Generator().manual_seed(3)
    steps = torch.arange(n, dtype=torch.float32)
    lr, c1, c2 = _sched(steps), 1.0 - torch.pow(b1, steps + 1.0), 1.0 - torch.pow(b2, steps + 1.0)
    x, aux, m1, m2 = torch.zeros(9), torch.zeros(9), torch.zeros(9), torch.zeros(9)
    for i in range(n):
        gr, aux = grad_fn(x, g, aux)
        m1 = b1 * m1 + (1.0 - b1) * gr
        m2 = b2 * m2 + (1.0 - b2) * gr * gr
        x = x - lr[i] * (m1 / c1[i]) / (eps + torch.sqrt(m2 / c2[i]))
        x = torch.clamp_min(x, 0.0)
    for K in (1, 4, 23, 30):
        g2 = torch.Generator().manual_seed(3)
        got = opt.nn_opt(torch.zeros(9), grad_fn, g2, opt_itrs=n, step_sched=_sched,
                         aux0=torch.zeros(9), segment=K)
        _same(got, (x, aux))
        assert torch.equal(g2.get_state(), g.get_state())


def test_segment_plan_and_refusals():
    assert opt.segments(17, 7) == [7, 7, 3] and opt.segments(17, 50) == [17]
    assert opt.segments(20, 5) == [5] * 4 and opt.segments(0, 5) == []
    with pytest.raises(ValueError, match="segment"):
        opt.nn_opt(torch.zeros(2), lambda x, g: x, torch.Generator(), opt_itrs=3, segment=0)
    with pytest.raises(ValueError, match="graphs=False"):
        opt.nn_opt(torch.zeros(2), lambda x, g: x, torch.Generator(), opt_itrs=3, graphs=True)
    with pytest.raises(ValueError, match="directly"):
        sparsevi._graphs(True, object())
    assert sparsevi._graphs(None, object()) is False and sparsevi._graphs(None, None) is None


# ------------------------------------------------------ no host read


class _NoHostRead(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in HOST_READS:
            raise AssertionError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["exact", "basis", "logistic"])
def test_adam_steps_read_nothing_back(kind):
    """A SparseVI optimize and a BatchPSVI build, all their segments, on
    device values alone: the Laplace refit's Cholesky factors included
    (``torch.linalg.cholesky`` would check its error code)."""
    x, fam = _problem(kind)
    w, i, size = sparsevi.svi_build(x, torch.zeros(8), torch.full((8,), -1), 0,
                                    torch.Generator(), 3, family=fam, n_sub_sel=None,
                                    n_sub_opt=None, opt_itrs=3, step_sched=_sched)
    pts = sparsevi._gather_pts(x, i)
    carry = sparsevi._init_carry(x, fam, w, pts, size)
    init = bpsvi.uniform_init_idcs(x.shape[0], 5, torch.Generator())
    with _NoHostRead():
        sparsevi._optimize(x, fam, torch.Generator(), w, pts, size, None, 12, _sched, carry,
                           segment=5)
        bpsvi.bpsvi_build(x, init, torch.Generator(), family=fam, n_sub_opt=64, opt_itrs=12,
                          step_sched=_sched, segment=5)
    with _NoHostRead(), pytest.raises(AssertionError, match="host read"):
        torch.linalg.cholesky(torch.eye(3))


# -------------------------------------------- the replaying bookkeeping


class _Direct:
    """Stands in for ``ops.graphs.Graphs`` on the CPU: each segment runs
    where a card would replay its graph, on the same static buffers."""

    made = []

    def __init__(self, tensors, static, derived, gen, warm=False, kind=None):
        self.static, self.gen, self.warm, self.keys = static, gen, warm, []
        _Direct.made.append(self)

    def run(self, key, fn):
        self.keys.append(key)
        fn()


def _stand_in(monkeypatch):
    """Replay on the CPU through :class:`_Direct`, cached as
    ``graphs_for`` caches (by anchor, key and generator)."""
    cache = {}

    def graphs_for(tensors, key, gen, make_static, make_derived=lambda: None, warm=False):
        k = (id(tensors[0]), key)
        if k not in cache or cache[k].gen is not gen:
            cache[k] = _Direct(tensors, make_static(), make_derived(), gen, warm)
        return cache[k]

    monkeypatch.setattr(graphs, "Graphs", _Direct)
    monkeypatch.setattr(graphs, "graphs_for", graphs_for)
    monkeypatch.setattr(opt, "replaying", lambda dev, g: g is not False)
    _Direct.made.clear()


@pytest.mark.parametrize("kind", ["exact", "logistic"])
def test_replaying_bookkeeping_equals_direct(kind, monkeypatch):
    """The replaying path with a stand-in for the graphs: SparseVI's
    builds, resumed build and optimize, and BatchPSVI's, give the direct
    results bit for bit; one set of static buffers serves every optimize
    of the builds (the slot count is a buffer), one more the BatchPSVI
    run; the segments' keys are their lengths; a result is a tensor of
    its own, not the buffer."""
    ref_svi, ref_bp = _svi(kind, 7, graphs=False), _bpsvi(kind, 7, graphs=False)
    _stand_in(monkeypatch)
    _same(_svi(kind, 7), ref_svi)
    assert len(_Direct.made) == 1 and _Direct.made[0].warm
    e = _Direct.made[0]
    assert e.keys == [7, 7, 3] * (4 + 2 + 1)
    st, sp = e.static
    assert isinstance(st, opt.State) and isinstance(sp, opt.Sched)
    assert int(st.i) == 17 and sp.lr.shape == (17,) and sp.inputs[0].shape == (8, 5)
    assert int(sp.inputs[1]) == ref_svi[5]          # the last optimize's slot count
    _same(st.aux, ref_svi[7])                       # the carry left in the buffers
    _same(_bpsvi(kind, 7), ref_bp)
    assert len(_Direct.made) == 2 and _Direct.made[1].keys == [7, 7, 3]


def test_uncached_nn_opt_makes_its_own_buffers(monkeypatch):
    """nn_opt without a cache: graphs of its own per call, its step
    constants in the buffers (a schedule is not baked in)."""
    _stand_in(monkeypatch)

    def grad_fn(x, g):
        return x - 1.0 + 0.1 * torch.randn(x.shape, generator=g)

    out = [opt.nn_opt(torch.zeros(4), grad_fn, torch.Generator().manual_seed(0), opt_itrs=9,
                      step_sched=s, segment=4) for s in (_sched, lambda i: 0.05)]
    ref = [opt.nn_opt(torch.zeros(4), grad_fn, torch.Generator().manual_seed(0), opt_itrs=9,
                      step_sched=s, segment=4, graphs=False) for s in (_sched, lambda i: 0.05)]
    _same(out, ref)
    assert len(_Direct.made) == 2 and [e.keys for e in _Direct.made] == [[4, 4, 1]] * 2
    assert torch.equal(_Direct.made[1].static[1].lr, torch.full((9,), 0.05))
    # a result is a tensor of its own, not the buffer the next call writes
    assert out[1].data_ptr() != _Direct.made[1].static[0].x.data_ptr()


def test_svi_graph_key_follows_capacity_and_family(monkeypatch):
    """Capacity doubling and another family take other buffers; the same
    facade's later builds and optimize reuse them."""
    _stand_in(monkeypatch)
    x, fam = _problem("exact")
    c = bc.SparseVICoreset(x, fam, opt_itrs=6, segment=4)
    c.build(3)                      # 8 slots
    c.build(2)
    c.optimize()
    assert len(_Direct.made) == 1
    c.build(6)                      # 11 atoms at most: 16 slots
    assert len(_Direct.made) == 2 and _Direct.made[1].static[0].x.shape == (16,)
    _, fam2 = _problem("basis")
    bc.SparseVICoreset(x, fam2, opt_itrs=6, segment=4).build(2)
    assert len(_Direct.made) == 3
