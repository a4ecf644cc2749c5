"""NUTS's index-free leaf body and its segments of leaves, on the CPU.

``mcmc/nuts.py`` runs a transition's leaves in segments of K with one host
read between segments; on a CUDA device each segment is a replayed CUDA
graph, here the same pieces run directly.  Every K must give what K = 1
gives, bit for bit: samples, infos, adapted step sizes and metrics, and the
generator's state after, since a doubling's leaf uniforms are drawn in one
block when it begins (``mcmc/draws.py``).  The body is held to the JAX
kernel on replayed draws (rtol 1e-5 on states, depths and step counts
exactly, as ``tests/test_torch_mcmc.py`` holds one transition); the
pieces run under a dispatch mode that raises on every op that reads a
value back to the host; and the replaying path's bookkeeping (static
buffers, the first transition's template, a doubling's uniforms in the
first rows of their buffer) runs with a stand-in that calls each piece
where a card would capture and replay it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bayesian_coresets_tpu.mcmc import integrators as jint
from bayesian_coresets_tpu.mcmc import nuts as jnuts
from bayesian_coresets_tpu_torch import mcmc
from bayesian_coresets_tpu_torch.mcmc import draws as tdraws
from bayesian_coresets_tpu_torch.mcmc import integrators as tint
from bayesian_coresets_tpu_torch.mcmc import nuts as tnuts
from bayesian_coresets_tpu_torch.ops import graphs
from test_torch_mcmc import C, D, JaxDraws, _close, _densities, _metric, _start, _t

torch.set_num_threads(1)

SEGMENTS = (2, 4, 8)
HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "_unique", "_unique2",
              "unique_dim", "unique_consecutive"}


def _gauss(cov):
    prec = torch.linalg.inv(torch.as_tensor(cov, dtype=torch.float32))
    return lambda th: -0.5 * torch.sum((th @ prec) * th, dim=-1)


COV = [[2.0, 1.2, 0.0], [1.2, 1.5, 0.3], [0.0, 0.3, 0.5]]


def _same(a, b):
    """Two nested results equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.is_floating_point():
            kind = {4: torch.int32, 8: torch.int64}[a.element_size()]
            a, b = a.contiguous().view(kind), b.contiguous().view(kind)
        assert torch.equal(a, b)
        return
    for x, y in zip(a, b, strict=True):
        _same(x, y)


# ------------------------------------------------------ against JAX


@pytest.mark.parametrize("segment", [1, 4])
@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_segmented_transition_matches_jax(kind, segment):
    """The index-free body in segments of 1 and 4 leaves against the vmapped
    JAX kernel on replayed draws, at three step sizes (deep, middling and
    shallow trees): new z, logp, grad (rtol 1e-5), depth, leapfrog count and
    divergence exactly."""
    jvg, tvg = _densities()
    z, lp, g = _start(jvg)
    im = _metric(kind)
    steps = np.array([0.05, 0.3, 0.8], np.float32)
    keys = jax.random.split(jax.random.key(11), C)
    jst, jinfo = jax.jit(jax.vmap(lambda k, z, lp, g, st, im: jnuts.nuts_kernel(
        jvg, k, jint.IntegratorState(z, jnp.zeros_like(z), lp, g), st, im, max_depth=6)))(
        keys, *map(jnp.asarray, (z, lp, g, steps, im)))
    tst, tinfo = mcmc.Transitions(tvg, JaxDraws(keys, "nuts"), 6, segment)(
        tint.IntegratorState(_t(z), torch.zeros(C, D), _t(lp), _t(g)), _t(steps), _t(im))
    np.testing.assert_array_equal(tinfo.depth.numpy(), np.asarray(jinfo.depth))
    np.testing.assert_array_equal(tinfo.num_steps.numpy(), np.asarray(jinfo.num_steps))
    np.testing.assert_array_equal(tinfo.diverging.numpy(), np.asarray(jinfo.diverging))
    assert len(set(tinfo.depth.tolist())) > 1
    for a, b in zip(tst, jst):
        _close(a, b)
    _close(tinfo.accept_prob, jinfo.accept_prob)


# ------------------------------------------- segments against K = 1


def _run(segment, pooled, dense, seed=3):
    gen = torch.Generator().manual_seed(seed)
    init = torch.as_tensor(np.random.default_rng(seed).normal(size=(6, 3)).astype(np.float32))
    res = mcmc.run_nuts(_gauss(COV), init, gen, num_warmup=150, num_samples=15,
                        pooled_adaptation=pooled, dense_mass=dense, segment=segment)
    return res, gen.get_state()


_REFS = {}


@pytest.mark.parametrize("segment", SEGMENTS)
@pytest.mark.parametrize("pooled", [False, True], ids=["per_chain", "pooled"])
@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_segments_equal_one_leaf_runs(dense, pooled, segment):
    """A whole run (150 warm-up transitions through a metric window and
    its boundary's step-size search, 15 draws): samples, acceptance,
    divergences, adapted step sizes and metrics, tree depths and the
    generator's state after, bit for bit."""
    key = (dense, pooled)
    if key not in _REFS:
        _REFS[key] = _run(1, pooled, dense)
    ref, ref_gen = _REFS[key]
    res, gen = _run(segment, pooled, dense)
    _same(res, ref)
    assert torch.equal(gen, ref_gen)
    assert float(ref.tree_depth.max()) >= 2


def _transitions(vg, z, step, inv_mass, segment, n, max_depth, seed=1):
    gen = torch.Generator().manual_seed(seed)
    st = tint.IntegratorState(z, torch.zeros_like(z), *vg(z))
    kern = mcmc.Transitions(vg, gen, max_depth, segment)
    out = []
    for _ in range(n):
        st, info = kern(st, step, inv_mass)
        out.append((st, info))
    return out, gen.get_state()


class _Poisoned(torch.autograd.Function):
    """Finite logp everywhere, but the gradient overflows beyond |x0| > 1.5
    (``tests/test_torch_mcmc.py::TestPoisonedStateRobustness``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return -0.5 * torch.sum(x**2, dim=-1)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        bad = torch.where(torch.abs(x[:, :1]) > 1.5, float("inf"), 1.0)
        return g[:, None] * (-x * bad)


def _cliff(th):
    """A Gaussian with one very narrow direction: a large step diverges."""
    return -0.5 * (th[:, 0] ** 2 + (th[:, 1] / 0.01) ** 2)


SCENARIOS = {
    # (logdensity, chains, d, step per chain, max_depth, transitions)
    "max_depth": (lambda th: -0.5 * torch.sum(th**2, dim=-1), 3, 2, [1e-3, 2e-3, 0.5], 5, 4),
    "divergent": (_cliff, 4, 2, [0.005, 0.004, 0.3, 0.006], 8, 6),
    "poisoned": (_Poisoned.apply, 4, 3, [0.6] * 4, 6, 40),
}


@pytest.mark.parametrize("segment", SEGMENTS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_segments_equal_one_leaf_transitions(scenario, segment):
    """Transitions that reach ``max_depth``, a chain that diverges, and the
    chain whose gradient overflows: every state and info, and the
    generator's state after, bit for bit."""
    fn, c, d, steps, max_depth, n = SCENARIOS[scenario]
    vg = tint.value_and_grad(fn)
    z = 0.3 * torch.ones((c, d))
    step, im = torch.tensor(steps), torch.ones((c, d))
    ref, ref_gen = _transitions(vg, z, step, im, 1, n, max_depth)
    out, gen = _transitions(vg, z, step, im, segment, n, max_depth)
    _same(out, ref)
    assert torch.equal(gen, ref_gen)
    infos = [info for _, info in ref]
    if scenario == "max_depth":
        assert any(int(i.depth.max()) == max_depth for i in infos)
    elif scenario == "divergent":
        assert any(bool(i.diverging.any()) for i in infos)
        assert any(bool((~i.diverging).any()) for i in infos)
    else:
        assert all(bool(torch.isfinite(s.grad).all()) for s, _ in ref)


def _expected_counts(info, segment, max_depth):
    """Leaf steps and host reads of one transition from its chains' depths
    and leapfrog counts: every doubling but a chain's last is whole, so
    doubling j runs as many leaves as its longest chain takes there."""
    depth, steps = info.depth.tolist(), info.num_steps.tolist()
    top = max(depth)
    leaves = reads = 0
    for j in range(top):
        n = 1 << j
        taken = [n if dc - 1 > j else s - (n - 1) for dc, s in zip(depth, steps) if dc > j]
        L = min(segment, n)
        segs = -(-max(taken) // L)
        leaves += segs * L
        reads += (j > 0) + (segs - 1) + (segs * L < n)
    return leaves, reads + (top < max_depth)


@pytest.mark.parametrize("segment", [1, 4])
def test_leaf_steps_and_host_reads(segment):
    """``leaf_steps`` counts the batched leaves run, gated ones included, and
    ``host_reads`` the reads of a flag: one before each doubling but the
    first, one before each segment but a doubling's first, and the one that
    ends a doubling or the tree early."""
    vg = tint.value_and_grad(_gauss(COV))
    z = torch.as_tensor(np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32))
    gen = torch.Generator().manual_seed(2)
    st = tint.IntegratorState(z, torch.zeros_like(z), *vg(z))
    kern = mcmc.Transitions(vg, gen, 7, segment)
    saw_partial = False
    for step in (0.05, 0.2, 0.7, 0.2, 0.05):
        tnuts.host_reads = tnuts.leaf_steps = 0
        st, info = kern(st, step, torch.ones((5, 3)))
        assert (tnuts.leaf_steps, tnuts.host_reads) == _expected_counts(info, segment, 7)
        saw_partial |= any(bool(((info.num_steps + 1) & info.num_steps != 0)[k])
                           for k in range(5))
    assert saw_partial            # some chain stopped inside a subtree


# ------------------------------------------------------ no host read


class _NoHostRead(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in HOST_READS:
            raise AssertionError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_pieces_read_nothing_back(kind):
    """The transition's start, a doubling's start, a segment of leaves and
    the merge, on device values alone (a capture of them would raise on a
    read); the loop's reads happen between them."""
    vg = tint.value_and_grad(_gauss(COV))
    z = torch.as_tensor(np.random.default_rng(1).normal(size=(4, 3)).astype(np.float32))
    im = torch.as_tensor(_metric(kind, c=4, d=3))
    kern = mcmc.Transitions(vg, torch.Generator().manual_seed(0), 6, 4)
    kern._replaying(z.device)
    pieces = []

    def run(key, fn, c):
        pieces.append(key if isinstance(key, str) else key[0])
        with _NoHostRead():
            return fn(c)

    c = tnuts._Carry(z, *vg(z), torch.full((4,), 0.2), im, tint.mass_chol(im), None, None)
    kern._transition(c, run)
    assert {"begin", "open", "leaves", "merge"} <= set(pieces)


# -------------------------------------------- the replaying bookkeeping


class _Direct:
    """Stands in for ``ops.graphs.Graphs`` on the CPU: each piece runs where
    a card would replay its graph, on the same static buffers."""

    made = []

    def __init__(self, tensors, static, derived, gen, warm=False, kind=None):
        self.static, self.gen, self.keys = static, gen, []
        _Direct.made.append(self)

    def run(self, key, fn):
        self.keys.append(key)
        fn()


@pytest.mark.parametrize("segment", [1, 4])
@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_replaying_bookkeeping_equals_direct(kind, segment, monkeypatch):
    """The replaying path's first transition (direct, the template of the
    static buffers) and the later ones on those buffers, with a stand-in
    for the graphs: the same states, infos and generator state as the
    direct transitions, bit for bit; buffers made once, a doubling's leaf
    uniforms in the first rows of a 2^(max_depth-1)-row buffer."""
    vg = tint.value_and_grad(_gauss(COV))
    z = torch.as_tensor(np.random.default_rng(2).normal(size=(5, 3)).astype(np.float32))
    im = torch.as_tensor(_metric(kind, c=5, d=3))
    steps = [0.05, 0.3, 0.9, 0.3, 0.05, 0.3]

    def go(replay):
        gen = torch.Generator().manual_seed(4)
        kern = mcmc.Transitions(vg, gen, 6, segment, graphs=False)
        if replay:
            monkeypatch.setattr(kern, "_replaying", lambda dev: True)
        st, out = tint.IntegratorState(z, torch.zeros_like(z), *vg(z)), []
        for s in steps:
            st, info = kern(st, s, im)
            out.append((st, info))
        return out, gen.get_state(), kern

    monkeypatch.setattr(graphs, "Graphs", _Direct)
    _Direct.made.clear()
    ref, ref_gen, _ = go(False)
    out, gen, kern = go(True)
    _same(out, ref)
    assert torch.equal(gen, ref_gen)
    assert len(_Direct.made) == 1 and kern.replayer is _Direct.made[0]
    assert kern.replayer.static.sub.u.shape == (32, 5)
    assert {k if isinstance(k, str) else k[0] for k in kern.replayer.keys} \
        == {"begin", "open", "leaves", "merge"}
    # the buffers hold the carry: a state returned is a tensor of its own
    assert out[-1][0].z.data_ptr() != kern.replayer.static.tree.prop.z.data_ptr()


# --------------------------------------------------------- refusals


def test_replaying_refuses_cpu_chains_and_draw_sources():
    vg = tint.value_and_grad(_gauss(COV))
    z = torch.zeros((2, 3))
    st = tint.IntegratorState(z, torch.zeros_like(z), *vg(z))
    with pytest.raises(ValueError, match="graphs=False"):
        mcmc.Transitions(vg, torch.Generator(), 4, graphs=True)(st, 0.1, torch.ones(2, 3))
    with pytest.raises(ValueError, match="graphs=True"):
        mcmc.run(None, z, torch.ones(2), 3, torch.Generator(), mesh=object(), graphs=True)


def test_a_generator_on_another_device_raises():
    """A CPU generator cannot drive CUDA chains: a copy of its draws inside
    a captured graph would replay one set forever."""
    d = tdraws.Draws(torch.Generator())
    for role in (lambda: d.direction(3, "cuda"), lambda: d.leaf_uniforms(2, 3, "cuda"),
                 lambda: d.momentum((3, 2), torch.float32, "cuda:0"),
                 lambda: d.num_steps(3, 4, "cuda")):
        with pytest.raises(ValueError, match="chains' device"):
            role()
    assert d.leaf_uniforms(4, 3, "cpu").shape == (4, 3)


def test_block_draws_keep_their_chains_of_a_leaf_block():
    full = tdraws.Draws(torch.Generator().manual_seed(0)).leaf_uniforms(4, 6, "cpu")
    block = tdraws.BlockDraws(torch.Generator().manual_seed(0), 2, 6).leaf_uniforms(4, 3, "cpu")
    assert torch.equal(block, full[:, 2:5])


# ------------------------------------------------- graphs' helpers


def test_copy_into_and_empty_like_walk_nested_tuples():
    st = tint.IntegratorState(torch.zeros(2, 3), torch.zeros(2, 3), torch.zeros(2),
                              torch.zeros(2, 3))
    nested = (st, [torch.zeros(4)], None)
    bufs = graphs.empty_like(nested)
    assert isinstance(bufs[0], tint.IntegratorState) and bufs[2] is None
    assert bufs[0].z.shape == (2, 3) and bufs[1][0].shape == (4,)
    vals = (st._replace(z=torch.ones(2, 3)), [torch.arange(4.0)], None)
    graphs.copy_into(bufs, vals)
    assert torch.equal(bufs[0].z, torch.ones(2, 3)) and torch.equal(bufs[1][0], torch.arange(4.0))
    same = bufs[0].logp.fill_(7.0)
    graphs.copy_into(bufs, (bufs[0]._replace(logp=same), [torch.zeros(4)], None))
    assert torch.equal(bufs[0].logp, torch.full((2,), 7.0))
