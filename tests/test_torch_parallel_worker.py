"""The ranks of tests/test_torch_parallel.py.  Imports no JAX.

    python tests/test_torch_parallel_worker.py DIR WORLD

spawns WORLD local ranks over gloo (``parallel.run_local``, joined through
a file under DIR), runs every scenario of the parallel tests on them, and
pickles each rank's results to DIR/out_WORLD.pkl.  The inputs come from
DIR/inputs.npz and DIR/jax_*.npz, which the test module writes.  Nothing
runs on import, and no function here is a test.
"""

from __future__ import annotations

import os
import pickle
import sys
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K = 128                               # support slots of every build
BUILDS = {                            # name: (method, select copy, iterations)
    "giga_f32": ("giga", None, 100),
    "giga_int8": ("giga", torch.int8, 100),
    "fw_f32": ("frankwolfe", None, 100),
    "fw_int8": ("frankwolfe", torch.int8, 100),
    "omp_f32": ("orthopursuit", None, 15),
}
QUANT_ITRS = 100                      # the int8-resident GIGA build
CLASSES = {"giga": "GIGA", "frankwolfe": "FrankWolfe", "orthopursuit": "OrthoPursuit"}


class TanhProjector:
    """A fixed-context projector: tanh(pts @ W.T), one W for every call."""

    def __init__(self, W):
        self.W = torch.as_tensor(W)

    def project(self, pts):
        return torch.tanh(pts @ self.W.T)


def _np(t):
    return t.detach().cpu().numpy()


def _builds(inp, mesh, out):
    from bayesian_coresets_tpu_torch import parallel as P
    from bayesian_coresets_tpu_torch.ops import snnls

    A, b = torch.as_tensor(inp["A"]), torch.as_tensor(inp["b"])
    for name, (method, sd, itrs) in BUILDS.items():
        st = P.build_sharded(A, b, itrs, mesh, method=method, select_dtype=sd, max_active=K)
        out[f"{name}/w"], out[f"{name}/done"] = _np(st.w), bool(st.done)
        c = snnls.make_consts(A, b, select_dtype=sd)
        one = snnls.build(c, snnls.init_state(c, K), itrs, 1e-6, method=method)
        out[f"{name}/single"], out[f"{name}/single_done"] = _np(one.w), bool(one.done)
    Vq, nrm = torch.as_tensor(inp["Vq"]), torch.as_tensor(inp["norms"])
    st = P.build_sharded_quantized(Vq, nrm, b, QUANT_ITRS, mesh, max_active=K)
    out["giga_int8_resident/w"], out["giga_int8_resident/done"] = _np(st.w), bool(st.done)
    c = snnls.make_consts_quantized(Vq, nrm, b)
    one = snnls.build(c, snnls.init_state(c, K), QUANT_ITRS, 1e-6)
    out["giga_int8_resident/single"] = _np(one.w)
    out["giga_int8_resident/single_done"] = bool(one.done)


def _jax_fed(d, world, mesh, out):
    """Builds from the JAX package's padded constants, shared by rows."""
    from bayesian_coresets_tpu_torch.ops import snnls
    from bayesian_coresets_tpu_torch.utils import interop

    for name in (*BUILDS, "giga_int8_resident"):
        path = os.path.join(d, f"jax_{world}_{name}.npz")
        with np.load(path) as z:
            c = interop.sharded_consts(SimpleNamespace(**{k: z[k] for k in z.files}), mesh)
        method, _, itrs = BUILDS.get(name, ("giga", None, QUANT_ITRS))
        alg = getattr(snnls, CLASSES[method]).from_consts(c, max_active=K, mesh=mesh)
        alg.build(itrs)
        out[f"jaxfed/{name}"] = alg.weights()


def _sampling(inp, mesh, out):
    from bayesian_coresets_tpu_torch import parallel as P

    A, b = torch.as_tensor(inp["A"]), torch.as_tensor(inp["b"])
    st = P.build_sharded(A, b, 40, mesh, method="importance", max_active=K,
                         draws=torch.Generator().manual_seed(7))
    out["importance/cts"], out["importance/w"] = _np(st.cts), _np(st.w)


def _streamed(inp, mesh, out):
    from bayesian_coresets_tpu_torch import HilbertCoreset

    X, proj = inp["X"], TanhProjector(inp["W"])
    hc = HilbertCoreset(X, proj, stream_chunk_size=64, max_active=K, mesh=mesh)
    c = hc.snnls.consts
    out["stream/V"], out["stream/norms"] = _np(c.V), _np(c.norms)
    out["stream/valid"], out["stream/b"] = _np(c.valid), _np(c.b)
    hc.build(40)
    out["stream/w"] = hc.snnls.weights()
    if mesh.rank == 0:
        one = HilbertCoreset(X, proj, stream_chunk_size=64, max_active=K)
        c1 = one.snnls.consts
        out["stream/single_V"], out["stream/single_norms"] = _np(c1.V), _np(c1.norms)
        out["stream/single_b"] = _np(c1.b)
        one.build(40)
        out["stream/single_w"] = one.snnls.weights()


def _facade(inp, mesh, out):
    """error(), active(), size(), weights() and both optimize() solvers, and
    the latch of a capacity overflow, against one process."""
    from bayesian_coresets_tpu_torch import parallel as P
    from bayesian_coresets_tpu_torch.ops import snnls

    A, b = torch.as_tensor(inp["A"]), torch.as_tensor(inp["b"])
    c = snnls.make_consts(A, b, select_dtype=torch.int8)
    for tag, alg in (("sharded", snnls.GIGA.from_consts(P.shard_consts(c, mesh), max_active=K,
                                                        mesh=mesh)),
                     ("single", snnls.GIGA.from_consts(c, max_active=K))):
        alg.build(60)
        idx, vals = alg.active()
        out[f"facade/{tag}/error"], out[f"facade/{tag}/size"] = alg.error(), alg.size()
        out[f"facade/{tag}/active"] = (idx, vals)
        out[f"facade/{tag}/w"] = alg.weights()[:A.shape[1]]
        alg.optimize()
        out[f"facade/{tag}/w_fista"] = alg.weights()[:A.shape[1]]
        out[f"facade/{tag}/error_fista"] = alg.error()
        alg.optimize(solver="exact")
        out[f"facade/{tag}/w_exact"] = alg.weights()[:A.shape[1]]
        out[f"facade/{tag}/error_exact"] = alg.error()
        small = (snnls.GIGA.from_consts(P.shard_consts(c, mesh), max_active=8, mesh=mesh)
                 if tag == "sharded" else snnls.GIGA.from_consts(c, max_active=8))
        small.build(50)
        out[f"facade/{tag}/latch"] = (bool(small.state.done), int(small.state.itr),
                                      small.weights()[:A.shape[1]])


def _ledger(inp, mesh, out):
    """The exchanges of a GIGA build at n and at 2n rows."""
    from bayesian_coresets_tpu_torch import parallel as P
    from bayesian_coresets_tpu_torch.ops import snnls

    for A in (torch.as_tensor(inp["A"]), torch.as_tensor(inp["A2"])):
        consts, n, _ = P.make_sharded_consts(A, A.sum(dim=1), mesh, select_dtype=torch.int8)
        comm = snnls._data_comm(mesh, consts)
        state = snnls.init_state(consts, K)
        mesh.ledger.reset()
        snnls.build(consts, state, 70, 1e-6, comm=comm)
        out[f"ledger/{n}"] = (dict(mesh.ledger.calls), dict(mesh.ledger.bytes))


def _nuts(inp, mesh, out):
    from bayesian_coresets_tpu_torch import parallel as P
    from bayesian_coresets_tpu_torch.mcmc import run_nuts, weighted
    from bayesian_coresets_tpu_torch.models import logistic

    C = 4 * mesh.size
    prec = torch.tensor([[2.0, 0.9, 0.0], [0.9, 1.0, 0.3], [0.0, 0.3, 0.5]])

    def logp(th):
        return -0.5 * torch.sum(th * (th @ prec), dim=-1)

    init = torch.as_tensor(inp["nuts_init"][:C])
    # the first 5 transitions (no warm-up), then a warm-up of 40 transitions
    for tag, kw in (("first", dict(num_warmup=0, num_samples=5)),
                    ("warm", dict(num_warmup=40, num_samples=10))):
        res = P.run_nuts_sharded(logp, init, torch.Generator().manual_seed(3), mesh,
                                 pooled_adaptation=True, **kw)
        out[f"nuts/{tag}/samples"], out[f"nuts/{tag}/step"] = (_np(res.samples),
                                                               _np(res.step_size))
        if mesh.rank == 0:
            one = run_nuts(logp, init, torch.Generator().manual_seed(3), pooled_adaptation=True,
                           **kw)
            out[f"nuts/{tag}/single_samples"] = _np(one.samples)
            out[f"nuts/{tag}/single_step"] = _np(one.step_size)
    z, w = torch.as_tensor(inp["lr_z"]), torch.as_tensor(inp["lr_w"])
    for tag, m in (("sharded", mesh), ("single", None)):
        _, _, r = weighted.run(logistic, z, w, 8, torch.Generator().manual_seed(5),
                               num_chains=C, pooled_adaptation=True, num_warmup=5, mesh=m)
        out[f"weighted/{tag}"] = _np(r.samples)
    try:
        weighted.run(logistic, z, w, 4, torch.Generator().manual_seed(5), num_chains=C + 1,
                     mesh=mesh)
    except ValueError as e:
        out["weighted/odd_chains"] = str(e)


def _errors(mesh, out):
    from bayesian_coresets_tpu_torch import parallel as P

    for key, fn in (("more_ranks", lambda: P.make_mesh({"data": mesh.size + 1})),
                    ("proj_axis", lambda: P.make_mesh({"data": 1, "proj": mesh.size})),
                    ("shard_proj", lambda: P.build_sharded(torch.ones(4, 6), torch.ones(4), 2,
                                                           mesh, shard_proj=True))):
        try:
            fn()
            out[f"errors/{key}"] = None
        except (ValueError, NotImplementedError) as e:
            out[f"errors/{key}"] = (type(e).__name__, str(e))


def _driver(d, world, out):
    """``gaussian run --data_mesh WORLD`` on every rank, then (rank 0) the
    same run in one process."""
    import torch.distributed as dist

    from bayesian_coresets_tpu_torch.experiments import gaussian, results

    argv = ["run", "--device", "cpu", "--data_num", "300", "--data_dim", "10",
            "--proj_dim", "60", "--coreset_size_max", "30", "--coreset_num_sizes", "4",
            "--trial", "2"]
    folder = os.path.join(d, f"results_{world}") + os.sep
    gaussian.main(argv + ["--data_mesh", str(world), "--results_folder", folder])
    dist.barrier()
    if dist.get_rank() == 0:
        single = os.path.join(d, f"results_{world}_single") + os.sep
        gaussian.main(argv + ["--results_folder", single])
        for tag, f in (("sharded", folder), ("single", single)):
            tab = results.load_matching({"results_folder": f})
            out[f"driver/{tag}"] = {k: np.asarray(tab[k]) for k in tab.columns}
        out["driver/manifest_rows"] = results.read_csv(
            os.path.join(folder, "manifest.csv")).nrows


def fail_on_rank_one():
    """Rank 1 raises while rank 0 waits for it in a collective."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("boom on rank 1")
    dist.barrier()


def scenarios(d: str, world: int) -> dict:
    """Everything one rank runs; returns what it saw."""
    torch.set_num_threads(1)
    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch import parallel as P

    bc.set_default_device("cpu")
    with np.load(os.path.join(d, "inputs.npz")) as z:
        inp = {k: z[k] for k in z.files}
    mesh = P.make_mesh()
    out = {"rank": mesh.rank, "coords": mesh.coords}
    _builds(inp, mesh, out)
    _jax_fed(d, world, mesh, out)
    _sampling(inp, mesh, out)
    _streamed(inp, mesh, out)
    _facade(inp, mesh, out)
    _ledger(inp, mesh, out)
    _nuts(inp, mesh, out)
    _errors(mesh, out)
    _driver(d, world, out)
    return out


if __name__ == "__main__":
    from bayesian_coresets_tpu_torch.parallel import run_local

    d, world = sys.argv[1], int(sys.argv[2])
    outs = run_local(scenarios, world, "gloo", os.path.join(d, f"init_{world}"),
                     args=(d, world), timeout=600)
    with open(os.path.join(d, f"out_{world}.pkl"), "wb") as f:
        pickle.dump(outs, f)
