"""The ranks of tests/test_torch_parallel.py.  Imports no JAX.

    python tests/test_torch_parallel_worker.py DIR WORLD

spawns WORLD local ranks over gloo (``parallel.run_local``, joined through
a file under DIR), runs every scenario of the parallel tests on them, and
pickles each rank's results to DIR/out_WORLD.pkl.  WORLD 2 and 3 run the
one-axis meshes (``{"data": WORLD}`` and ``{"proj": WORLD}``), WORLD 4 the
two-axis ones (``{"data": 2, "proj": 2}`` and ``{"data": 2, "chains":
2}``).  The inputs come from DIR/inputs.npz and DIR/jax*_*.npz, which the
test module writes.  Nothing runs on import, and no function here is a
test.
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
PROJ_BUILDS = {                       # shard_proj=True: name: (method, select copy, iterations)
    "proj_giga_f32": ("giga", None, 100),
    "proj_giga_int8": ("giga", torch.int8, 100),
    "proj_fw_f32": ("frankwolfe", None, 100),
}
SVI_N, SVI_D = 512, 8                 # tests/test_parallel.py:218-268's problem


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


def _ledger(inp, mesh, out, shard_proj=False, tag="ledger"):
    """The exchanges of a GIGA build at n and at 2n rows, by kind, and by
    axis and kind."""
    from bayesian_coresets_tpu_torch import parallel as P
    from bayesian_coresets_tpu_torch.ops import snnls

    for A in (torch.as_tensor(inp["A"]), torch.as_tensor(inp["A2"])):
        consts, n, _ = P.make_sharded_consts(A, A.sum(dim=1), mesh, select_dtype=torch.int8,
                                             shard_proj=shard_proj)
        comm = P.sharded_comm(mesh, consts, shard_proj)
        state = snnls.init_state(consts, K)
        mesh.ledger.reset()
        snnls.build(consts, state, 70, 1e-6, comm=comm)
        out[f"{tag}/{n}"] = (dict(mesh.ledger.calls), dict(mesh.ledger.bytes))
        out[f"{tag}_axes/{n}"] = {a: {k: tuple(v) for k, v in kinds.items()}
                                  for a, kinds in mesh.ledger.by_axis.items()}
        out[f"{tag}/n_loc/{n}"] = consts.V.shape[0]


def _proj(d, jax_tag, inp, mesh, out):
    """Builds that shard S over the mesh's proj axis: against one process,
    from the JAX package's proj-sharded constants, the summed int8 dots, the
    sampling solver, the ledger, and OMP's refusal."""
    from bayesian_coresets_tpu_torch import parallel as P
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import snnls
    from bayesian_coresets_tpu_torch.parallel.coreset import col_block, local_cols, row_block
    from bayesian_coresets_tpu_torch.utils import config, interop

    A, b = torch.as_tensor(inp["A"]), torch.as_tensor(inp["b"])
    S, N = A.shape
    for name, (method, sd, itrs) in PROJ_BUILDS.items():
        st = P.build_sharded(A.numpy(), b, itrs, mesh, method=method, select_dtype=sd,
                             max_active=K, shard_proj=True)
        out[f"{name}/w"], out[f"{name}/xw"] = _np(st.w), _np(st.xw)
        c = snnls.make_consts(A, b, select_dtype=sd)
        one = snnls.build(c, snnls.init_state(c, K), itrs, config.TOL, method=method)
        out[f"{name}/single"], out[f"{name}/single_xw"] = _np(one.w), _np(one.xw)
        path = os.path.join(d, f"jaxproj_{jax_tag}_{name}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                cj = interop.sharded_consts(SimpleNamespace(**{k: z[k] for k in z.files}), mesh,
                                            shard_proj=True)
            comm = P.sharded_comm(mesh, cj, True)
            sj = snnls.build(cj, snnls.init_state(cj, K), itrs, config.TOL, method=method,
                             comm=comm)
            out[f"jaxfed/{name}"] = _np(comm.gather(sj.w))
    # the sampling solver: the proj split changes no draw
    for tag, sp in (("proj", True), ("data", False)):
        st = P.build_sharded(A, b, 40, mesh, method="importance", max_active=K, shard_proj=sp,
                             draws=torch.Generator().manual_seed(7))
        out[f"proj_importance/{tag}"] = (_np(st.cts), _np(st.w))
    # int8 dots summed over proj, against one process's dots of its rows
    consts, _, _ = P.make_sharded_consts(A, b, mesh, select_dtype=torch.int8, shard_proj=True)
    comm = P.sharded_comm(mesh, consts, True)
    dirs = torch.nn.functional.normalize(torch.as_tensor(inp["dirs"]), dim=0)
    c0, per = col_block(S, mesh)
    dots = comm.proj.all_reduce(gs.giga_dots(consts.Vsel, local_cols(dirs.T, c0, per).T), "dots")
    lo, rows = row_block(N, mesh)
    single = gs.giga_dots_ref(snnls.make_consts(A, b, select_dtype=torch.int8).Vsel, dirs)
    out["proj_dots"] = (_np(dots), _np(single[lo:lo + rows]), consts.Vsel.shape)
    _ledger(inp, mesh, out, shard_proj=True, tag="proj_ledger")
    try:
        P.build_sharded(A, b, 3, mesh, method="orthopursuit", shard_proj=True)
        out["errors/omp_proj"] = None
    except ValueError as e:
        out["errors/omp_proj"] = ("ValueError", str(e))


def _svi(inp, mesh, out):
    """SparseVI (exact family; and subsampled) and BatchPSVI on the mesh's
    data axis against one process with the same seeds."""
    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.models import gaussian

    x = torch.as_tensor(inp["svi_x"])
    d = x.shape[1]
    eye = torch.eye(d)
    fam = bc.gaussian_tangent_family(torch.zeros(d), eye, eye, eye)
    basis = gaussian.posterior_basis(torch.zeros(d), eye, eye)

    def sampler(g, n, w, p):
        if p.numel() == 0:
            w, p = torch.zeros(1), torch.zeros((1, d))
        return gaussian.sample_weighted_post_basis(g, basis, p, w, n)

    def projector():
        return bc.BlackBoxProjector(
            sampler, 40, lambda p, th: gaussian.log_likelihood(p, th, eye, 0.0),
            lambda p, th: gaussian.grad_x_log_likelihood(p, th, eye),
            generator=torch.Generator().manual_seed(5))

    for tag, m in (("sharded", mesh), ("single", None)):
        a = bc.SparseVICoreset(x, fam, opt_itrs=20, seed=0, capacity=16, mesh=m)
        a.build(10)
        out[f"svi/{tag}"] = a.get()
        c = bc.SparseVICoreset(x, fam, n_subsample_select=128, n_subsample_opt=128,
                               opt_itrs=20, seed=0, capacity=16, mesh=m)
        c.build(8)
        out[f"svi_sub/{tag}"] = c.get() + (c.error(),)
        p = bc.BatchPSVICoreset(x, projector(), opt_itrs=30, seed=0, mesh=m)
        p.build(6)
        out[f"bpsvi/{tag}"] = (p.wts, p.pts, p.error())


def _nuts(inp, mesh, out):
    from bayesian_coresets_tpu_torch import parallel as P
    from bayesian_coresets_tpu_torch.mcmc import run_nuts, weighted
    from bayesian_coresets_tpu_torch.models import logistic

    C = 4 * mesh.axis_size("chains" if "chains" in mesh.axis_names else mesh.axis_names[0])
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


def _errors(inp, mesh, out):
    """The meshes' refusals, and the coordinates on a two-axis mesh
    ({"data": 1, "proj": WORLD} here: every rank on the proj axis)."""
    from bayesian_coresets_tpu_torch import HilbertCoreset
    from bayesian_coresets_tpu_torch import parallel as P

    mesh2 = P.make_mesh({"data": 1, "proj": mesh.size})
    out["coords2"] = mesh2.coords
    for key, fn in (("more_ranks", lambda: P.make_mesh({"data": mesh.size + 1})),
                    ("omp_2d", lambda: P.build_sharded(torch.ones(4, 6), torch.ones(4), 2, mesh2,
                                                       method="orthopursuit", shard_proj=True)),
                    ("stream_2d", lambda: HilbertCoreset(inp["X"], TanhProjector(inp["W"]),
                                                         stream_chunk_size=64, mesh=mesh2))):
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
    _errors(inp, mesh, out)
    _driver(d, world, out)
    _svi(inp, mesh, out)
    _proj(d, f"1x{world}", inp, P.make_mesh({"proj": world}), out)
    return out


def scenarios_2d(d: str) -> dict:
    """The two-axis meshes on four ranks: proj-sharded builds on {"data": 2,
    "proj": 2}, the facade repeated over proj, and chain-sharded NUTS on
    {"data": 2, "chains": 2}."""
    torch.set_num_threads(1)
    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch import HilbertCoreset
    from bayesian_coresets_tpu_torch import parallel as P

    bc.set_default_device("cpu")
    with np.load(os.path.join(d, "inputs.npz")) as z:
        inp = {k: z[k] for k in z.files}
    mesh = P.make_mesh({"data": 2, "proj": 2})
    out = {"rank": mesh.rank, "coords": mesh.coords}
    _proj(d, "2x2", inp, mesh, out)
    X, proj = inp["X"], TanhProjector(inp["W"])
    for tag, m in (("sharded", mesh), ("single", None)):
        hc = HilbertCoreset(X, proj, max_active=K, select_dtype=torch.int8, mesh=m)
        hc.build(40)
        out[f"hilbert/{tag}"] = hc.get()
    try:
        HilbertCoreset(X, proj, stream_chunk_size=64, mesh=mesh)
        out["errors/stream_2d"] = None
    except ValueError as e:
        out["errors/stream_2d"] = ("ValueError", str(e))
    chains = P.make_mesh({"data": 2, "chains": 2})
    out["coords_chains"] = chains.coords
    _nuts(inp, chains, out)
    return out


if __name__ == "__main__":
    from bayesian_coresets_tpu_torch.parallel import run_local

    d, world = sys.argv[1], int(sys.argv[2])
    fn, args = (scenarios_2d, (d,)) if world == 4 else (scenarios, (d, world))
    outs = run_local(fn, world, "gloo", os.path.join(d, f"init_{world}"), args=args,
                     timeout=600)
    with open(os.path.join(d, f"out_{world}.pkl"), "wb") as f:
        pickle.dump(outs, f)
