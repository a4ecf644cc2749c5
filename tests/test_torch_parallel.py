"""The port's sharded paths (``parallel/``) on CPU ranks over gloo, against
the port's single-process builds and the JAX package's sharded builds on
identical inputs: rows, projection columns, chains, and SparseVI and
BatchPSVI on row-sharded data.

One module-scoped run per world size executes every scenario on spawned
ranks (tests/test_torch_parallel_worker.py, which imports no JAX; joined
through a ``file://`` init under ``tmp_path``, never a port) and saves
what each rank saw; each test below compares one part of it.  Worlds 2
and 3 (rows that do not divide evenly) run ``{"data": w}`` and ``{"proj":
w}``, world 4 ``{"data": 2, "proj": 2}`` and ``{"data": 2, "chains": 2}``.
Beforehand this process runs the JAX package's ``build_sharded`` /
``build_sharded_quantized`` on a 2- and a 4-device CPU mesh (port world 2
against the 2-device mesh, world 3 against the 4-device one) and
``build_sharded(shard_proj=True)`` on a 1x2 and a 2x2 mesh (port worlds 2
and 4), from the same padded constants that the ranks load through
``interop.sharded_consts``.

Tolerances: data-sharded builds against the port's own single-process
builds, bit identity (the JAX package's bar for its sharded builds,
tests/test_parallel.py:187-217); against JAX, the same atoms and weights
within rtol 1e-5, atol 1e-6 (OMP rtol 2e-5, tests/test_parallel.py:144-
164).  Proj-sharded builds sum their f32 partial dots in another order:
rtol 1e-4, atol 1e-5 against one process and against JAX
(tests/test_parallel.py:37-44); their summed int8 dots are exact.
SparseVI: the same indices and weights within rtol 1e-5, atol 1e-6;
BatchPSVI within 1e-4 (tests/test_parallel.py:218-268: the sums over rows
are taken in another order).  NUTS draws within 1e-5 (the log-density's
batch shape differs per rank).
"""

import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bayesian_coresets_tpu.parallel as jpar
from bayesian_coresets_tpu.ops import snnls as jsn

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import test_torch_parallel_worker as worker  # noqa: E402

S, N = 256, 512
WORLDS = (2, 3)                       # one-axis meshes
SPAWNS = (*WORLDS, 4)                 # and the two-axis meshes
JAX_MESH = {2: 2, 3: 4}
JAX_PROJ = {2: (1, 2), 4: (2, 2)}     # port world: the JAX (data, proj) mesh
NAMES = (*worker.BUILDS, "giga_int8_resident")
PROJ_NAMES = tuple(worker.PROJ_BUILDS)
JSD = {None: None, torch.int8: jax.numpy.int8}


def _inputs():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(S, N)).astype(np.float32)
    V = A.T
    norms = np.sqrt((V ** 2).sum(axis=1)).astype(np.float32)
    Vq = np.clip(np.round(V / norms[:, None] * 127.0), -127, 127).astype(np.int8)
    z = rng.normal(size=(40, 3)).astype(np.float32)
    y = np.sign(z[:, 0] - 0.5 * z[:, 1] + 0.2).astype(np.float32)
    return dict(A=A, b=A.sum(axis=1), A2=rng.normal(size=(S, 2 * N)).astype(np.float32),
                Vq=Vq, norms=norms,
                X=rng.normal(size=(N, 8)).astype(np.float32),
                W=(0.5 * rng.normal(size=(64, 8))).astype(np.float32),
                nuts_init=rng.normal(size=(12, 3)).astype(np.float32),
                lr_z=np.concatenate([z[:, :2] * y[:, None], y[:, None]], axis=1),
                lr_w=rng.uniform(0.5, 3.0, size=40).astype(np.float32),
                dirs=rng.normal(size=(S, 2)).astype(np.float32),
                svi_x=(1.0 + rng.normal(size=(worker.SVI_N, worker.SVI_D))).astype(np.float32))


def _jax_problem(inp, m, name):
    """(numpy constants the ranks load, JAX's sharded weights) on an
    m-device mesh."""
    mesh = jpar.make_mesh({"data": m}, devices=jax.devices()[:m])
    A, b = inp["A"], inp["b"]
    if name == "giga_int8_resident":
        pad = -(-N // math.lcm(m, 1024)) * math.lcm(m, 1024) - N
        c = jsn.make_consts_quantized(
            np.pad(inp["Vq"], ((0, pad), (0, 0))),
            np.pad(inp["norms"], (0, pad), constant_values=1.0), b,
            valid=np.pad(np.ones(N, bool), (0, pad)))
        st = jpar.build_sharded_quantized(inp["Vq"], inp["norms"], b, worker.QUANT_ITRS, mesh,
                                          max_active=worker.K)
    else:
        method, sd, itrs = worker.BUILDS[name]
        c, _, _ = jpar.coreset.make_sharded_consts(A, b, mesh, select_dtype=JSD[sd])
        st = jpar.build_sharded(A, b, itrs, mesh, method=method, select_dtype=JSD[sd],
                                max_active=worker.K)
    return {f: np.asarray(getattr(c, f)) for f in c._fields}, np.asarray(st.w)[:N]


def _jax_proj_problem(inp, dd, dp, name):
    """(numpy constants, JAX's weights) of ``build_sharded(shard_proj=True)``
    on a (data dd, proj dp) mesh."""
    mesh = jpar.make_mesh({"data": dd, "proj": dp}, devices=jax.devices()[:dd * dp])
    method, sd, itrs = worker.PROJ_BUILDS[name]
    A, b = inp["A"], inp["b"]
    c, _, _ = jpar.coreset.make_sharded_consts(A, b, mesh, select_dtype=JSD[sd], shard_proj=True)
    st = jpar.build_sharded(A, b, itrs, mesh, method=method, select_dtype=JSD[sd],
                            max_active=worker.K, shard_proj=True)
    return {f: np.asarray(getattr(c, f)) for f in c._fields}, np.asarray(st.w)[:N]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    jax_w = {}
    for world in WORLDS:
        for name in NAMES:
            fields, jax_w[world, name] = _jax_problem(inp, JAX_MESH[world], name)
            np.savez(d / f"jax_{world}_{name}.npz", **fields)
    for world, (dd, dp) in JAX_PROJ.items():
        for name in PROJ_NAMES:
            fields, jax_w[world, name] = _jax_proj_problem(inp, dd, dp, name)
            np.savez(d / f"jaxproj_{dd}x{dp}_{name}.npz", **fields)
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    procs = {w: subprocess.Popen([sys.executable, str(HERE / "test_torch_parallel_worker.py"),
                                  str(d), str(w)], env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for w in SPAWNS}
    out = {}
    for w, p in procs.items():
        log, _ = p.communicate(timeout=900)
        assert p.returncode == 0, f"world {w} ranks failed:\n{log[-6000:]}"
        with open(d / f"out_{w}.pkl", "rb") as f:
            out[w] = pickle.load(f)
    return {"inp": inp, "out": out, "jax": jax_w}


def _ranks(runs, world):
    ranks = runs["out"][world]
    assert [r["rank"] for r in ranks] == list(range(world))
    return ranks


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_build_is_bit_identical_to_one_process(runs, world, name):
    ranks = _ranks(runs, world)
    single = ranks[0][f"{name}/single"]
    assert (single > 0).sum() > 10
    for r in ranks:
        np.testing.assert_array_equal(r[f"{name}/w"], single)
        assert r[f"{name}/done"] == ranks[0][f"{name}/single_done"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_build_matches_jax_sharded(runs, world, name):
    jw = runs["jax"][world, name]
    rtol = 2e-5 if name.startswith("omp") else 1e-5
    for r in _ranks(runs, world):
        tw = r[f"jaxfed/{name}"][:N]
        np.testing.assert_array_equal(tw > 0, jw > 0)
        np.testing.assert_allclose(tw, jw, rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_importance_sampling_counts_and_weights(runs, world):
    """The hierarchical draw: counts sum to the draws, the weights follow
    the counts' closed form (tests/test_parallel.py:166-185)."""
    ranks = _ranks(runs, world)
    cts = ranks[0]["importance/cts"]
    assert cts.sum() == 40 and cts.shape == (N,)
    norms = np.sqrt((runs["inp"]["A"].astype(np.float64) ** 2).sum(axis=0))
    ps = norms / norms.sum()
    np.testing.assert_allclose(ranks[0]["importance/w"], (cts / 40) / ps, rtol=1e-5)
    for r in ranks:
        np.testing.assert_array_equal(r["importance/cts"], cts)


@pytest.mark.parametrize("world", WORLDS)
def test_streamed_sharded_constants_equal_one_process_stream(runs, world):
    ranks = _ranks(runs, world)
    r0 = ranks[0]
    V = np.concatenate([r["stream/V"] for r in ranks])
    norms = np.concatenate([r["stream/norms"] for r in ranks])
    valid = np.concatenate([r["stream/valid"] for r in ranks])
    np.testing.assert_array_equal(V[:N], r0["stream/single_V"])
    assert not V[N:].any() and not valid[N:].any() and valid[:N].all()
    np.testing.assert_array_equal(norms[:N], r0["stream/single_norms"])
    for r in ranks:
        np.testing.assert_array_equal(r["stream/b"], r0["stream/single_b"])
        np.testing.assert_array_equal(r["stream/w"][:N], r0["stream/single_w"])


@pytest.mark.parametrize("world", WORLDS)
def test_facade_error_active_size_and_optimize_agree(runs, world):
    ranks = _ranks(runs, world)
    one = {k[len("facade/single/"):]: v for k, v in ranks[0].items()
           if k.startswith("facade/single/")}
    for r in ranks:
        sh = {k[len("facade/sharded/"):]: v for k, v in r.items()
              if k.startswith("facade/sharded/")}
        np.testing.assert_array_equal(sh["w"], one["w"])
        assert sh["size"] == one["size"] > 0
        for a, b in zip(sh["active"], one["active"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sh["w_fista"], one["w_fista"])
        np.testing.assert_array_equal(sh["w_exact"], one["w_exact"])
        for k in ("error", "error_fista", "error_exact"):
            np.testing.assert_allclose(sh[k], one[k], rtol=1e-5)
        assert sh["error_exact"] <= sh["error_fista"] * (1 + 1e-5) < sh["error"]


@pytest.mark.parametrize("world", WORLDS)
def test_done_agrees_on_every_rank(runs, world):
    """A capacity overflow latches ``done`` on every rank at the same
    iteration, as in one process, with no exchange of its own."""
    ranks = _ranks(runs, world)
    done, itr, w = ranks[0]["facade/single/latch"]
    assert done and itr < 50
    for r in ranks:
        d2, i2, w2 = r["facade/sharded/latch"]
        assert (d2, i2) == (done, itr)
        np.testing.assert_array_equal(w2, w)
        for name in NAMES:
            assert r[f"{name}/done"] == ranks[0][f"{name}/done"]


@pytest.mark.parametrize("world", WORLDS)
def test_collective_bytes_per_iteration_do_not_depend_on_n(runs, world):
    """The counterpart of tests/test_sharding_hlo.py: a GIGA build's
    exchanges at n and at 2n rows are the same calls of the same bytes:
    two per iteration (the select's argmax, the selected row) and one per
    refresh of the tracked rows."""
    for r in _ranks(runs, world):
        calls, nbytes = r[f"ledger/{N}"]
        assert r[f"ledger/{2 * N}"] == (calls, nbytes)
        assert calls == {"argmax": 70, "row": 70, "rows": 2}
        assert nbytes["argmax"] == 70 * world * 2 * 8
        assert nbytes["row"] == 70 * (S + 2) * 4


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_nuts_matches_one_process(runs, world):
    """Chains split over the ranks with pooled adaptation: the first 5
    transitions within 1e-5 of one process with the same seed; after a
    warm-up, one pooled step size on every rank, that of one process
    within the drift the per-rank batch shape leaves."""
    ranks = _ranks(runs, world)
    first = ranks[0]["nuts/first/single_samples"]
    for r in ranks:
        assert r["nuts/first/samples"].shape == first.shape == (4 * world, 5, 3)
        np.testing.assert_allclose(r["nuts/first/samples"], first, atol=1e-5)
        np.testing.assert_array_equal(r["nuts/first/step"], ranks[0]["nuts/first/single_step"])
        assert r["nuts/warm/samples"].shape == (4 * world, 10, 3)
        np.testing.assert_array_equal(r["nuts/warm/step"], ranks[0]["nuts/warm/step"])
        assert np.unique(r["nuts/warm/step"]).size == 1
        np.testing.assert_allclose(r["nuts/warm/step"], ranks[0]["nuts/warm/single_step"],
                                   rtol=1e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_weighted_run_with_a_chain_mesh(runs, world):
    ranks = _ranks(runs, world)
    for r in ranks:
        sh, one = r["weighted/sharded"], r["weighted/single"]
        assert sh.shape == one.shape == (4 * world, 8, 3) and np.isfinite(sh).all()
        np.testing.assert_allclose(sh[:, :5], one[:, :5], atol=1e-4)
        assert "multiple" in r["weighted/odd_chains"]


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_errors(runs, world):
    """Too many ranks; OMP on a split proj axis; a streamed build on a
    two-axis mesh; and the coordinates on one- and two-axis meshes."""
    for r in _ranks(runs, world):
        assert r["errors/more_ranks"][0] == "ValueError"
        assert f"needs {world + 1} ranks" in r["errors/more_ranks"][1]
        for key in ("omp_2d", "omp_proj"):
            kind, msg = r[f"errors/{key}"]
            assert kind == "ValueError" and "orthopursuit" in msg
        kind, msg = r["errors/stream_2d"]
        assert kind == "ValueError" and "1-D 'data' mesh" in msg
        assert r["coords"] == {"data": r["rank"]}
        assert r["coords2"] == {"data": 0, "proj": r["rank"]}


@pytest.mark.parametrize("name", PROJ_NAMES)
@pytest.mark.parametrize("world", SPAWNS)
def test_proj_sharded_build_matches_one_process(runs, world, name):
    """``build_sharded(shard_proj=True)`` against the single-process build:
    the same atoms, the weights and the cached image within rtol 1e-4, atol
    1e-5 (f32 partial dots summed over proj in another order)."""
    ranks = _ranks(runs, world)
    single = ranks[0][f"{name}/single"]
    assert (single > 0).sum() > 10
    for r in ranks:
        np.testing.assert_array_equal(r[f"{name}/w"] > 0, single > 0)
        np.testing.assert_allclose(r[f"{name}/w"], single, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r[f"{name}/xw"], ranks[0][f"{name}/single_xw"], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name", PROJ_NAMES)
@pytest.mark.parametrize("world", sorted(JAX_PROJ))
def test_proj_sharded_build_matches_jax(runs, world, name):
    """From the JAX package's proj-sharded constants (its S padding) on the
    matching mesh: the same atoms and weights as its build within rtol
    1e-4, atol 1e-5 (tests/test_parallel.py:37-44)."""
    jw = runs["jax"][world, name]
    for r in _ranks(runs, world):
        tw = r[f"jaxfed/{name}"][:N]
        np.testing.assert_array_equal(tw > 0, jw > 0)
        np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", SPAWNS)
def test_proj_int8_dots_equal_one_process(runs, world):
    """The int8 copy is normalized by the full rows' norms before it is
    sliced: its partial int32 dots summed over proj are one process's dots
    exactly, and each rank's block is whole 16-byte rows."""
    for r in _ranks(runs, world):
        dots, single, shape = r["proj_dots"]
        assert dots.dtype == np.int32 and np.abs(dots).max() > 1000
        np.testing.assert_array_equal(dots, single)
        assert shape[1] % 16 == 0 and shape[1] >= -(-S // (2 if world != 3 else 3))


@pytest.mark.parametrize("world", SPAWNS)
def test_proj_sharded_sampling_equals_data_sharded(runs, world):
    """Importance sampling with S split: the same draws and counts as the
    data-only build on the same mesh, and the weights from the full rows'
    norms (the build's probabilities)."""
    for r in _ranks(runs, world):
        (cp, wp), (cd, wd) = r["proj_importance/proj"], r["proj_importance/data"]
        assert cp.sum() == 40
        np.testing.assert_array_equal(cp, cd)
        np.testing.assert_allclose(wp, wd, rtol=1e-6)


@pytest.mark.parametrize("world", SPAWNS)
def test_proj_bytes_per_select(runs, world):
    """One (n_loc, 2) exchange of the summed dots per select on the proj
    axis, at n and at 2n rows; the data axis's exchanges do not depend on
    n; the proj axis's other exchanges (sums over S) neither."""
    for r in _ranks(runs, world):
        axes = {n: r[f"proj_ledger_axes/{n}"] for n in (N, 2 * N)}
        for n in (N, 2 * N):
            calls, nbytes = axes[n]["proj"]["dots"]
            assert calls == 70 and nbytes == 70 * r[f"proj_ledger/n_loc/{n}"] * 2 * 4
            assert r[f"proj_ledger/n_loc/{n}"] == -(-n // (2 if world == 4 else 1))
        assert axes[N].get("data") == axes[2 * N].get("data")
        assert axes[N]["proj"]["s_sum"] == axes[2 * N]["proj"]["s_sum"]
        assert ("data" in axes[N]) == (world == 4)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_svi_and_bpsvi_match_one_process(runs, world):
    """SparseVI (exact family; and with 128-row subsamples) and BatchPSVI on
    the data axis: the single-process build's indices, and its weights
    within rtol 1e-5, atol 1e-6 (BatchPSVI's weights and points within
    1e-4), tests/test_parallel.py:218-268."""
    for r in _ranks(runs, world):
        for key in ("svi", "svi_sub"):
            sw, sp, si = r[f"{key}/sharded"][:3]
            ow, op, oi = r[f"{key}/single"][:3]
            assert oi.size >= 6
            np.testing.assert_array_equal(si, oi)
            np.testing.assert_allclose(sw, ow, rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(sp, op)
        np.testing.assert_allclose(r["svi_sub/sharded"][3], r["svi_sub/single"][3], rtol=1e-4)
        (bw, bp, be), (ow, op, oe) = r["bpsvi/sharded"], r["bpsvi/single"]
        np.testing.assert_allclose(bw, ow, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(bp, op, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(be, oe, rtol=1e-4)


def test_two_axis_mesh_coordinates_and_facade(runs):
    """{"data": 2, "proj": 2}: row-major coordinates; ``HilbertCoreset(mesh=)``
    shards the data axis and repeats over proj, bit for bit one process's
    build; a streamed build refuses the mesh.  {"data": 2, "chains": 2}
    alike."""
    ranks = _ranks(runs, 4)
    for r in ranks:
        assert r["coords"] == {"data": r["rank"] // 2, "proj": r["rank"] % 2}
        assert r["coords_chains"] == {"data": r["rank"] // 2, "chains": r["rank"] % 2}
        for a, b in zip(r["hilbert/sharded"], r["hilbert/single"]):
            np.testing.assert_array_equal(a, b)
        kind, msg = r["errors/stream_2d"]
        assert kind == "ValueError" and "1-D 'data' mesh" in msg
    assert ranks[0]["hilbert/single"][0].size > 10


def test_chain_sharded_nuts_on_a_two_axis_mesh(runs):
    """Chains split over the chain axis of {"data": 2, "chains": 2} and
    repeated over data: the first 5 transitions within 1e-5 of one process,
    one pooled step size on every rank, and the weighted run's chains."""
    ranks = _ranks(runs, 4)
    first = ranks[0]["nuts/first/single_samples"]
    for r in ranks:
        assert r["nuts/first/samples"].shape == first.shape == (8, 5, 3)
        np.testing.assert_allclose(r["nuts/first/samples"], first, atol=1e-5)
        np.testing.assert_array_equal(r["nuts/warm/step"], ranks[0]["nuts/warm/step"])
        np.testing.assert_allclose(r["nuts/warm/step"], ranks[0]["nuts/warm/single_step"],
                                   rtol=1e-3)
        sh, one = r["weighted/sharded"], r["weighted/single"]
        assert sh.shape == one.shape == (8, 8, 3) and np.isfinite(sh).all()
        np.testing.assert_allclose(sh[:, :5], one[:, :5], atol=1e-4)
        assert "multiple" in r["weighted/odd_chains"]


@pytest.mark.parametrize("world", WORLDS)
def test_gaussian_driver_with_data_mesh_equals_one_process(runs, world):
    """``gaussian run --data_mesh k`` under k ranks: rank 0 alone writes the
    results, which agree with the run in one process (b is the sum of the
    ranks' f32 partial sums, so not bit for bit)."""
    r0 = _ranks(runs, world)[0]
    assert r0["driver/manifest_rows"] == 1
    sh, one = r0["driver/sharded"], r0["driver/single"]
    np.testing.assert_array_equal(sh["Ms"], one["Ms"])
    np.testing.assert_array_equal(sh["csizes"], one["csizes"])
    for k in ("rklw", "fklw", "mu_errs", "Sig_errs"):
        np.testing.assert_allclose(sh[k], one[k], rtol=1e-3, atol=1e-6)


def test_make_mesh_needs_a_process_group():
    from bayesian_coresets_tpu_torch import parallel as P

    with pytest.raises(RuntimeError, match="initialize"):
        P.make_mesh({"data": 2})


def test_run_local_raises_a_rank_failure(tmp_path):
    from bayesian_coresets_tpu_torch.parallel import run_local

    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*boom on rank 1"):
        run_local(worker.fail_on_rank_one, 2, "gloo", str(tmp_path / "init"), timeout=120)
