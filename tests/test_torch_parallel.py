"""The port's row- and chain-sharded paths (``parallel/``) on CPU ranks over
gloo, against the port's single-process builds and the JAX package's
sharded builds on identical inputs.

One module-scoped run per world size (2, and 3 for rows that do not divide
evenly) executes every scenario on spawned ranks
(tests/test_torch_parallel_worker.py, which imports no JAX; joined through
a ``file://`` init under ``tmp_path``, never a port) and saves what each
rank saw; each test below compares one part of it.  Meanwhile this process
runs the JAX package's ``build_sharded`` / ``build_sharded_quantized`` on a
2- and a 4-device CPU mesh (port world 2 against the 2-device mesh, world 3
against the 4-device one), from the same padded constants that the ranks
load through ``interop.sharded_consts``.

Tolerances: against the port's own single-process builds, bit identity
(the JAX package's bar for its sharded builds, tests/test_parallel.py:187-
217); against JAX, the same atoms and weights within rtol 1e-5, atol 1e-6
(OMP rtol 2e-5, tests/test_parallel.py:144-164); NUTS draws within 1e-5
(the log-density's batch shape differs per rank).
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
WORLDS = (2, 3)
JAX_MESH = {2: 2, 3: 4}
NAMES = (*worker.BUILDS, "giga_int8_resident")
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
                lr_w=rng.uniform(0.5, 3.0, size=40).astype(np.float32))


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
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    procs = {w: subprocess.Popen([sys.executable, str(HERE / "test_torch_parallel_worker.py"),
                                  str(d), str(w)], env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for w in WORLDS}
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
def test_mesh_errors_and_item_16b(runs, world):
    for r in _ranks(runs, world):
        assert r["errors/more_ranks"][0] == "ValueError"
        assert f"needs {world + 1} ranks" in r["errors/more_ranks"][1]
        for key in ("proj_axis", "shard_proj"):
            kind, msg = r[f"errors/{key}"]
            assert kind == "NotImplementedError" and "16b" in msg
        assert r["coords"] == {"data": r["rank"]}


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
