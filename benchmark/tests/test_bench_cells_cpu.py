"""A tiny end-to-end run of each cell on the CPU, with the program's plain
versions of its kernels, past the harness's look for a card; and run.py's
refusal where there is none.  :func:`untraced` and :func:`traced` take any
cell cut to a toy size (``test_bench_room.py`` runs them on a cell of
another model)."""

import json
import subprocess
import sys
import time

import pytest

from benchmark import harness

from .toy import ROOT, toy_cell

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
SEED = 2**31 + 12345          # larger than 32 signed bits hold


def untraced(c, cpu):
    """An untraced toy run of the cell ``c``: correct, and reporting its
    end-to-end metrics and its checks."""
    res, seen = harness.run(c, SEED, 2.0, False, cpu, time.perf_counter())
    assert res["correct"] is True, res["checks"]
    n = res["attempted"]
    assert n >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(c.check["limits"])
    assert len(seen["seen"]["builds"]) == min(3, n)
    json.dumps(res)


def traced(c, cpu):
    """A traced toy run of the cell ``c``: correct, and reporting every
    per-layer metric of the cell that can read without a card, and none
    that cannot (their readers say ``CARD_ONLY``)."""
    res, _ = harness.run(c, SEED, 0.5, True, cpu, time.perf_counter())
    assert res["correct"] is True, res["checks"]
    assert c.per_layer
    cpu_read = {m["name"] for m in c.per_layer if not harness.card_only(m["name"])}
    assert set(res["metrics"]) == cpu_read
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_reports_the_end_to_end_metrics(cell, cpu):
    untraced(toy_cell(cell), cpu)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_per_layer_metrics(cell, cpu):
    traced(toy_cell(cell), cpu)


def test_same_seed_same_inputs(cpu):
    from benchmark import data
    from benchmark.models import logistic

    def rows(gen, n):
        return logistic.rows(gen, n, 10)

    a = data.dataset(rows, SEED, 100, cpu, on_host=False)
    b = data.dataset(rows, SEED, 100, cpu, on_host=True)
    assert (a.numpy() == b).all()
    t1 = data.projection_samples(SEED, 3, 500, 10, 0.1, cpu)
    assert (t1 == data.projection_samples(SEED, 3, 500, 10, 0.1, cpu)).all()
    assert not (t1 == data.projection_samples(SEED, 4, 500, 10, 0.1, cpu)).all()


def test_run_py_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_run_py_on_the_card(cuda_device):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", str(SEED), "--seconds", "3", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0 and "select_roofline" in res["metrics"]
