"""A tiny end-to-end run of each cell on the CPU, with the program's plain
versions of its kernels, past the harness's look for a card; and run.py's
refusal where there is none."""

import json
import subprocess
import sys
import time

import pytest

from benchmark import harness

from .toy import ROOT, toy_cell

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
SEED = 2**31 + 12345          # larger than 32 signed bits hold


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_reports_the_end_to_end_metrics(cell, cpu):
    c = toy_cell(cell)
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


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_per_layer_metrics(cell, cpu):
    c = toy_cell(cell)
    res, _ = harness.run(c, SEED, 0.5, True, cpu, time.perf_counter())
    assert res["correct"] is True, res["checks"]
    # no card here: the device's metrics find nothing to read, or read idle
    assert {"hilbert.construct_ms", "hilbert.itr_ms", "hilbert.step_mfu"} <= set(res["metrics"])
    assert "select_roofline" not in res["metrics"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_inputs(cpu):
    from benchmark import data
    a = data.logistic_data(SEED, 100, 10, cpu, on_host=False)
    b = data.logistic_data(SEED, 100, 10, cpu, on_host=True)
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
