"""Room for another model: configurations, a traffic mix and cells that
BENCHMARK.json does not hold, defined only by the files under ``room/`` (a
Poisson model of their own with a plain float64 log-likelihood, and the
logistic build with the float32 select), join the spec in memory and pass
every per-cell test of the benchmark's own tests, through the harness as it
is: untraced and traced toy runs, the control on three seeds, each fault
that the cells' job names, and the program's spans.  A model or a job named
by a module path is imported by it, so nothing outside ``benchmark/tests/``
names them."""

import json
import subprocess
from pathlib import Path

import pytest

from benchmark import harness

from .test_bench_cells_cpu import traced, untraced
from .test_bench_correct import SEEDS, control_fails, plant_fails, plants_of
from .test_bench_program_spans import spans_read
from .toy import ROOT, cut

ROOM = Path(__file__).resolve().parent / "room"
EXTRA = json.loads((ROOM / "spec.json").read_text())
CELLS = [w["name"] for w in EXTRA["workloads"]]


def room_spec() -> dict:
    """BENCHMARK.json with the room's configurations and cells appended, and
    the cells joined to the per-layer metrics they report."""
    spec = harness.load_spec()
    spec["configs"] += EXTRA["configs"]
    spec["workloads"] += EXTRA["workloads"]
    for m in spec["per_layer"]:
        if m["name"] in EXTRA["per_layer_of_the_cells"]:
            m["workloads"] = m["workloads"] + CELLS
    return spec


def room_cell(name: str):
    return harness.resolve(room_spec(), name, here=ROOM)


@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_resolves_to_its_files(cell):
    c = room_cell(cell)
    job = harness.job_module(c.traffic)
    assert callable(job.toy) and callable(job.control_size) and job.PLANTS
    assert harness.module("models", c.config["model"]).PROGRAM_LOGLIK
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "hilbert_points_per_s"}
    assert {m["name"] for m in c.per_layer} == set(EXTRA["per_layer_of_the_cells"])


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run(cell, cpu):
    untraced(cut(room_cell(cell)), cpu)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(cell, cpu):
    traced(cut(room_cell(cell)), cpu)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, seed, cpu):
    control_fails(room_cell(cell), seed, cpu)


@pytest.mark.parametrize("cell, plant", [(c, p) for c in CELLS for p in plants_of(room_cell(c))])
def test_a_planted_fault_is_not_correct(cell, plant, cpu):
    plant_fails(room_cell(cell), plant, cpu)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_construction_spans(cell, cpu):
    spans_read(cut(room_cell(cell)), cpu)


def test_nothing_outside_the_tests_names_the_room():
    names = [c["name"] for c in EXTRA["configs"]] + CELLS + ["giga_room", "tests.room"]
    files = [p for p in (ROOT / "benchmark").rglob("*") if p.is_file()
             and "tests" not in p.relative_to(ROOT / "benchmark").parts
             and "__pycache__" not in p.parts]
    assert files
    for p in files + [ROOT / "BENCHMARK.json"]:
        text = p.read_text(errors="replace")
        assert not [n for n in names if n in text], p
