"""The check fails what it must: the control (the reference in the
program's place, its select one precision below the configuration's: int4
where it states int8) on three seeds, at the size its job declares for it;
and, through the rest of a run past the look for a card, each fault planted
under the timed path that the cell's job names.  :func:`control_fails` and
:func:`plant_fails` take any resolved cell (``test_bench_room.py`` runs them
on a cell of another model)."""

import time

import numpy as np
import pytest

from benchmark import harness, plants

from .toy import cut, cut_for_control, toy_cell

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
SEEDS = [11, 12, 13]


def _fails(numbers: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in numbers.items())


def plants_of(cell) -> list[str]:
    """The names of the faults the cell's job declares."""
    return sorted(harness.job_module(cell.traffic).PLANTS)


def control_fails(c, seed, cpu):
    """The control of the cell ``c`` (resolved, not yet cut) at its job's
    control size fails one of its limits."""
    c = cut_for_control(c)
    job = harness.job_module(c.traffic).Job(c.config, c.traffic, c.check, seed, cpu)
    numbers, _ = job.check([0], control=True)
    assert _fails(numbers, c.check["limits"]), numbers


def plant_fails(c, plant, cpu):
    """A toy run of the cell ``c`` (resolved, not yet cut) with the fault
    ``plant`` of its job is not correct."""
    c = cut(c)
    with harness.job_module(c.traffic).PLANTS[plant]():
        res, _ = harness.run(c, 7, 0.5, False, cpu, time.perf_counter())
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, seed, cpu):
    control_fails(harness.resolve(SPEC, cell), seed, cpu)


@pytest.mark.parametrize("cell, plant", [(c, p) for c in CELLS
                                          for p in plants_of(harness.resolve(SPEC, c))])
def test_a_planted_fault_is_not_correct(cell, plant, cpu):
    plant_fails(harness.resolve(SPEC, cell), plant, cpu)


def test_the_plants_are_undone(cpu):
    c = toy_cell(CELLS[0])
    with plants.select_off_by_one():
        pass
    res, _ = harness.run(c, 7, 0.5, False, cpu, time.perf_counter())
    assert res["correct"] is True
    assert np.isfinite(res["checks"]["error_gap"]["value"])


def test_the_reference_follows_an_answer_through_ties(cpu):
    import torch

    from benchmark import reference

    g = torch.Generator().manual_seed(3)
    V = torch.randn((50, 8), generator=g, dtype=torch.float64)
    V[3] = V[7] = 10.0        # two rows tied for the best-aligned atom
    sys_ = reference.System(V)
    first, _ = reference.giga(sys_, 1)
    assert first.tolist() == [3]
    prefer = torch.zeros(50, dtype=torch.bool)
    prefer[7] = True
    first, _ = reference.giga(sys_, 1, prefer=prefer)
    assert first.tolist() == [7]
    prefer[:] = False
    prefer[20] = True         # no tie with the best: the best is kept
    first, _ = reference.giga(sys_, 1, prefer=prefer, tie=1e-3)
    assert first.tolist() == [3]
