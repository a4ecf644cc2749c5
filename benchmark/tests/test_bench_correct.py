"""The check fails what it must: the control (the reference in the
program's place, its select in int4 where the configuration states int8) on
three seeds, at a size a test run holds; and, through the rest of a run past
the look for a card, each fault planted under the timed path."""

import time

import numpy as np
import pytest

from benchmark import harness, plants

from .toy import toy_cell

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


def _fails(numbers: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in numbers.items())


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, seed, cpu):
    c = toy_cell(cell)
    c.config.update(N=20_000, coreset_size=200)
    c.check.update(check_builds=1)
    job = harness.job_module(c.traffic).Job(c.config, c.traffic, c.check, seed, cpu)
    numbers, _ = job.check([0], control=True)
    assert _fails(numbers, c.check["limits"]), numbers


@pytest.mark.parametrize("plant", sorted(plants.PLANTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, plant, cpu):
    c = toy_cell(cell)
    with plants.PLANTS[plant]():
        res, _ = harness.run(c, 7, 0.5, False, cpu, time.perf_counter())
    assert res["correct"] is False, res["checks"]


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
