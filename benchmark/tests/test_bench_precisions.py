"""The reference's select in each precision the program offers: float32 and
bfloat16 round the rows as the program's selection copy holds them, int8
and int4 as before; the control is one precision below the configuration's;
and the int8 cells' checks read what they read before the float selects
were added (``pinned_checks.json``).  A float32 build passing its check and
its bfloat16 control failing it are ``test_bench_room.py``'s tests of the
cell ``room.logistic_f32``."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import harness, reference
from benchmark.jobs import hilbert

from .toy import toy_cell

PINNED = json.loads((Path(__file__).resolve().parent / "pinned_checks.json").read_text())


def _system(seed: int = 5, n: int = 300, s: int = 40) -> reference.System:
    g = torch.Generator().manual_seed(seed)
    V = torch.randn((n, s), generator=g, dtype=torch.float64)
    V[7] = 0.0                  # a row of norm 0 is not selectable
    return reference.System(V)


def _unit_dirs(s: int = 40) -> torch.Tensor:
    g = torch.Generator().manual_seed(9)
    d = torch.randn((s, 2), generator=g, dtype=torch.float64)
    return d / torch.linalg.vector_norm(d, dim=0)


@pytest.mark.parametrize("select, dtype", [("float32", torch.float32),
                                           ("bfloat16", torch.bfloat16)])
def test_a_float_copy_is_the_rows_rounded_to_its_type(select, dtype):
    sys_ = _system()
    q = sys_.select_copy(select)
    assert q.dtype == dtype and torch.equal(q, sys_.V.to(dtype))
    assert sys_.select_copy(select) is q          # made once


def test_float_scores_are_the_rounded_dots_over_the_norms():
    sys_, dirs = _system(), _unit_dirs()
    exact = sys_.scores(dirs, None)
    safe = torch.where(sys_.valid, sys_.norms, 1.0)[:, None]
    for select, dtype, eps in (("float32", torch.float32, 2.0**-24),
                               ("bfloat16", torch.bfloat16, 2.0**-8)):
        got = sys_.scores(dirs, select)
        want = (sys_.V.to(dtype).double() @ dirs.to(dtype).double()) / safe
        assert torch.equal(got, want), select
        gap = (got - exact).abs().max().item()
        assert 0 < gap < 4 * eps, (select, gap)
    assert sys_.scores(dirs, "bfloat16")[7].tolist() == [0.0, 0.0]


def test_integer_scores_round_the_normalized_rows():
    sys_, dirs = _system(), _unit_dirs()
    safe = torch.where(sys_.valid, sys_.norms, 1.0)[:, None]
    for select, levels in (("int8", 127), ("int4", 7)):
        q = sys_.select_copy(select)
        assert q.dtype == torch.int8
        assert torch.equal(q, torch.clamp(torch.round(sys_.V / safe * levels),
                                          -levels, levels).to(torch.int8))
        d = torch.clamp(torch.round(dirs * levels), -levels, levels)
        assert torch.equal(sys_.scores(dirs, select),
                           (q.double() @ d) / (levels * levels)), select


def test_resident_rows_need_an_integer_copy():
    with pytest.raises(ValueError, match="integer"):
        reference.giga(_system(), 3, select="float32", resident=True)


def test_each_control_is_one_precision_below():
    chain = ["float32", "bfloat16", "int8", "int4"]
    for above, below in zip(chain, chain[1:]):
        assert hilbert.PRECISIONS[above]["control"] == below
        assert below in reference.PRECISIONS
    assert set(hilbert.PRECISIONS) | {"int4"} == set(reference.PRECISIONS)


def test_a_configuration_without_a_reference_select_is_refused(cpu):
    c = toy_cell(harness.load_spec()["workloads"][0]["name"])
    c.config["select_dtype"] = "float16"
    with pytest.raises(ValueError, match="float16"):
        harness.job_module(c.traffic).Job(c.config, c.traffic, c.check, 1, cpu)


@pytest.mark.parametrize("cell", sorted(PINNED["cells"]))
def test_the_int8_checks_read_as_pinned(cell, cpu):
    pin, n = PINNED["cells"][cell], PINNED["builds"]
    c = toy_cell(cell)
    job = harness.job_module(c.traffic).Job(c.config, c.traffic, c.check, PINNED["seed"], cpu)
    job.warm()
    for i in range(n):
        job.run(i)
    for control, numbers, errors in ((False, pin["sound"], pin["errors"]),
                                     (True, pin["control"], pin["control_errors"])):
        got, seen = job.check(range(n), control=control)
        assert got["early_atoms_missed"] == numbers["early_atoms_missed"]
        assert got["malformed"] == numbers["malformed"]
        assert got["error_gap"] == pytest.approx(numbers["error_gap"], rel=1e-6)
        assert [b["build"] for b in seen["builds"]] == list(range(n))
        for b, (err, ref_err, missed) in zip(seen["builds"], errors):
            assert b["early_atoms_missed"] == missed
            assert b["error"] == pytest.approx(err, rel=1e-6)
            assert b["reference_error"] == pytest.approx(ref_err, rel=1e-9)
