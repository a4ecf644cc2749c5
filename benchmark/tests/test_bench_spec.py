"""Every cell, configuration and metric of BENCHMARK.json resolves to its
files, and the spec keeps the contract's shape."""

import json
import re

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_holds_its_configuration(conf):
    path = harness.ROOT / conf["file"]
    assert path.is_file() and conf["file"].startswith("benchmark/")
    body = json.loads(path.read_text())
    assert body["name"] == conf["name"] and body["source"] == conf["source"]
    assert body["reduced"] == conf["reduced"]
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.resolve(SPEC, cell)
    assert c.entry["chips"] in (1, 4)
    job = harness.job_module(c.traffic)
    assert hasattr(job, "Job")
    # what the benchmark's own tests need of the kind of job
    assert callable(job.toy) and callable(job.control_size) and job.PLANTS
    assert set(c.check["limits"]) and all(v >= 0 for v in c.check["limits"].values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, not reported in {cell}"


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_has_its_reader(metric):
    assert callable(harness.reader(metric["name"]))
    assert metric["better"] in ("lower", "higher")
    for w in metric.get("workloads", []):
        assert w in CELLS
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["layer"] and metric["moves"]


def test_a_pair_of_config_and_traffic_appears_once():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.resolve(SPEC, "no.such.cell")
