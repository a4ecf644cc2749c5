"""Cells cut to toy sizes for the CPU, by what their kind of job declares
(``toy``, ``control_size``): the cells of BENCHMARK.json by name, or any
resolved cell."""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def cut(cell):
    """``cell`` with its configuration cut to its job's toy size and its
    check sampling three builds."""
    from benchmark import harness

    cell.config.update(harness.job_module(cell.traffic).toy(cell.config))
    cell.check.update(check_builds=3)
    return cell


def cut_for_control(cell):
    """``cell`` cut to its job's toy size, then to the size at which its
    control is shown to fail, its check holding one build."""
    from benchmark import harness

    cut(cell)
    cell.config.update(harness.job_module(cell.traffic).control_size(cell.config))
    cell.check.update(check_builds=1)
    return cell


def toy_cell(name: str):
    """The cell ``name`` of BENCHMARK.json, cut by :func:`cut`."""
    from benchmark import harness

    return cut(harness.resolve(harness.load_spec(), name))
