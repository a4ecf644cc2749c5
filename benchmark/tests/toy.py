"""The cells of BENCHMARK.json cut to toy sizes for the CPU."""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# toy sizes of each configuration: rows, coreset size, streamed chunk
TOY = {"logistic_n100k_s500": (3000, 40, None),
       "logistic_n8m_s500_int8": (6000, 40, 2500)}


def toy_cell(name: str):
    """The cell ``name`` with its configuration cut to a toy size (the
    projection keeps S=500) and its check sampling three builds."""
    from benchmark import harness

    cell = harness.resolve(harness.load_spec(), name)
    n, m, chunk = TOY[cell.entry["config"]]
    cell.config.update(N=n, coreset_size=m)
    if cell.config.get("stream_chunk_size"):
        cell.config["stream_chunk_size"] = chunk
    cell.check.update(check_builds=3)
    return cell
