"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program, compared by whole top-level names
(the program's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "bayesian_coresets_tpu"}
PROGRAM = "bayesian_coresets_tpu_torch"
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imported(path) & FORBIDDEN


MODELS = sorted((HERE / "models").glob("*.py"))


def test_the_reference_and_the_yardstick_import_nothing_of_the_program():
    assert len(MODELS) > 1
    for path in [HERE / name for name in ("reference.py", "data.py", "roofline.py",
                                          "stats.py")] + MODELS:
        assert PROGRAM not in _imported(path), path.name


def _loaded_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    # everything a run imports, the program included, in a fresh process
    loaded = _loaded_after(
        "import benchmark.harness as h, benchmark.jobs.hilbert, benchmark.plants\n"
        "import benchmark.models.logistic\n"
        "import bayesian_coresets_tpu_torch\n"
        "[h.reader(m['name']) for g in ('end_to_end', 'per_layer') for m in h.load_spec()[g]]")
    assert not loaded & FORBIDDEN
    assert PROGRAM in loaded


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import benchmark.reference, benchmark.data, benchmark.roofline, "
                           "benchmark.models.logistic")
    assert PROGRAM not in loaded and not loaded & FORBIDDEN


def test_forbidden_modules_compares_whole_names():
    from benchmark import harness
    sys.modules.setdefault("jaxlike_stand_in", sys)
    found = harness.forbidden_modules()
    assert "jaxlike_stand_in" not in found and PROGRAM not in found
