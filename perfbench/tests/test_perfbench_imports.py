"""What a run loads: never JAX nor the reference package ``repro``, by
whole top-level names (``repro_torch`` begins with ``repro``); and the
plain reference imports nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.tests.common import REPO, run_module

BENCH = REPO / "perfbench"


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_whole_names_are_compared():
    f = run_module().forbidden_modules
    assert f(["repro_torch", "repro_torch.models", "jaxtyping",
              "reprox", "perfbench.program"]) == []
    assert f(["repro.models.model", "jax.numpy", "jaxlib", "flax.linen",
              "repro_torch"]) == ["flax", "jax", "jaxlib", "repro"]


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = set(imported(path))
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    assert names <= {"__future__", "math", "dataclasses",
                     "typing", "torch", "perfbench"}, names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_benchmark_file_imports_jax_or_the_reference_package(path):
    assert not set(imported(path)) & {"repro", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax_nor_repro():
    code = (
        "import sys; from pathlib import Path\n"
        "from perfbench import harness\n"
        "from perfbench.tests import tiny\n"
        "from perfbench.tests.common import StepClock\n"
        "import tempfile\n"
        "root = tiny.write(Path(tempfile.mkdtemp()))\n"
        "rec = harness.run('tiny.dsv2.offload', 3, 0.5, True, 'cpu',"
        " root=root, clock=StepClock())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": f"{REPO}:{REPO / 'src'}",
                            "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "perfbench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}
