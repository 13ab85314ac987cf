"""Nothing the benchmark runs imports JAX or the JAX package, and the
yardstick and the reference import nothing of the program.

Module names are compared by their top-level name, whole: the port's
package ``sniper_tpu_torch`` begins with the JAX package's name but is not
it."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sniper_tpu"}
# the yardstick and the reference may not move with the program
INDEPENDENT = ("reference", "yardstick")


def imports(path: Path) -> set:
    """The top-level names of every module a file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_import(path):
    assert not imports(path) & FORBIDDEN


@pytest.mark.parametrize("part", INDEPENDENT)
def test_reference_and_yardstick_import_nothing_of_the_program(part):
    for path in (BENCH / part).rglob("*.py"):
        assert "sniper_tpu_torch" not in imports(path), path


def test_the_name_check_compares_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import sniper_tpu_torch.ops\nfrom jax import numpy\n")
    assert imports(f) == {"sniper_tpu_torch", "jax"}
    assert imports(f) & FORBIDDEN == {"jax"}


def test_a_run_loads_no_jax(tmp_path):
    """Import run.py, every driver and every reader, build a tiny cell's
    program on the CPU, and read sys.modules."""
    code = f"""
import sys
sys.path.insert(0, {str(BENCH.parent)!r})
sys.path.insert(0, {str(BENCH / 'tests')!r})
import importlib.util, torch
from benchmark.core import harness
spec = importlib.util.spec_from_file_location('r', {str(BENCH / 'run.py')!r})
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
for d in (harness.BENCH / 'drivers').glob('*.py'):
    harness.load_module(d)
for m in (harness.BENCH / 'metrics').glob('*.py'):
    harness.load_module(m)
import tiny
from benchmark.core.program import program_model
program_model(tiny.cell('r101_pyramid')['config'], 1, torch.device('cpu'))
from sniper_tpu_torch.train import trainer, optimizer
from sniper_tpu_torch import main_test
from sniper_tpu_torch.infer import tester
print(sorted({{m.split('.')[0] for m in sys.modules}}
             & set({sorted(FORBIDDEN)!r})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
