"""The port stands alone: with jax, flax and the JAX package sniper_tpu
blocked in ``sys.modules``, every module of sniper_tpu_torch imports and no
module of sniper_tpu comes along; and no source file of the port, nor
chip_smoke.py, imports jax or sniper_tpu, at the top or inside a
function. Every module of sniper_tpu, and each top-level CLI the port
serves, has its counterpart of the same name in the port."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "sniper_tpu_torch")
PORT_SOURCES = sorted(
    os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
    if f.endswith(".py"))


def _modules():
    import sniper_tpu_torch

    return sorted(m.name for m in pkgutil.walk_packages(
        sniper_tpu_torch.__path__, "sniper_tpu_torch."))


_PROBE = """
import sys
for name in [m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sniper_tpu')]:
    del sys.modules[name]
sys.modules['jax'] = None
sys.modules['flax'] = None
sys.modules['sniper_tpu'] = None
import importlib
for name in sys.argv[1:]:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'flax', 'sniper_tpu')
                and sys.modules[m] is not None)
print('LEAKED', leaked)
"""


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "sniper_tpu_torch.main_test" in mods
    assert "sniper_tpu_torch.ops.deform" in mods
    assert "sniper_tpu_torch.data.coco" in mods
    assert "sniper_tpu_torch.train.pretrained" in mods
    assert "sniper_tpu_torch.data.shm_loader" in mods
    assert "sniper_tpu_torch.models.resnext" in mods
    assert "sniper_tpu_torch.models.mobilenetv2" in mods
    assert "sniper_tpu_torch.parallel.distributed" in mods
    assert "sniper_tpu_torch.parallel.mesh" in mods
    assert "sniper_tpu_torch.demo" in mods
    assert "sniper_tpu_torch.utils.profiler" in mods
    assert "sniper_tpu_torch.bench" in mods
    assert "sniper_tpu_torch.bench_autofocus" in mods
    res = subprocess.run([sys.executable, "-c", _PROBE, *mods], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "LEAKED []" in res.stdout, res.stdout


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_no_jax_import_in_source(path):
    with open(path) as f:
        src = f.read()
    assert not re.search(r"^\s*(import jax|from jax)", src, re.M), path


@pytest.mark.parametrize("path", PORT_SOURCES + [
    os.path.join(ROOT, "chip_smoke.py")])
def test_no_sniper_tpu_import_in_source(path):
    with open(path) as f:
        src = f.read()
    assert not re.search(r"^\s*(from|import)\s+sniper_tpu(\.|\s|$)", src,
                         re.M), path


def test_every_jax_module_has_a_counterpart():
    """sniper_tpu/<path>.py -> sniper_tpu_torch/<path>.py, but for the
    Pallas kernels (ops/pallas/), which csrc/ replaces; the top-level demo,
    CLIs and bench -> sniper_tpu_torch/ (scripts/bench_autofocus.py, which
    bench.py runs, -> sniper_tpu_torch/bench_autofocus.py)."""
    jax_pkg = os.path.join(ROOT, "sniper_tpu")
    missing = [
        os.path.relpath(os.path.join(d, f), jax_pkg)
        for d, _, fs in os.walk(jax_pkg) for f in fs
        if f.endswith(".py") and "pallas" not in os.path.relpath(d, jax_pkg)
        and not os.path.exists(os.path.join(
            PKG, os.path.relpath(os.path.join(d, f), jax_pkg)))]
    missing += [f for f in ("demo.py", "main_train.py", "main_test.py",
                            "bench.py", "bench_autofocus.py")
                if not os.path.exists(os.path.join(PKG, f))]
    assert not missing, missing
