"""The port stands alone: no file of cffm_tpu_torch, nor chip_smoke.py,
imports jax, orbax, tensorflow, the JAX package, the oracle or a JAX-side script (bench.py,
bench_input.py, bench_scaling.py, scripts/), and every port module,
utils/ and scripts/ included, imports with those blocked."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "cffm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "cffm_tpu", "oracle", "optax", "orbax", "tensorflow")
# the JAX side's scripts, importable through sys.path from the repo root
JAX_SCRIPTS = ("scripts", "bench", "bench_input", "bench_scaling",
               *sorted(p.stem for p in (ROOT / "scripts").glob("*.py")))


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN + JAX_SCRIPTS))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_port_module_imports_without_jax():
    code = "\n".join([
        "import importlib, pkgutil, sys",
        *[f"sys.modules[{name!r}] = None" for name in FORBIDDEN],
        "import cffm_tpu_torch",
        "names = [m.name for m in pkgutil.walk_packages(",
        "    cffm_tpu_torch.__path__, 'cffm_tpu_torch.')]",
        "for name in names:",
        "    importlib.import_module(name)",
        "import chip_smoke",
        "print(' '.join(names))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 14
    for sub in ("utils", "scripts"):
        files = (ROOT / "cffm_tpu_torch" / sub).glob("*.py")
        assert {f"cffm_tpu_torch.{sub}.{p.stem}" for p in files if p.stem != "__init__"} <= names
