"""The port imports neither JAX nor the JAX package.

tests/conftest.py imports `repro` into every test process, so the import
check runs in a fresh subprocess: it imports every module of `repro_torch`
and asserts that no `jax*` and no `repro` / `repro.*` module was loaded.
A source scan backs it up for imports that only run inside functions.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names))
sys.exit(f"loaded: {bad}" if bad else 0)
"""

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax\w*|repro)(?:\.|\s|$)",
                     re.MULTILINE)


def test_port_modules_load_no_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _CHECK], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    assert int(out.stdout.split()[-1]) >= 20      # every module was imported


def test_port_sources_never_import_jax_or_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    for f in files:
        hits = _IMPORT.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"
