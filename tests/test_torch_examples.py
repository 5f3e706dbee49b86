"""The port's examples (examples/torch_*.py) run end to end on the CPU, each
in a fresh process that must load neither JAX nor the JAX package, and
print what their reference scripts print (examples/quickstart.py,
fmm_protocols.py, serve_lm.py, train_lm.py; torch_moe_parallel.py, the
sharding tier, has no reference script), their own asserts included;
the trainer with `--smoke` and a few steps, checkpointing into a
temporary directory."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_RUN = r"""
import runpy, sys
sys.argv = [sys.argv[1], "--device", "cpu", *sys.argv[2:]]
runpy.run_path(sys.argv[0], run_name="__main__")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
sys.exit(f"loaded: {bad}" if bad else 0)
"""


EXPECT = {
    "torch_quickstart": ["rel. L2 error vs direct sum", "HSDX stages", "OK"],
    "torch_fmm_protocols": ["alltoallv", "nbx", "pairwise", "hsdx",
                            "all protocols served from one GeometryPlan",
                            "dist bulk", "dist grain", "dist hsdx",
                            "chaos: killed fused.launch"],
    "torch_serve_lm": ["request 5:", "OK — served 6 requests"],
    "torch_moe_parallel": ["request 1:", "12 of 12 tokens as without",
                           "data-parallel step: loss",
                           "OK — served 2 requests"],
    "torch_train_lm": ["[train] step 0 loss", "[train] step 5 loss",
                       "final loss", "over 8 steps (0 straggler steps)"],
}
ARGS = {"torch_train_lm": ["--smoke", "--steps", "8"]}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_example_runs_on_the_cpu(name, tmp_path):
    # one OpenMP thread: the examples are small, and more threads only
    # contend with the other test processes for the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = ARGS.get(name, [])
    if name == "torch_train_lm":
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    out = subprocess.run([sys.executable, "-c", _RUN,
                          str(ROOT / "examples" / f"{name}.py"), *args],
                         env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:] + out.stdout[-3000:]
    for line in EXPECT[name]:
        assert line in out.stdout, (line, out.stdout)
