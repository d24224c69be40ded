"""Nothing the benchmark loads is JAX or the JAX package, and a run
without a card, or without the program, prints no result."""
import json
import shutil
import subprocess
import sys

from conftest import ROOT

SMOKE = """
import sys, time
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
from conftest import smoke_cell
from perfbench import harness
cell = smoke_cell("gpt-2.7b.train.taco")
harness.run_cell(cell, 3, 0.2, True, time.perf_counter(), device="cpu",
                 smoke=True)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_smoke_pass_loads_no_jax():
    code = SMOKE.format(src=str(ROOT / "src"), root=str(ROOT),
                        tests=str(ROOT / "perfbench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def _run(cwd, env_extra=None):
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "gpt-2.7b.train.taco", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_bare_directory_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())
