"""What the benchmark loads, in a fresh interpreter: never jax or the JAX
package (top-level names compared whole: krep_tpu_torch begins with
krep_tpu), and in the reference nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from bench_helpers import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "krep_tpu"}

LOAD_ALL = """
import json, sys
from pathlib import Path
sys.path.insert(0, {bench!r})
import run, tracing
for p in sorted(Path({bench!r}, "metrics").glob("*.py")):
    run.load_module(p)
import reference.krep_ref, reference.scan, reference.tree
import recipes.subtitles_corpus, recipes.mixed_set, recipes.linux_tree
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {bench!r})
import reference.krep_ref, reference.scan, reference.tree
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(script: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", script.format(bench=str(BENCH))],
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().split("\n")[-1]))


def test_harness_readers_and_reference_load_no_jax():
    names = _top_level(LOAD_ALL)
    assert "run" in names and not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _top_level(LOAD_REFERENCE)
    assert "reference" in names
    assert not names & (FORBIDDEN | {"krep_tpu_torch", "torch"})
