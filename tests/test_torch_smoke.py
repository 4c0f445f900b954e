"""chip_smoke.py's refusals, on a machine without a CUDA card.

A copy of the script run outside the repository finds the package in the
working directory; where neither holds it, or where there is no card, the
script exits 1 and its last line is {"ok": false, "error": ...} naming the
cause.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("cwd,cause", [("copy", "package is missing"), ("repo", "no CUDA device")],
                         ids=["alone", "at-repo"])
def test_lone_copy_of_chip_smoke_names_its_cause(tmp_path, cwd, cause):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path if cwd == "copy" else REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is False and cause in last["error"]
