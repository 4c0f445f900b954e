"""Shared by the benchmark's tests: scratch checkouts and runs in them.

A scratch checkout holds a copy of benchmark/ (without its data), the
program as a symbolic link, and a BENCHMARK.json of the test's own, so a
run there writes nothing into the repository.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
PROGRAM = "krep_tpu_torch"

# a run on the CPU: run_cell without the look for a card, after `prelude`
CPU_RUN = ("import sys; sys.path.insert(0, 'benchmark'); {prelude}\n"
           "import run; raise SystemExit(run.run_cell(run.parse(sys.argv[1:]), device='cpu'))")


def spec() -> dict:
    """BENCHMARK.json."""
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


# A source-tree cell that BENCHMARK.json does not list: `checkout` writes its
# configuration and traffic into every scratch checkout, and `tree_spec`
# lists it.
TREE_CELL = "linux_tree.r-count"
TREE_TRAFFIC = {"argv": ["-r", "--gitignore", "-c", "PM_RESUME", "{tree}"], "loop": "closed",
                "clients": 1}


def tree_config() -> dict:
    """The linux_tree configuration at the recipe's own sizes."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from recipes import linux_tree

    return {"name": "linux_tree", "recipe": "linux_tree", "params": dict(linux_tree.PARAMS),
            "control": "gitignore_negation", "reduced": ["subtrees"]}


def tree_spec() -> dict:
    """BENCHMARK.json with the linux_tree cell in it, read by query_gbps and
    by every per-layer metric of the staging, kernels, device and cli
    layers that moves it."""
    b = spec()
    b["configs"].append({"name": "linux_tree", "source": "https://github.com/BurntSushi/ripgrep",
                         "file": "benchmark/configs/linux_tree.json",
                         "reduced": ["subtrees"], "why": "a test"})
    b["workloads"].append({"name": TREE_CELL, "config": "linux_tree", "traffic": "r-count",
                           "chips": 1, "why": "a test"})
    b["end_to_end"][0]["workloads"].append(TREE_CELL)
    for m in b["per_layer"]:
        if m["layer"] in ("staging", "kernels", "device", "cli", "device wait") \
                and m["moves"] == "query_gbps":
            m["workloads"].append(TREE_CELL)
    return b


def checkout(root: Path, bench: dict | None = None, program: bool = True,
             config_params: dict | None = None) -> Path:
    """A scratch checkout at root; config_params: {config: {key: value}}
    written into the copies of those configurations' files."""
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("data", "__pycache__"))
    if program:
        os.symlink(REPO / PROGRAM, root / PROGRAM)
    (root / "benchmark" / "configs" / "linux_tree.json").write_text(json.dumps(tree_config()))
    (root / "benchmark" / "traffic" / "r-count.json").write_text(json.dumps(TREE_TRAFFIC))
    for name, params in (config_params or {}).items():
        path = root / "benchmark" / "configs" / f"{name}.json"
        conf = json.loads(path.read_text())
        conf["params"].update(params)
        path.write_text(json.dumps(conf))
    (root / "BENCHMARK.json").write_text(json.dumps(bench or spec()))
    return root


SMALL = {"subtitles_en": {"bytes": 1 << 20},
         "linux_tree": {"source_files": 600, "dirs": 60, "big_files": 3,
                        "big_max_bytes": 1 << 21, "nested_gitignores": 12}}


def run(root: Path, workload: str, seed: int = 7, seconds: float = 1, trace: int = 0,
        prelude: str = "", cpu: bool = True, timeout: float = 300) -> subprocess.CompletedProcess:
    args = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
    if cpu:
        cmd = [sys.executable, "-c", CPU_RUN.format(prelude=prelude), *args]
    else:
        cmd = [sys.executable, "benchmark/run.py", *args]
    return subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=timeout)


def result(proc: subprocess.CompletedProcess) -> dict:
    """The last line of a run's stdout, which must be its result."""
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().split("\n")
    return json.loads(lines[-1])
