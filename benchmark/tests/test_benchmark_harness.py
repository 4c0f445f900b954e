"""The harness on the CPU, in scratch checkouts: it finds new cells by name,
keeps the last-line contract, refuses to run without a card or without the
program, and sees a broken program and the control as not correct."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import pytest

from bench_helpers import BENCH, SMALL, TREE_CELL, checkout, result, run, spec, tree_spec

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _tree_digest(root) -> dict:
    out = {}
    for d, dirs, names in os.walk(root):
        dirs[:] = [x for x in dirs if x not in ("data", "__pycache__")]
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files, with entries in BENCHMARK.json: a run finds them and keeps the
    contract, and no file that was there is edited."""
    root = checkout(tmp_path)
    before = _tree_digest(root / "benchmark")
    b = root / "benchmark"
    (b / "configs" / "tiny_en.json").write_text(json.dumps({
        "name": "tiny_en", "recipe": "subtitles_corpus", "params": {"bytes": 262144},
        "control": "block_edges", "reduced": ["bytes"]}))
    (b / "traffic" / "count-sherlock.json").write_text(json.dumps({
        "argv": ["-c", "Sherlock", "{corpus}"], "loop": "closed", "clients": 1}))
    (b / "metrics" / "out_lines_per_query.py").write_text(
        '"""Lines of stdout a query."""\n\n\ndef read(run):\n'
        "    return sum(q.lines for q in run.queries) / len(run.queries)\n")
    bench = spec()
    bench["configs"].append({"name": "tiny_en", "source": "https://example.org/tiny",
                             "file": "benchmark/configs/tiny_en.json", "reduced": ["bytes"],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny_en.count-sherlock", "config": "tiny_en",
                               "traffic": "count-sherlock", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("tiny_en.count-sherlock")
    bench["per_layer"].append({"name": "out_lines_per_query", "unit": "lines", "better": "higher",
                               "source": "program_counter", "layer": "printer",
                               "moves": "query_gbps", "workloads": ["tiny_en.count-sherlock"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    r0 = result(run(root, "tiny_en.count-sherlock", seed=2**31 + 11, trace=0))
    assert KEYS <= r0.keys() and list(r0)[-1] == "check"
    assert r0["correct"] is True and r0["failed"] == 0 and r0["attempted"] >= 1
    assert set(r0["metrics"]) == {"query_gbps", "setup_s"}
    assert all(m["value"] > 0 for m in r0["metrics"].values())
    r1 = result(run(root, "tiny_en.count-sherlock", seed=2**31 + 11, trace=1))
    assert r1["correct"] is True
    assert r1["metrics"]["out_lines_per_query"] == {"value": 1.0, "unit": "lines"}
    after = _tree_digest(root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("workload", [w["name"] for w in tree_spec()["workloads"]])
def test_every_cell_runs_on_small_inputs(tmp_path, workload):
    """Each cell of BENCHMARK.json (and the linux_tree cell) at small sizes,
    both kinds of run: the reference agrees, and the check closes stderr
    and the result line."""
    root = checkout(tmp_path, tree_spec(), config_params=SMALL)
    for trace in (0, 1):
        proc = run(root, workload, seed=5 + trace, trace=trace)
        r = result(proc)
        assert r["correct"] is True, proc.stderr[-2000:]
        assert list(r)[-1] == "check" and all(v == {"value": 0, "limit": 0}
                                              for v in r["check"].values())
        assert proc.stderr.strip().split("\n")[-3:] == [
            f"check {k} 0 limit 0" for k in ("wrong_stdout", "wrong_stderr", "wrong_rc")]
        if trace == 0:
            # every end-to-end metric of the cell but the card's memory,
            # which a run without a card does not read
            want = {m["name"] for m in tree_spec()["end_to_end"]
                    if workload in m.get("workloads", [workload])} - {"device_memory_gb"}
            assert "setup_s" in want
            assert set(r["metrics"]) == want
            assert all(m["value"] > 0 for m in r["metrics"].values())
        else:
            assert {"unspanned_ms_per_query", "unspanned_ms_per_query.count"} & set(r["metrics"])


def test_no_card_no_result(tmp_path):
    root = checkout(tmp_path, config_params=SMALL)
    proc = run(root, "subtitles_en.count-the", cpu=False)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_no_program_no_result(tmp_path):
    root = checkout(tmp_path, config_params=SMALL, program=False)
    proc = run(root, "subtitles_en.count-the", cpu=False)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--help"], cwd=root,
                          capture_output=True, text=True)
    assert proc.returncode == 0


# faults planted in the program under the timed path (the cells have no
# state that a step could leave unchanged, and one chip: no exchange)
ALTERED = """
import dataclasses
import krep_tpu_torch.engine.search as S
_orig = S.search_string
def _bad(*a, **k):
    r = _orig(*a, **k)
    return dataclasses.replace(r, count=r.count + 1, positions=r.positions[1:])
S.search_string = _bad
"""
HALF_TEXT = """
import krep_tpu_torch.engine.search as S
_orig = S.search_string
def _bad(params, text, *a, **k):
    return _orig(params, text[: len(text) // 2], *a, **k)
S.search_string = _bad
"""

# faults of the -r walk: the last file the walk yields left out, every
# .gitignore passed over, a file's count altered where the batch gives it
SKIP_LAST = """
import krep_tpu_torch.io.walker as W
_orig = W._walk
def _bad(*a, **k):
    files = list(_orig(*a, **k))
    yield from files[:-1]
W._walk = _bad
"""
NO_GITIGNORE = """
import krep_tpu_torch.io.walker as W
_orig = W._walk
def _bad(base_dir, use_gitignore, *a, **k):
    return _orig(base_dir, False, *a, **k)
W._walk = _bad
"""
ALTERED_COUNT = """
import krep_tpu_torch.io.batch as B
_orig = B.drain_batch
def _bad(*a, **k):
    for i, (path, data, r) in enumerate(_orig(*a, **k)):
        yield path, data, (r.__class__(r.count + 1, r.positions, r.text_len) if i == 3 else r)
B.drain_batch = _bad
"""


@pytest.mark.parametrize("workload,fault", [
    ("subtitles_en.count-the", ALTERED), ("subtitles_en.count-the", HALF_TEXT),
    ("subtitles_en.count-list64", ALTERED), ("subtitles_en.count-list64", HALF_TEXT),
    ("subtitles_en.o-the", ALTERED), ("subtitles_en.o-the", HALF_TEXT),
    (TREE_CELL, SKIP_LAST), (TREE_CELL, NO_GITIGNORE), (TREE_CELL, ALTERED_COUNT),
], ids=["the-altered", "the-half", "list64-altered", "list64-half", "o-altered", "o-half",
        "tree-skip-last", "tree-no-gitignore", "tree-altered-count"])
def test_a_broken_program_is_not_correct(tmp_path, workload, fault):
    root = checkout(tmp_path, tree_spec(), config_params=SMALL)
    proc = run(root, workload, seed=9, prelude=fault)
    r = result(proc)
    assert r["correct"] is False and r["failed"] == r["attempted"]
    assert r["check"]["wrong_stdout"]["value"] == r["attempted"] + 1
    assert "first wrong query" in proc.stderr


def test_control_reads_not_correct(tmp_path):
    """The control (each configuration's broken guarantee) at sizes a test
    holds, on three seeds a cell: put in the program's place, the run's own
    check finds it not correct."""
    params = {"subtitles_en": {"bytes": 16 << 20}, "linux_tree": SMALL["linux_tree"]}
    root = checkout(tmp_path, tree_spec(), config_params=params)
    for workload in [w["name"] for w in tree_spec()["workloads"]]:
        proc = subprocess.run([sys.executable, "benchmark/control.py", "--workload", workload,
                               "--seeds", "1,2,3"], cwd=root, capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
        lines = [json.loads(x) for x in proc.stdout.strip().split("\n")]
        assert len(lines) == 3 and all(x["correct"] is False for x in lines), lines
        assert all(x["check"]["wrong_stdout"] == {"value": 1, "limit": 0} for x in lines)


PLANT = "import sys, types; sys.modules[{name!r}] = types.ModuleType({name!r})"


@pytest.mark.parametrize("name,where", [("jax", "metric"), ("krep_tpu.ops", "reference")])
def test_forbidden_module_loaded_after_the_window_gives_no_result(tmp_path, name, where):
    """A module of jax or the JAX package loaded once the window has closed
    (by a metric's reader, or by the reference) still stops the run: exit 2,
    the module named, no result line."""
    root = checkout(tmp_path, config_params=SMALL)
    prelude = ""
    if where == "metric":
        reader = root / "benchmark" / "metrics" / "setup_s.py"
        reader.write_text(reader.read_text().replace(
            "def read(run):\n", "def read(run):\n    " + PLANT.format(name=name) + "\n"))
    else:
        prelude = ("import reference.krep_ref as R\n_answer = R.answer\n"
                   "def _planted(*a, **k):\n    " + PLANT.format(name=name) + "\n"
                   "    return _answer(*a, **k)\nR.answer = _planted")
    proc = run(root, "subtitles_en.count-the", seed=13, prelude=prelude)
    assert proc.returncode == 2 and proc.stdout.strip() == "", proc.stderr[-2000:]
    assert f"loaded {name.split('.')[0]}" in proc.stderr


def test_benchmark_json_names_files_that_exist():
    b = spec()
    for c in b["configs"]:
        assert (BENCH.parent / c["file"]).is_file()
        assert json.loads((BENCH.parent / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_every_metric_moves_a_metric_its_cells_report():
    """Each cell reports setup_s, another end-to-end metric and a per-layer
    metric; a per-layer metric names in `moves` an end-to-end metric that
    each of its cells reports; a `.count` reader is its base reader."""
    b = spec()
    for w in [w["name"] for w in b["workloads"]]:
        e2e = {m["name"] for m in b["end_to_end"] if w in m.get("workloads", [w])}
        assert "setup_s" in e2e and len(e2e) >= 2, w
        assert any(w in m["workloads"] for m in b["per_layer"]), w
        for m in b["per_layer"]:
            if w in m["workloads"]:
                assert m["moves"] in e2e, (w, m["name"])
    names = {m["name"] for m in b["per_layer"]}
    for name in [n for n in names if n.endswith(".count")]:
        split = _reader(name)
        base = _reader(name[: -len(".count")])
        assert split.read.__code__.co_code == base.read.__code__.co_code
        assert getattr(split, "SPANS", {}) == getattr(base, "SPANS", {})


def _reader(name):
    import importlib.util

    spec_ = importlib.util.spec_from_file_location("t_" + name.replace(".", "_"),
                                                   BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def test_device_memory_and_window_rate_readers():
    from types import SimpleNamespace

    mem = _reader("device_memory_gb")
    assert mem.read(SimpleNamespace(memory_peak_bytes=2_150_000_000)) == 2.15
    assert mem.read(SimpleNamespace(memory_peak_bytes=0)) is None
    run_ = SimpleNamespace(target_bytes=10**9, queries=[None] * 30, window_s=2.0)
    assert _reader("window_gbps").read(run_) == _reader("query_gbps").read(run_) == 15.0


def _run_module(root):
    """benchmark/run.py of the scratch checkout at root, imported here."""
    import importlib.util

    spec_ = importlib.util.spec_from_file_location("bench_run_" + root.name,
                                                   root / "benchmark" / "run.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def test_inputs_and_searched_bytes_of_the_cells(tmp_path):
    """Every cell keeps its inputs under benchmark/data/<config>/s<seed>/ of
    its checkout. The bytes a query searches: for the subtitles_en cells the
    corpus file's size, as before the tree walk; for the tree cell the
    bytes of the files its walk searches, fewer than the tree holds."""
    root = checkout(tmp_path, tree_spec(), config_params=SMALL)
    run_mod = _run_module(root)
    from reference import krep_ref

    here = os.getcwd()
    try:
        for w in [w["name"] for w in spec()["workloads"]] + [TREE_CELL]:
            cell = run_mod.Cell(w)
            seed_dir, inputs = run_mod.prepare(cell, 2**40 + 3)
            assert seed_dir == root / "benchmark" / "data" / cell.config_name / f"s{2**40 + 3}"
            argv = [a.format(**inputs) for a in cell.traffic["argv"]]
            os.chdir(seed_dir)
            target = argv[-1]
            ans = krep_ref.answer(argv)
            if w == TREE_CELL:
                every = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(target)
                            for n in ns if not os.path.islink(os.path.join(d, n)))
                assert 0 < ans.searched_bytes < every
                assert ans.searched_files == ans.stdout_lines
            else:
                assert ans.searched_bytes == os.path.getsize(target) == SMALL["subtitles_en"]["bytes"]
                assert ans.searched_files == 1
            os.chdir(here)
    finally:
        os.chdir(here)
