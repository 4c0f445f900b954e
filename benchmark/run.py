"""Run one cell of the benchmark once and print one JSON line.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout that holds BENCHMARK.json. The cell names a
configuration (benchmark/configs/<config>.json: a recipe in
benchmark/recipes/ and its parameters) and a traffic mix
(benchmark/traffic/<mix>.json: the argv of one query, with the inputs it
names); each metric is a reader of its own (benchmark/metrics/<name>.py).
The harness finds all of them by the names in BENCHMARK.json.

One run:
1. The inputs: the configuration's files, made from --seed under
   benchmark/data/<config>/s<seed>/ (or found there: the inputs and
   answers of the KEEP_SEEDS seeds used last are kept). No user pays for
   them, so they are made before set-up's clock starts.
2. Set-up: the program's import (torch with it), the check for the card
   (exit 2 without it: never the CPU), and one query, which builds the
   program's kernels on a checkout's first run. setup_s is the time from
   the import to the end of that query.
3. The window: krep_tpu_torch.cli.main(argv) in this process, one query
   after another (a closed loop, one client), each writing its stdout
   into a pipe that a thread reads into a digest; the window closes at the
   end of the first query that ends --seconds or more after it opened.
   With --trace 1 the metrics' host spans are installed and torch.profiler
   records the window.
4. The check: the reference (benchmark/reference, plain NumPy) answers the
   same argv on the same inputs, once per seed; every query's stdout,
   stderr and exit code are held to it. The numbers compared, each beside
   its limit, close standard error and the result line. The bytes a query
   searches, as the reference counts them: its file's size, or for a
   directory (-r) the bytes of the files searched in it.

Nothing of the JAX package or of jax may be loaded when the result is
due: the run then exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import fcntl
import gc
import hashlib
import importlib
import importlib.util
import io
import json
import os
import shutil
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
DATA = BENCH / "data"
PROGRAM = "krep_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "krep_tpu")
for _p in (ROOT, BENCH):  # the program, and the benchmark's own modules
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def parse(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A file of the benchmark's (a metric's reader), by its path."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic and metrics."""

    def __init__(self, name: str):
        spec = load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        conf = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
        self.config = load_json(ROOT / conf["file"])
        self.config_name = conf["name"]
        self.traffic = load_json(BENCH / "traffic" / f"{self.entry['traffic']}.json")
        if self.traffic.get("clients", 1) != 1 or self.traffic.get("loop", "closed") != "closed":
            raise SystemExit("the harness runs a closed loop of one client")

        def mine(metric):
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        # a per-layer metric without `workloads` is read in every cell that
        # reports the end-to-end metric it moves
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name] if m["moves"] in e2e else [])]

    def readers(self, trace: bool) -> dict:
        return {m["name"]: load_module(BENCH / "metrics" / f"{m['name']}.py")
                for m in (self.per_layer if trace else self.end_to_end)}


def isolate() -> None:
    """The program's settings for a run: none of the caller's KREP_*
    settings; its caches inside the checkout, at fixed paths; a cache
    directory with no calibration record, so the default break-even
    routes every query."""
    for k in [k for k in os.environ if k.startswith("KREP_")]:
        del os.environ[k]
    cache = DATA / "krep_cache"
    cache.mkdir(parents=True, exist_ok=True)
    for f in cache.iterdir():
        if f.is_file():
            f.unlink()
    os.environ["KREP_TPU_CACHE_DIR"] = str(cache)
    os.environ["KREP_TORCH_BUILD_DIR"] = str(ROOT / "build" / PROGRAM)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(DATA / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(DATA / "triton")


KEEP_SEEDS = 8  # seeds of a configuration whose inputs and answers are kept


def prepare(cell: Cell, seed: int) -> tuple[Path, dict]:
    """The seed's directory and the inputs by placeholder name (paths
    relative to that directory), made unless they are there for the same
    configuration. Of a configuration, the KEEP_SEEDS seeds used last are
    kept, so that a second set of runs on the same seeds writes nothing."""
    top = DATA / cell.config_name
    here = top / f"s{seed}"
    ready = here / "inputs.json"
    made = load_json(ready) if ready.exists() else {}
    if made.get("config") != cell.config:
        shutil.rmtree(here, ignore_errors=True)
        here.mkdir(parents=True)
        recipe = importlib.import_module(f"recipes.{cell.config['recipe']}")
        files = recipe.make(str(here), cell.config["params"], seed)
        made = {"config": cell.config,
                "inputs": {k: os.path.relpath(v, here) for k, v in files.items()}}
    inputs = made["inputs"]
    for name, inp in cell.traffic.get("inputs", {}).items():
        if name not in inputs:
            recipe = importlib.import_module(f"recipes.{inp['recipe']}")
            (path,) = recipe.make(str(here), inp["params"], int(inp["seed"])).values()
            inputs[name] = os.path.relpath(path, here)
    tmp = ready.with_suffix(".tmp")
    tmp.write_text(json.dumps(made))
    os.replace(tmp, ready)  # also marks the seed as used now
    seeds = sorted((d for d in top.glob("s*") if (d / "inputs.json").exists()),
                   key=lambda d: (d / "inputs.json").stat().st_mtime, reverse=True)
    for other in seeds[KEEP_SEEDS:]:
        shutil.rmtree(other, ignore_errors=True)
    return here, inputs


class Reader(threading.Thread):
    """Reads a pipe to its end: sha256, bytes and newlines of the stream."""

    def __init__(self, fd: int):
        super().__init__(daemon=True)
        self.fd = fd
        self.sha = hashlib.sha256()
        self.bytes = self.lines = 0

    def run(self):
        while True:
            chunk = os.read(self.fd, 1 << 20)
            if not chunk:
                return
            self.sha.update(chunk)
            self.bytes += len(chunk)
            self.lines += chunk.count(b"\n")


def query(main, argv: list[str], device: str) -> SimpleNamespace:
    """One query through the CLI, its stdout read by a thread from a pipe,
    as a user's shell pipes it; the time runs until the output is read."""
    from torch.profiler import record_function

    r, w = os.pipe()
    with contextlib.suppress(OSError):
        fcntl.fcntl(w, fcntl.F_SETPIPE_SZ, 1 << 20)
    reader = Reader(r)
    reader.start()
    err = io.StringIO()
    rc, raised = None, ""
    t0 = time.perf_counter()
    try:
        with open(w, "wb", buffering=1 << 16) as out, contextlib.redirect_stderr(err), \
                record_function("query"):
            rc = main(list(argv), out=out, device=device)
    except Exception as e:  # a query that raises is a wrong answer, not a crash
        raised = f"{type(e).__name__}: {e}"
    reader.join()
    t1 = time.perf_counter()
    os.close(r)
    return SimpleNamespace(seconds=t1 - t0, end=t1, sha256=reader.sha.hexdigest(),
                           bytes=reader.bytes, lines=reader.lines, stderr=err.getvalue(),
                           rc=rc, raised=raised)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def reference(here: Path, traffic_name: str, argv: list[str]) -> dict:
    """The reference's answer for argv in the seed's directory, made once
    for these reference sources."""
    from reference import krep_ref

    key = hashlib.sha256(json.dumps(argv).encode())
    for src in sorted((BENCH / "reference").glob("*.py")):
        key.update(src.read_bytes())
    path = here / f"answer.{traffic_name}.json"
    if path.exists():
        ans = load_json(path)
        if ans.get("key") == key.hexdigest():
            return ans
    t0 = time.perf_counter()
    ans = krep_ref.answer(argv)._asdict()
    ans.update(key=key.hexdigest(), seconds=time.perf_counter() - t0)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(ans))
    os.replace(tmp, path)
    return ans


def faults(q: SimpleNamespace, ans: dict) -> dict:
    """How a query differs from the reference's answer: its stdout, its
    stderr (or an exception) and its exit code."""
    return {"wrong_stdout": q.sha256 != ans["stdout_sha256"] or q.bytes != ans["stdout_bytes"],
            "wrong_stderr": q.stderr != ans["stderr"] or bool(q.raised),
            "wrong_rc": q.rc != ans["rc"]}


def check(queries: list, ans: dict) -> dict:
    """The numbers compared, each with its limit: the queries whose stdout,
    stderr or exit code differ from the reference's."""
    return {k: {"value": sum(faults(q, ans)[k] for q in queries), "limit": 0}
            for k in ("wrong_stdout", "wrong_stderr", "wrong_rc")}


def run_cell(args: argparse.Namespace, device: str = "cuda") -> int:
    """One run of a cell on `device`; returns the exit code. Only the tests
    pass device="cpu", to drive a run without a card."""
    cell = Cell(args.workload)
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"benchmark: the program ({PROGRAM}) is not in this checkout", file=sys.stderr)
        return 2
    isolate()
    t_inputs = time.perf_counter()
    here, inputs = prepare(cell, args.seed % (1 << 63))
    t_inputs = time.perf_counter() - t_inputs

    t0 = time.perf_counter()  # set-up is timed from here
    import torch

    if device == "cuda":
        chips = int(cell.entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"benchmark: the cell needs {chips} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda:0"
        kind = torch.cuda.get_device_name(0)
        torch.cuda.reset_peak_memory_stats(0)
    else:
        kind = "cpu"
    os.chdir(here)
    argv = [a.format(**inputs) for a in cell.traffic["argv"]]
    from krep_tpu_torch import cli

    warm = query(cli.main, argv, device)
    setup_s = time.perf_counter() - t0

    trace = bool(args.trace)
    spans = None
    readers = cell.readers(trace)
    if trace:
        from torch.profiler import record_function

        from tracing import Spans, profiler

        spans = Spans()
        for mod in readers.values():
            for name, targets in getattr(mod, "SPANS", {}).items():
                for t in targets:
                    spans.install(name, t)
        prof = profiler(device != "cpu")
        prof.start()
        window = record_function("window")
        window.__enter__()
    queries = []
    w0 = time.perf_counter()
    while True:
        queries.append(query(cli.main, argv, device))
        if queries[-1].end - w0 >= args.seconds:
            break
    window_s = queries[-1].end - w0
    dev = None
    if trace:
        if device != "cpu":
            torch.cuda.synchronize()
        window.__exit__(None, None, None)
        prof.stop()
        spans.remove()
        from tracing import read_trace

        dev = read_trace(prof)
    peak = torch.cuda.max_memory_allocated(0) if device != "cpu" else 0
    del cli
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ans = reference(here, cell.entry["traffic"], argv)
    t_ref = time.perf_counter() - t_ref
    ms = sorted(q.seconds * 1e3 for q in queries)
    half = len(queries) // 2
    print(f"benchmark: inputs {t_inputs:.3f} s; set-up {setup_s:.3f} s (first query "
          f"{warm.seconds:.3f} s); window {window_s:.3f} s, {len(queries)} queries, ms min "
          f"{ms[0]:.1f} median {ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}, mean of the first half "
          f"{sum(q.seconds for q in queries[:half]) * 1e3 / max(1, half):.1f} and of the second "
          f"{sum(q.seconds for q in queries[half:]) * 1e3 / (len(queries) - half):.1f}; "
          f"reference {t_ref:.3f} s (its answer took {ans['seconds']:.3f} s: "
          f"{ans['searched_files']} files, {ans['searched_bytes']} bytes searched)",
          file=sys.stderr)
    compared = check([warm] + queries, ans)
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    failed = sum(any(faults(q, ans).values()) for q in queries)

    peaks = load_json(BENCH / "peaks.json")
    run = SimpleNamespace(
        queries=queries, window_s=window_s, setup_s=setup_s, argv=argv,
        target_bytes=ans["searched_bytes"], memory_peak_bytes=peak,
        spans={k: tuple(v) for k, v in (spans.totals.items() if spans else [])},
        device=dev, peak=next((v for k, v in peaks.items() if k in kind), None),
    )
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(queries), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device != "cpu" else "cpu", "kind": kind,
                         "count": 1, "memory_peak_bytes": peak}}
    if dev is not None:
        result["device"].update(busy_s=dev["busy_s"], window_s=dev["window_s"])
        result["breakdown"] = {"device_ops": dev["device_ops"], "idle_gaps": dev["idle_gaps"]}
    result["check"] = compared
    if not correct:
        bad = next(q for q in [warm] + queries if any(faults(q, ans).values()))
        print(f"benchmark: first wrong query: stdout {bad.bytes} B sha256 {bad.sha256}, rc "
              f"{bad.rc}, stderr {bad.stderr[-500:]!r} {bad.raised}; reference: stdout "
              f"{ans['stdout_bytes']} B sha256 {ans['stdout_sha256']}, rc {ans['rc']}",
              file=sys.stderr)
    found = forbidden_modules()  # all that this process loaded, the reference and readers too
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 2
    for k, v in compared.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


def main(argv: list[str] | None = None) -> int:
    return run_cell(parse(argv))


if __name__ == "__main__":
    sys.exit(main())
