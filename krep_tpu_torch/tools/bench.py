"""The port's bench: bench.py's configs on krep_tpu_torch, one JSON line each.

    python -m krep_tpu_torch.tools.bench [--all | --only=1,3,...] [--device cuda|cpu]
                                         [--reps N] [--out PATH]

With no option it runs config 1, with --all configs 1-6 (BASELINE.md), with
--only the ones named. Each line carries bench.py's `metric` string letter
for letter, `value` (GB/s) and `unit`, the per-rep times in `reps`, the
corpus size, the device with the card's name and power limit, the kernel
launches of the config, and `count_parity_vs_reference`: the config's count
against `python -m krep_tpu.cli` run as a subprocess on its jax-free native
host route (REFERENCE_ENV). A subprocess is not an import: this module
imports nothing of krep_tpu and never jax.

Corpora (bench.py's recipes, byte for byte: gen_corpus seed 12345,
gen_corpus_ing seed 4242, the config-5 tree seed 7) are written under
$KREP_BENCH_CORPUS_DIR (default: krep_bench_corpus in the temporary
directory), $KREP_BENCH_BYTES bytes each (default 1 GiB), with bench.py's
file names. A file there is reused only when its bytes are the recipe's.

Timing: on a card, each rep of the timed device work is bracketed by CUDA
events after one warm-up; the value is the median rep, with the min, max and
every rep in `reps`. Configs 1 and 6 also report the wall time of
krep_tpu_torch.cli.main on the same file, warm, in this process. With
`--device cpu` the same work runs on the plain PyTorch versions, timed by
the host clock; those numbers are the CPU's, never the card's. Without a
card and without `--device cpu` it exits 2 naming the cause; it never falls
back to the CPU.

Exit code: 0 when every config ran and every parity holds, 1 when a config
failed or a parity is false (the other configs still run), 2 when no
device is available. The artifact of the run (every line, the device) is
written only to --out PATH.
"""

from __future__ import annotations

import argparse
import functools
import io
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .bench_hamming import PATTERNS_16, WORDS, mixed_set, variant_set

BASELINE_GBPS = 5.7  # the C krep's `-c -F the`: ~1 GB / 0.1757 s (BASELINE.md config 1)
PATTERN = b"the"
ING_WORDS = [b"jumping", b"singing", b"working", b"morning", b"nothing",
             b"Running", b"Marking"]
TREE_WORDS = b"the quick brown fox def class import return self value".split()
CONFIG4_ERE = b"[A-Z][a-z]+ing"
# The reference: krep_tpu's CLI on its native host route, which imports no
# jax. route_small sends n x K bytes to the host when they are at most the
# break-even, so it must exceed 1 GiB x 64 patterns (configs 3b-3L), not
# only the 4 GiB that chip_smoke.py's single-pattern checks need.
REFERENCE_ENV = {"KREP_TPU_HOST_BREAKEVEN": str(1 << 40)}
REFERENCE_TIMEOUT_S = 1800

# ---- bench.py's corpora, byte for byte ---------------------------------
#
# bench.py draws each line with numpy calls, about 7 s per 16 MiB; corpus.c
# replays the same draws from the generator's raw 64-bit outputs, which
# numpy makes in bulk (see corpus.c for how numpy consumes them).

_CORPUS_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "corpus.c")
_corpus_lib = None


def _corpus_library():
    """corpus.c, built with the system compiler into ops/_build.build_dir()
    (content-addressed by the source) at first use."""
    global _corpus_lib
    if _corpus_lib is None:
        import ctypes
        import hashlib

        from ..ops._build import build_dir

        with open(_CORPUS_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        path = build_dir() / f"krep_corpus_{tag}.so"
        if not path.exists():
            cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
            if cc is None:
                raise RuntimeError("no C compiler (cc) to build corpus.c")
            path.parent.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=path.parent) as td:
                tmp = os.path.join(td, "corpus.so")
                subprocess.run([cc, "-O2", "-shared", "-fPIC", _CORPUS_SRC, "-o", tmp],
                               check=True, capture_output=True)
                os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.krep_corpus_lines.restype = ctypes.c_int64
        lib.krep_corpus_lines.argtypes = [
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"), ctypes.c_int64, i64p,
            u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, u8p, ctypes.c_int64]
        _corpus_lib = lib
    return _corpus_lib


def recipe_lines(raw: np.ndarray, state: np.ndarray, cap: int, ing: bool) -> np.ndarray:
    """corpus.c's lines from the raw PCG64 outputs `raw` and the draw state
    `state` = [next output, output whose high word waits or -1] (updated):
    whole lines until at least `cap` bytes, or fewer when `raw` runs out."""
    vocab = WORDS + (ING_WORDS if ing else [])
    lens = np.array([len(w) for w in vocab], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    out = np.empty(cap + 256, np.uint8)  # room for the line that crosses cap
    n = _corpus_library().krep_corpus_lines(
        np.ascontiguousarray(raw, np.uint64), raw.shape[0], state,
        np.frombuffer(b"".join(vocab), np.uint8), offs, lens, len(WORDS),
        len(ING_WORDS) if ing else 0, out, cap)
    return out[:n]


def _recipe(size: int, seed: int, ing: bool) -> np.ndarray:
    """bench.py's gen_corpus (ing=False) / gen_corpus_ing (ing=True) bytes:
    whole lines until at least `size` bytes, cut at `size`."""
    bitgen = np.random.default_rng(seed).bit_generator
    out = np.empty(size, np.uint8)
    raw = np.zeros(0, np.uint64)
    state = np.array([0, -1], np.int64)
    written = 0
    while written < size:
        keep = int(state[0] if state[1] < 0 else state[1])  # the first output still unread
        raw = np.concatenate([raw[keep:], bitgen.random_raw(1 << 22)])
        state -= np.where(state >= 0, keep, 0)
        part = recipe_lines(raw, state, size - written, ing)
        take = min(part.shape[0], size - written)
        out[written : written + take] = part[:take]
        written += take
    return out


def corpus_bytes(size: int) -> np.ndarray:
    """bench.py's config-1 corpus (gen_corpus, bench.py:38-60, seed 12345)."""
    return _recipe(size, 12345, ing=False)


def corpus_ing_bytes(size: int) -> np.ndarray:
    """bench.py's config-4 corpus (gen_corpus_ing, bench.py:520-549, seed
    4242): about 3% of its lines hold an 'ing' word."""
    return _recipe(size, 4242, ing=True)


def _keep_or_write(path: str, data: np.ndarray) -> None:
    """`path` holds `data` afterwards; an existing file is kept when its
    bytes are already these."""
    if os.path.exists(path) and os.path.getsize(path) == data.shape[0]:
        if np.array_equal(np.fromfile(path, np.uint8), data):
            return
    tmp = f"{path}.{os.getpid()}.tmp"
    data.tofile(tmp)
    os.replace(tmp, path)


def gen_corpus(path: str, size: int) -> None:
    """bench.py's gen_corpus(path, size)."""
    _keep_or_write(path, corpus_bytes(size))


def gen_corpus_ing(path: str, size: int) -> None:
    """bench.py's gen_corpus_ing(path, size)."""
    _keep_or_write(path, corpus_ing_bytes(size))


def config5_files() -> dict[str, bytes]:
    """bench.py:648-666's tree, as {relative path: bytes}: 20 directories of
    50 files of 5,000-40,000 bytes (lines of six TREE_WORDS), seed 7, and a
    .gitignore that drops pkg19/. bench.py's own loop (about 22 MB, some
    seconds), made once a process."""
    return dict(_config5_files())


@functools.lru_cache(maxsize=1)
def _config5_files() -> dict[str, bytes]:
    rng = np.random.default_rng(7)
    files = {}
    for d in range(20):
        for i in range(50):
            k = rng.integers(5_000, 40_000)
            lines = []
            t = 0
            while t < k:
                ln = b" ".join(TREE_WORDS[j] for j in rng.integers(0, len(TREE_WORDS), 6))
                lines.append(ln)
                t += len(ln) + 1
            files[os.path.join(f"pkg{d:02d}", f"m{i:03d}.py")] = b"\n".join(lines)
    files[".gitignore"] = b"pkg19/\n"
    return files


def gen_config5_tree(root: str) -> None:
    """bench.py's config-5 tree at `root`; an existing tree is kept when it
    holds exactly these files with these bytes."""
    files = config5_files()
    if os.path.isdir(root):
        found = {os.path.relpath(os.path.join(r, f), root)
                 for r, _, fs in os.walk(root) for f in fs}
        if found == set(files) and all(
                pathlib.Path(root, p).read_bytes() == b for p, b in files.items()):
            return
        shutil.rmtree(root)
    for rel, data in files.items():
        os.makedirs(os.path.dirname(os.path.join(root, rel)) or root, exist_ok=True)
        with open(os.path.join(root, rel), "wb") as f:
            f.write(data)


# ---- the configs ---------------------------------------------------------

METRICS = {  # bench.py's metric strings, letter for letter
    "1": "fixed-string -c scan throughput (pattern 'the', 1GiB english-like corpus)",
    "2": "-i -w single-char match-count scan (config 2)",
    "3": "16-literal multi-pattern fused scan (config 3)",
    "3b": "64-literal multi-pattern count (config 3b, MXU route)",
    "3c": "64-literal mixed-length (4-20B) multi-pattern count "
          "(config 3c, MXU two-window route)",
    "3w": "64-literal mixed-length whole-word (-w) multi-pattern count "
          "(config 3w, MXU boundary-dot route)",
    "3L": "64-literal mixed-length multi-pattern LINE count "
          "(config 3L, MXU mask chained into the line kernel)",
    "4": "POSIX ERE '[A-Z][a-z]+ing' (config 4, factor-hit corpus: device "
         "count+mask passes + host regexec on candidate lines)",
    "5": "-r --gitignore source-tree scan (config 5, end-to-end warm)",
    "6": "-o positions at scale (config 6: device mask + packed compaction "
         "+ greedy policy + bulk -o printer to /dev/null)",
}
CLI_REPS = 3  # warm runs of krep_tpu_torch.cli.main a timed CLI config takes


class Run:
    """One run's device, corpus and timing settings."""

    def __init__(self, device: torch.device, reps: int, size: int, corpus_dir: str):
        self.device, self.reps, self.size, self.corpus_dir = device, reps, size, corpus_dir
        self.card = card() if device.type == "cuda" else "cpu"
        os.makedirs(corpus_dir, exist_ok=True)
        self.path = os.path.join(corpus_dir, f"bench_{size}.txt")
        gen_corpus(self.path, size)
        self.data = np.fromfile(self.path, np.uint8)
        self._staged = None

    @property
    def staged(self):
        if self._staged is None:
            from ..ops import dispatch

            self._staged = dispatch.stage(self.data, self.device)
        return self._staged

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def time(self, fn) -> dict:
        """One warm-up of fn, then `reps` reps, each bracketed by CUDA events
        on a card (by the host clock on the CPU): the milliseconds of each
        and their median, min and max."""
        fn()
        self.sync()
        ms = []
        for _ in range(self.reps):
            if self.device.type == "cuda":
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                torch.cuda.synchronize(self.device)
                ms.append(e0.elapsed_time(e1))
            else:
                t0 = time.perf_counter()
                fn()
                ms.append(1e3 * (time.perf_counter() - t0))
        return {"clock": "cuda events" if self.device.type == "cuda" else "host",
                "warmup": 1, "n": self.reps, "median_ms": statistics.median(ms),
                "min_ms": min(ms), "max_ms": max(ms), "ms": ms}

    def cli(self, argv: list[str], out=None) -> dict:
        """krep_tpu_torch.cli.main(argv) in this process: one warm-up, then
        CLI_REPS timed runs (host clock, wall time). Returns their seconds
        and the last run's stdout and exit code."""
        from .. import cli

        def once():
            buf = io.BytesIO() if out is None else out
            t0 = time.perf_counter()
            rc = cli.main(list(argv), out=buf, device=self.device)
            return time.perf_counter() - t0, rc, buf

        once()
        runs = [once() for _ in range(CLI_REPS)]
        secs = [r[0] for r in runs]
        _, rc, buf = runs[-1]
        return {"seconds": statistics.median(secs), "runs_s": secs, "rc": rc,
                "stdout": buf.getvalue() if out is None else b""}

    def pattern_file(self, name: str, patterns) -> str:
        path = os.path.join(self.corpus_dir, name)
        with open(path, "wb") as f:
            f.write(b"\n".join(patterns))
        return path


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    lines = proc.stdout.strip().splitlines()
    return lines[0] if lines else f"{torch.cuda.get_device_name(0)} (nvidia-smi: no output)"


def launch_counts() -> dict:
    """The port's kernel launch counters (each wrapper counts its launches
    on a card; the plain versions count none)."""
    from ..ops import ac, bytescan, mxu, swar

    return {"scan_blocks": swar.LAUNCHES, "scan_blocks first_line": swar.FIRST_LINE_LAUNCHES,
            "scan_blocks_multi": swar.MULTI_LAUNCHES, "lines_blocks": swar.LINES_LAUNCHES,
            "combine_blocks": swar.COMBINE_LAUNCHES, "hamming_scan": mxu.LAUNCHES,
            "scan_bytes": bytescan.LAUNCHES, "dfa_scan": ac.LAUNCHES}


def record(key: str, gbps: float, fields: dict, ours: int | bytes, ref_args: list[str],
           ref_env: dict | None = None) -> dict:
    """One config's line, with what its parity check runs: krep_tpu's CLI on
    ref_args must print `ours`, a count (the number after the last ':' of
    its stdout) or, as bytes, the stdout itself (its lines as a
    multiset)."""
    rec = {"metric": METRICS[key], "config": key, "value": gbps, "unit": "GB/s",
           "vs_baseline": gbps / BASELINE_GBPS,
           "match_count": ours.count(b"\n") if isinstance(ours, bytes) else ours}
    rec.update(fields)
    rec["_reference"] = (ref_args, ref_env or {}, ours)
    return rec


def _gbps(nbytes: int, ms: float) -> float:
    return nbytes / (ms * 1e-3) / 1e9


def config1(run: Run) -> dict:
    """-c 'the': the matched lines of the single-literal scan, its tail
    folding them in the launch (the -c call site)."""
    from ..ops import dispatch

    st = run.staged

    def scan():
        return dispatch.scan_literal_staged(st, pattern=PATTERN, case_sensitive=True,
                                            whole_word=False, want_mask=False)[0]

    reps = run.time(scan)
    lines = int(scan()[1])
    c = run.cli(["-c", PATTERN.decode(), run.path])
    cli_count = int(c["stdout"].rsplit(b":", 1)[-1])
    if c["rc"] != 0 or cli_count != lines:
        raise RuntimeError(f"config 1: the CLI says {c['stdout']!r} (rc {c['rc']}), "
                           f"the kernels {lines}")
    return record("1", _gbps(run.size, reps["median_ms"]), {
        "line_count": lines, "corpus_bytes": run.size, "reps": reps,
        "cli_seconds": c["seconds"], "cli_runs_s": c["runs_s"],
        "cli_gbps": run.size / c["seconds"] / 1e9},
        lines, ["-c", PATTERN.decode(), run.path])


def config2(run: Run) -> dict:
    """-c -o -i -w 'e': the single-literal match count; parity on a 32 MiB
    prefix, as bench.py does (bench.py:294-311)."""
    from ..ops import dispatch

    def count(st):
        return dispatch.scan_literal_staged(st, pattern=b"e", case_sensitive=False,
                                            whole_word=True, want_mask=False)[0]

    reps = run.time(lambda: count(run.staged))
    pfx_bytes = min(run.size, 32 << 20)
    pfx_path = run.path + ".pfx32m"
    _keep_or_write(pfx_path, run.data[:pfx_bytes])
    c0 = int(count(dispatch.stage(run.data[:pfx_bytes], run.device))[0])
    return record("2", _gbps(run.size, reps["median_ms"]), {
        "parity_prefix_bytes": pfx_bytes, "corpus_bytes": run.size, "reps": reps},
        c0, ["-c", "-o", "-i", "-w", "e", pfx_path])


def config3(run: Run) -> dict:
    """The 16 literals of BASELINE config 3 in one K-pattern pass, their
    total match count (bench.py:330-359)."""
    from ..ops import dispatch

    pats16 = tuple(PATTERNS_16)

    def count16():
        return dispatch.scan_multi_staged(run.staged, patterns=pats16, case_sensitive=True,
                                          whole_word=False, want_mask=False)[0]

    reps = run.time(count16)
    args16 = ["-c", "-o"]
    for w in pats16:
        args16 += ["-e", w.decode()]
    return record("3", _gbps(run.size, reps["median_ms"]), {"corpus_bytes": run.size,
                                                            "reps": reps},
                  int(count16()[0]), [*args16, run.path])


def _routed_count(run: Run, key: str, pats, whole_word: bool, pfile: str) -> dict:
    """A 64-member set's match count on the routed path
    (multi.fused_count_device: the Hamming kernel from K = 32), timed on
    the production route (not strict: fresh staging zeroes the tail) and
    counted strictly for the parity (bench.py:388-396). bench.py timed
    chained with_len views of a copy with a zeroed tail; the same staging
    timed again needs no such copy."""
    from ..ops import multi

    st = run.staged
    reps = run.time(lambda: multi.fused_count_device(st, pats, True, whole_word, strict=False))
    exact = multi.fused_count_device(st, pats, True, whole_word, strict=True)
    fields = {"corpus_bytes": run.size, "reps": reps}
    if key != "3b":
        fields["pattern_lengths"] = sorted({len(p) for p in pats})
    return record(key, _gbps(run.size, reps["median_ms"]), fields, exact,
                  [*(["-w"] if whole_word else []), "-c", "-o", "-f", pfile, run.path])


def config3b(run: Run) -> dict:
    """bench.py's 64 eight-byte variants of the 16 literals (:361-411)."""
    pats = variant_set(64)
    return _routed_count(run, "3b", pats, False, run.pattern_file("bench_pats64.txt", pats))


def config3c(run: Run) -> dict:
    """bench.py's 64 mixed 4-20 byte members (:413-455): two windows."""
    pats = mixed_set()
    return _routed_count(run, "3c", pats, False, run.pattern_file("bench_pats_mixed.txt", pats))


def config3w(run: Run) -> dict:
    """The mixed members with -w (:457-483)."""
    pats = mixed_set()
    return _routed_count(run, "3w", pats, True, run.pattern_file("bench_pats_mixed.txt", pats))


def config3L(run: Run) -> dict:
    """The mixed members' matched lines (-c without -o, :485-512): their
    union mask into the lines kernel."""
    from ..ops import multi

    pats = mixed_set()
    reps = run.time(lambda: multi.fused_lines_device(run.staged, pats, True, False))
    return record("3L", _gbps(run.size, reps["median_ms"]), {"corpus_bytes": run.size,
                                                             "reps": reps},
                  multi.fused_lines_device(run.staged, pats, True, False),
                  ["-c", "-f", run.pattern_file("bench_pats_mixed.txt", pats), run.path])


def config4(run: Run) -> dict:
    """-c -o -E '[A-Z][a-z]+ing' on the config-4 corpus as the prefilter
    runs it (bench.py:554-637): the factor scan's count pass and mask pass
    (timed on the device), then one host pass (the mask's readback and
    compaction, the candidate lines, glibc's regexec over them through the
    native ranges loop); end to end n / (count + mask + host). The
    reference runs glibc alone (its prefilter off)."""
    from ..engine import ere_analyze, regex_engine
    from ..native import runtime as native
    from ..ops import dispatch

    n = run.size
    a = ere_analyze.analyze(CONFIG4_ERE)
    if a is None or not (a.newline_safe and a.literals):
        raise RuntimeError(f"config 4: {CONFIG4_ERE!r} has no literal factor")
    lits = tuple(a.literals)
    path4 = os.path.join(run.corpus_dir, f"bench_ing_{n}.txt")
    gen_corpus_ing(path4, n)
    data4 = np.fromfile(path4, np.uint8)
    st = dispatch.stage(data4, run.device)

    def scan(want_mask):
        kw = dict(case_sensitive=True, whole_word=False, want_mask=want_mask)
        if len(lits) == 1:
            return dispatch.scan_literal_staged(st, pattern=lits[0], **kw)
        return dispatch.scan_multi_staged(st, patterns=lits, **kw)

    reps_count = run.time(lambda: scan(False)[0])
    reps_mask = run.time(lambda: scan(True)[1])
    _, mask, group_counts = scan(True)
    run.sync()
    t0 = time.perf_counter()
    starts = dispatch.starts_from_device_mask(mask, n, group_counts)
    t_compact = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranges = regex_engine._candidate_line_ranges(data4, starts)
    t_ranges = time.perf_counter() - t0
    data_b = data4.tobytes()
    t0 = time.perf_counter()
    count, _ = native.regex_search_ranges(
        CONFIG4_ERE, data_b, ranges, regex_engine.REG_EXTENDED | regex_engine.REG_NEWLINE,
        False, False, False, 1 << 62)
    t_regexec = time.perf_counter() - t0
    t_host = t_compact + t_ranges + t_regexec
    t_dev = 1e-3 * (reps_count["median_ms"] + reps_mask["median_ms"])
    cand_bytes = int((ranges[:, 1] - ranges[:, 0]).sum()) if len(ranges) else 0
    return record("4", n / (t_dev + t_host) / 1e9, {
        "factor_scan_gbps": _gbps(n, reps_count["median_ms"]),
        "mask_pass_gbps": _gbps(n, reps_mask["median_ms"]),
        "candidate_lines": int(len(ranges)),
        "candidate_line_density_pct": 100 * cand_bytes / n,
        "host_seconds": t_host, "compact_s": t_compact,
        "ranges_s": t_ranges, "regexec_s": t_regexec,
        "corpus_bytes": n, "reps_count": reps_count, "reps_mask": reps_mask},
        int(count), ["-c", "-o", "-E", CONFIG4_ERE.decode(), path4],
        {"KREP_TPU_REGEX_FILTER_MIN": str(n + 1)})


def config5(run: Run) -> dict:
    """-r --gitignore -c the over bench.py's source tree, warm, in this
    process, after hostscan.calibrate() has measured this machine's
    break-even (a calibration that fails fails the config)."""
    from ..ops import hostscan

    tree = os.path.join(run.corpus_dir, "bench_tree")
    gen_config5_tree(tree)
    total = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(tree) for f in fs)
    cal = hostscan.calibrate(device=run.device)
    argv = ["-r", "--gitignore", "-c", PATTERN.decode(), tree]
    c = run.cli(argv)
    return record("5", total / c["seconds"] / 1e9, {
        "files": c["stdout"].count(b"\n"), "tree_bytes": total,
        "seconds": c["seconds"], "runs_s": c["runs_s"],
        "host_breakeven": cal, "threshold_bytes": hostscan.threshold()},
        c["stdout"], argv)


def config6(run: Run) -> dict:
    """-o 'the' at scale (bench.py:710-781): the start-mask pass (timed on
    the device), the packed compaction of its readback, the greedy -o
    policy and the bulk -o printer to /dev/null; beside it the CLI's own
    `-o the` to /dev/null, warm."""
    from ..engine import resolve
    from ..ops import dispatch
    from ..output import printer
    from ..params import MatchPolicy

    st, n, m = run.staged, run.size, len(PATTERN)

    def mask_pass():
        return dispatch.scan_literal_staged(st, pattern=PATTERN, case_sensitive=True,
                                            whole_word=False, want_mask=True)

    reps = run.time(lambda: mask_pass()[1])
    _, mask, group_counts = mask_pass()
    run.sync()
    t0 = time.perf_counter()
    starts = dispatch.starts_from_device_mask(mask, n, group_counts)
    t_compact = time.perf_counter() - t0
    t0 = time.perf_counter()
    kept = resolve.apply_policy(starts, m, MatchPolicy.NONOVERLAP, n)
    t_policy = time.perf_counter() - t0
    positions = np.stack([kept, kept + m], axis=1).astype(np.int64)
    with open(os.devnull, "wb") as sink:
        t0 = time.perf_counter()
        printer.print_only_matching(sink, run.data, positions, "corpus.txt", False)
        t_print = time.perf_counter() - t0
        c = run.cli(["-o", PATTERN.decode(), run.path], out=sink)
    if c["rc"] != (0 if len(kept) else 1):
        raise RuntimeError(f"config 6: the CLI's `-o the` exited {c['rc']}")
    t_dev = 1e-3 * reps["median_ms"]
    return record("6", n / (t_dev + t_compact + t_policy + t_print) / 1e9, {
        "mask_pass_gbps": _gbps(n, reps["median_ms"]),
        "compact_s": t_compact, "policy_s": t_policy,
        "print_s": t_print, "corpus_bytes": n, "reps_mask": reps,
        "cli_seconds": c["seconds"], "cli_runs_s": c["runs_s"],
        "cli_gbps": n / c["seconds"] / 1e9},
        int(len(positions)), ["-c", "-o", PATTERN.decode(), run.path])


CONFIGS = {"1": config1, "2": config2, "3": config3, "3b": config3b, "3c": config3c,
           "3w": config3w, "3L": config3L, "4": config4, "5": config5, "6": config6}
FAMILIES = {"3": ("3", "3b", "3c", "3w", "3L")}  # --only=3 runs bench.py's config-3 family
# the configs whose kernels must have launched on a card (config 5's
# batches may take the host route, as the calibrated break-even decides)
MUST_LAUNCH = {"1", "2", "3", "3b", "3c", "3w", "3L", "4", "6"}
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def reference(args: list[str], env_extra: dict) -> tuple[bytes, int, str]:
    """`python -m krep_tpu.cli args` from the repository root, on its native
    host route, with none of this process's KREP_TPU_*/KREP_TORCH_* knobs:
    (stdout, exit code, stderr)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("KREP_TPU_", "KREP_TORCH_"))}
    env.update(REFERENCE_ENV, **env_extra)
    proc = subprocess.run([sys.executable, "-m", "krep_tpu.cli", *args], cwd=REPO, env=env,
                          capture_output=True, timeout=REFERENCE_TIMEOUT_S)
    return proc.stdout, proc.returncode, proc.stderr.decode(errors="replace")


def check_parity(rec: dict) -> None:
    """Sets rec's parity fields from its reference run; a reference that
    does not run is a failed parity."""
    args, env_extra, want = rec.pop("_reference")
    t0 = time.perf_counter()
    try:
        out, rc, err = reference(args, env_extra)
    except (OSError, subprocess.TimeoutExpired) as e:
        out, rc, err = b"", -1, str(e)
    rec["reference_seconds"] = time.perf_counter() - t0
    if rc not in (0, 1) or err:
        rec["count_parity_vs_reference"] = False
        rec["reference_error"] = f"exit {rc}: {err[-500:]}"
        return
    if isinstance(want, bytes):
        rec["reference_count"] = out.count(b"\n")
        rec["count_parity_vs_reference"] = sorted(out.splitlines()) == sorted(want.splitlines())
        return
    rec["reference_count"] = int(out.rsplit(b":", 1)[-1])
    rec["count_parity_vs_reference"] = rec["reference_count"] == want


def run_configs(run: Run, keys: list[str]) -> dict:
    """Each config's line (a config that raises gives a line with
    `failed`), timed one after another, then every parity check, four
    reference processes at a time."""
    records = []
    for key in keys:
        before = launch_counts()
        try:
            rec = CONFIGS[key](run)
        except Exception as e:  # noqa: BLE001 - reported in the line, and the exit code
            traceback.print_exc()
            records.append({"metric": METRICS[key], "config": key, "value": None,
                            "failed": f"{type(e).__name__}: {e}"})
            continue
        rec["launches"] = {k: v - before[k] for k, v in launch_counts().items() if v > before[k]}
        rec["device"], rec["card"] = run.device.type, run.card
        if run.device.type == "cuda" and key in MUST_LAUNCH and not rec["launches"]:
            rec["failed"] = "no kernel launched on the card"
        records.append(rec)
    with ThreadPoolExecutor(max_workers=4) as pool:
        list(pool.map(check_parity, [r for r in records if "_reference" in r]))
    return records


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m krep_tpu_torch.tools.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--all", action="store_true", help="configs 1-6")
    ap.add_argument("--only", default="",
                    help="comma-separated configs, e.g. 1,3,5 (3: 3, 3b, 3c, 3w and 3L)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reps", type=int, default=10, help="timed reps after one warm-up")
    ap.add_argument("--out", help="write the run's lines here as one JSON document")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        cause = ("no CUDA device: torch.cuda.is_available() is False "
                 "(--device cpu runs the plain versions on the CPU)")
        sys.stderr.write(f"bench: {cause}\n")
        print(json.dumps({"error": cause}), flush=True)
        return 2
    only = {k for name in a.only.split(",") for k in FAMILIES.get(name, (name,))}
    keys = [k for k in CONFIGS if a.all or k in only] or ["1"]
    corpus_dir = os.environ.get("KREP_BENCH_CORPUS_DIR",
                                os.path.join(tempfile.gettempdir(), "krep_bench_corpus"))
    size = int(os.environ.get("KREP_BENCH_BYTES", 1 << 30))
    run = Run(torch.device(a.device), a.reps, size, corpus_dir)
    records = run_configs(run, keys)
    for rec in records:
        print(json.dumps(rec), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"measured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
                       "device": a.device, "card": run.card, "torch": torch.__version__,
                       "corpus_bytes": size, "reps": a.reps, "configs": records}, f, indent=1)
    bad = [r["metric"] for r in records
           if "failed" in r or r.get("count_parity_vs_reference") is not True]
    if bad:
        sys.stderr.write(f"bench: {len(bad)} config(s) failed or differ from the reference: "
                         f"{bad}\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
