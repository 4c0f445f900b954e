"""krep_tpu_torch's recursive search (-r) against krep_tpu, on the CPU.

The port's first-in-line mask (the scan kernel's mask_kind="first_line",
the -c dedup events of the batched `-r -c` path) is held to the JAX
package's XLA scan and to pallas_swar's kernel in interpret mode; the
port's batch buffer and per-file counts to krep_tpu/io/batch.py; and its
CLI to krep_tpu.cli on a small tree, on the device branch (plain versions
on the CPU), on the native host branch, and with many small batches in
flight. Every comparison is exact. Also checked here: the port imports
nothing of krep_tpu or jax.

The Pallas kernel's -w is wrong after "_^" (ROADMAP queue 3), so -w texts
hold no "^".
"""

import ast
import concurrent.futures
import contextlib
import io
import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naive
from krep_tpu import cli as jcli
from krep_tpu.io import batch as jbatch
from krep_tpu.io import files as jfiles
from krep_tpu.io import walker as jwalker
from krep_tpu.ops import dispatch as jdispatch
from krep_tpu.ops import literal as jliteral
from krep_tpu.ops import pallas_swar
from krep_tpu_torch import cli, convert
from krep_tpu_torch.io import batch, files, walker
from krep_tpu_torch.ops import dispatch, literal, swar
from krep_tpu_torch.parallel import lines

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
BLOCK = literal.BLOCK_BYTES


def stage_both(text: bytes):
    jst = jdispatch.stage(text)
    return jst, convert.staged_from_reference(jst._np, len(text), CPU)


def naive_first_line(text: bytes, starts: list[int]) -> list[int]:
    """Starts that are the first of their line (a start on a '\\n' belongs
    to the line that '\\n' ends)."""
    starts = np.asarray(starts, np.int64)
    line = np.searchsorted(np.flatnonzero(np.frombuffer(text, np.uint8) == 10), starts)
    first = np.ones(len(starts), bool)
    first[1:] = line[1:] != line[:-1]
    return starts[first].tolist()


def straddling_text(seed: int, size: int) -> bytes:
    """Lines of every length: short ones, ones that cross the 256-byte
    thread spans and the 64 KiB block edges with matches on both sides, one
    over three blocks, and blocks that hold no newline."""
    rng = np.random.default_rng(seed)
    words = [b"the", b"cat", b"theme", b"x", b"THE", b"_the", b"at", b"e"]
    out = bytearray()
    while len(out) < size:
        kind = int(rng.integers(0, 10))
        n = {0: 3 * BLOCK + 777}.get(kind, int(rng.integers(1, 1500 if kind < 8 else 40_000)))
        line = bytearray()
        while len(line) < n:
            line += words[int(rng.integers(0, len(words)))] + b" "
        out += line[:n] + b"\n"
    return bytes(out[:size])


FIRST_LINE_CASES = [
    (straddling_text(1, 3 * BLOCK + 5000), b"the", True, False),
    (straddling_text(2, 5 * BLOCK), b"THE", False, False),
    (straddling_text(3, 4 * BLOCK), b"the", True, True),
    (straddling_text(4, 4 * BLOCK), b"e", False, True),
    (naive.gen_english(9, 150_000), b"Holmes", True, False),
    (straddling_text(5, 3 * BLOCK), b"e\nt", True, False),
    (straddling_text(6, 3 * BLOCK), b"\n", True, False),
]


@pytest.mark.parametrize(
    "text,pat,cs,ww", FIRST_LINE_CASES,
    ids=["cs", "i", "w", "i-w-e", "english", "newline-inside", "newline"],
)
def test_first_line_mask_vs_xla(text, pat, cs, ww):
    """scan_literal_staged(mask_kind="first_line") and its plain twin
    literal.block_stats against krep_tpu's XLA scan and tests/naive.py."""
    jst, tst = stage_both(text)
    totals, mask, _ = dispatch.scan_literal_staged(
        tst, pattern=pat, case_sensitive=cs, whole_word=ww, want_mask=True,
        mask_kind="first_line",
    )
    stats, pmask = literal.block_stats(
        tst.u8, tst.true_len, tst.n_blocks, pattern=pat, case_sensitive=cs,
        whole_word=ww, want_mask=True, mask_kind="first_line",
    )
    assert torch.equal(mask, pmask)
    c, l, jmask = jliteral.scan_literal(
        jst.u8, jst.true_len, pattern=pat, case_sensitive=cs, whole_word=ww,
        mask_kind="first_line",
    )
    jmask = np.asarray(jmask)
    body = mask.shape[0]
    assert np.array_equal(mask.numpy(), jmask[:body]) and not jmask[body:].any()
    assert totals[:2].tolist() == [int(c), int(l)] == [int(stats[:, 0].sum()), int(mask.sum())]
    starts = naive.all_starts(text, pat, cs, ww)
    assert torch.nonzero(mask).squeeze(1).tolist() == naive_first_line(text, starts)


def test_first_line_mask_vs_pallas_interpret():
    """~3 x 64 KiB with one line straddling both block edges, matches on
    each side of each edge, against pallas_swar's first_line mode."""
    text = bytearray(b"ab cd\n" * (3 * BLOCK // 6))
    text[BLOCK - 4000 : 2 * BLOCK + 3000] = b"x" * (BLOCK + 7000)  # one line over both edges
    for pos in (BLOCK - 3000, BLOCK - 3, BLOCK + 5, 2 * BLOCK - 2, 2 * BLOCK + 2000):
        text[pos : pos + 3] = b"the"
    text[96:99] = text[2 * BLOCK + 4000 : 2 * BLOCK + 4003] = b"the"
    text = bytes(text)
    jst, tst = stage_both(text)
    _, mask, _ = dispatch.scan_literal_staged(
        tst, pattern=b"the", case_sensitive=True, whole_word=False, want_mask=True,
        mask_kind="first_line",
    )
    c, l, jmask = pallas_swar.scan_literal(
        jst.u32, jst.true_len, pattern=b"the", want_mask=True, want_lines=True,
        mask_kind="first_line", interpret=True,
    )
    jmask = np.asarray(jmask).view(np.uint8)
    assert np.array_equal(mask.numpy(), jmask[: mask.shape[0]])
    assert torch.nonzero(mask).squeeze(1).tolist() == [96, BLOCK - 3000, 2 * BLOCK + 4000]
    assert (int(c), int(l)) == (7, 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_flags_plus_fixup_equal_first_line(seed):
    """The kernel's design on the CPU: first-in-line flags of each 64 KiB
    block as if it began on a closed line, finished by the fix-up's plain
    twin from the block summaries, equal the whole text's flags."""
    text = straddling_text(10 + seed, 6 * BLOCK)
    st = dispatch.stage(text, CPU)
    _, starts, _ = swar.scan_blocks(st.u8, st.true_len, st.n_blocks, pattern=b"the",
                                    want_mask=True)
    stats, want = literal.block_stats(
        st.u8, st.true_len, st.n_blocks, pattern=b"the", want_mask=True, mask_kind="first_line",
    )
    per_block = torch.cat([
        literal.first_in_line_mask(
            starts[b * BLOCK : (b + 1) * BLOCK].bool(), st.u8[b * BLOCK : (b + 1) * BLOCK]
        ).to(torch.uint8)
        for b in range(st.n_blocks)
    ])
    moved = int((per_block != want).sum())
    assert moved > 0  # some block starts inside a line that already has a match
    assert moved <= st.n_blocks
    assert torch.equal(lines.first_line_fixup(stats, per_block), want)


def test_first_line_needs_mask():
    st = dispatch.stage(b"the cat\n", CPU)
    with pytest.raises(ValueError, match="want_mask"):
        swar.scan_blocks(st.u8, st.true_len, st.n_blocks, pattern=b"the", mask_kind="first_line")
    with pytest.raises(ValueError, match="mask_kind"):
        swar.scan_blocks(st.u8, st.true_len, st.n_blocks, pattern=b"the", want_mask=True,
                         mask_kind="lines")


def small_files(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [(f"f{i}", naive.gen_english(seed + i, int(rng.integers(0, 3000)))) for i in range(n)]


def test_batch_buffer_and_file_counts_match_krep_tpu():
    texts = small_files(40, 25) + [("empty", b""), ("one", b"t")]
    ours, theirs = batch.Batch(), jbatch.Batch()
    for path, data in texts:
        ours.add(path, data)
        theirs.add(path, data)
    assert np.array_equal(ours.buffer(), theirs.buffer())
    assert [vars(e) for e in ours.entries] == [vars(e) for e in theirs.entries]
    jst, tst = stage_both(ours.buffer().tobytes())
    _, mask, _ = dispatch.scan_literal_staged(
        tst, pattern=b"the", case_sensitive=True, whole_word=False, want_mask=True,
        mask_kind="first_line",
    )
    edges = np.array([(e.offset, e.offset + e.size) for e in ours.entries], np.int64)
    got = batch._file_counts_dev(mask, torch.from_numpy(edges[:, 0]), torch.from_numpy(edges[:, 1]))
    want = jbatch._file_counts_dev(
        jnp.asarray(mask.numpy()), edges[:, 0].astype(np.int32), edges[:, 1].astype(np.int32),
    )
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist() == [
        naive.matched_lines(data, naive.all_starts(data, b"the")) for _, data in texts
    ]


def _unreadable(path: str):
    return os.path.basename(path) == "locked.txt"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Nested directories, empty files, a binary file, a .gitignore chain,
    a file over BATCH_FILE_MAX (the solo route) and a file whose read fails
    (see `run`)."""
    d = tmp_path_factory.mktemp("rtree")
    rng = np.random.default_rng(42)
    dirs = [d, d / "src", d / "src" / "deep", d / "docs", d / "skip", d / "src" / "gen"]
    for sub in dirs:
        sub.mkdir(exist_ok=True)
    for i in range(18):
        text = b"" if i % 7 == 0 else naive.gen_english(100 + i, int(rng.integers(50, 3000)))
        (dirs[i % len(dirs)] / f"f{i:02d}.txt").write_bytes(text)
    (d / ".gitignore").write_text("skip/\n*.log\n!keep.log\n")
    (d / "src" / ".gitignore").write_text("gen\n")
    (d / "keep.log").write_bytes(b"the log is kept by the negation\n")  # .log: skipped by extension
    (d / "src" / "notes.md").write_bytes(b"the theme\nno\nthe end")
    (d / "big.txt").write_bytes(naive.gen_english(77, batch.BATCH_FILE_MAX + 4096))
    blob = bytearray(naive.gen_english(78, batch.BATCH_FILE_MAX + 10))
    blob[10] = 0
    (d / "docs" / "blob.txt").write_bytes(bytes(blob))  # binary: NUL in its first KiB
    (d / "docs" / "locked.txt").write_bytes(b"the locked file\n")
    return d


def run(main, argv, monkeypatch, **kw):
    """(stdout, stderr, exit code) of one CLI, with reads of locked.txt
    failing as an unreadable file's would."""
    real_open = open

    def guarded_open(path, *a, **k):
        if _unreadable(str(path)):
            raise PermissionError(13, "Permission denied", str(path))
        return real_open(path, *a, **k)

    for mod in (walker, jwalker, files, jfiles):
        monkeypatch.setattr(mod, "open", guarded_open, raising=False)
    out, err = io.BytesIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(list(argv), out=out, **kw)
    return out.getvalue(), err.getvalue(), rc


# tests/test_batch.py:33-44, plus --gitignore and several patterns
RECURSIVE_ARGS = [
    ["-r", "-c", "the"],
    ["-r", "the"],
    ["-r", "-o", "the"],
    ["-r", "-c", "-o", "the"],
    ["-r", "-i", "-w", "-c", "THE"],
    ["-r", "-m", "2", "-o", "the"],
    ["-r", "--gitignore", "-c", "the"],
    ["-r", "-e", "a", "-e", "b"],
]
ROUTES = ["device", "host", "pipelined"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("args", RECURSIVE_ARGS, ids=lambda a: " ".join(a))
def test_cli_recursive_matches_krep_tpu(tree, args, route, monkeypatch):
    """The port's CLI against krep_tpu.cli: stdout, stderr and exit code.
    "device": break-even 0, every batch and solo on the (plain) device
    branch; "host": the native host branch; "pipelined": 4 KiB batches, so
    several are in flight."""
    if route == "host":
        monkeypatch.setenv("KREP_TPU_HOST_BREAKEVEN", str(1 << 30))
    else:
        monkeypatch.setenv("KREP_TPU_HOST_BREAKEVEN", "0")
    if route == "pipelined":
        for mod in (batch, jbatch):
            monkeypatch.setattr(mod, "BATCH_BUFFER_MAX", 4096)
    argv = [*args, str(tree)]
    got = run(cli.main, argv, monkeypatch, device="cpu")
    assert got == run(jcli.main, argv, monkeypatch)
    out, err, rc = got
    assert rc == 2 and "locked.txt: [Errno 13] Permission denied" in err
    assert err.endswith("krep: Encountered 1 errors during recursive search.\n")
    assert b"blob.txt" not in out and b"keep.log" not in out
    assert (b"/skip/" in out) == ("--gitignore" not in args)


def test_cli_recursive_launches_first_line_scan(tree, monkeypatch):
    """-r -c on the device branch runs the scan in its first_line mode and
    reads per-file counts, with no first_line launch for -r -c -o."""
    monkeypatch.setenv("KREP_TPU_HOST_BREAKEVEN", "0")
    calls = []
    real = swar.scan_blocks

    def spy(*a, **k):
        calls.append(k.get("mask_kind", "starts"))
        return real(*a, **k)

    monkeypatch.setattr(swar, "scan_blocks", spy)
    run(cli.main, ["-r", "-c", "the", str(tree)], monkeypatch, device="cpu")
    assert "first_line" in calls
    calls.clear()
    run(cli.main, ["-r", "-c", "-o", "the", str(tree)], monkeypatch, device="cpu")
    assert calls and "first_line" not in calls


class SyncExecutor(concurrent.futures.Executor):
    """A ThreadPoolExecutor stand-in that runs each task as it is submitted,
    so every solo scan of a -r walk is done when the walker next looks."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def submit(self, fn, /, *args, **kwargs):
        fut = concurrent.futures.Future()
        try:
            fut.set_result(fn(*args, **kwargs))
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            fut.set_exception(e)
        return fut


class SlowExecutor(concurrent.futures.ThreadPoolExecutor):
    """A ThreadPoolExecutor whose tasks each start 0.2 s late: solo scans
    still in flight while the walk reads the files after them."""

    def submit(self, fn, /, *args, **kwargs):
        def late(*a, **k):
            time.sleep(0.2)
            return fn(*a, **k)

        return super().submit(late, *args, **kwargs)


def walk_order_reference(argv, monkeypatch):
    """krep_tpu.cli with its solo scans run synchronously: every per-file
    stderr line in walk order, the C binary's (krep.c:3402-3430)."""
    with monkeypatch.context() as m:
        m.setattr(concurrent.futures, "ThreadPoolExecutor", SyncExecutor)
        return run(jcli.main, argv, monkeypatch)


RECURSIVE_ERE = [["-r", "-E", "t.e"], ["-r", "-E", "-c", "[bad"]]


def test_cli_recursive_errors(tree, monkeypatch):
    for argv in (["-r", "-s", "the", "x"], ["-r", "the", str(tree / "big.txt")],
                 ["-r", "-e", "", "-e", "a", str(tree)]):
        got = run(cli.main, argv, monkeypatch, device="cpu")
        assert got == run(jcli.main, argv, monkeypatch)
        assert got[2] == 2
    for args in RECURSIVE_ERE:  # every file solo (batch.eligible_params)
        argv = [*args, str(tree)]
        assert run(cli.main, argv, monkeypatch, device="cpu") == walk_order_reference(
            argv, monkeypatch)


@pytest.mark.parametrize("args", RECURSIVE_ERE, ids=lambda a: " ".join(a))
def test_cli_recursive_stderr_walk_order_with_slow_scans(tree, args, monkeypatch):
    """Solo scans that finish after the walk has read the files behind
    them: the unreadable file's error still follows the compile and search
    errors of the files walked before it."""
    argv = [*args, str(tree)]
    want = walk_order_reference(argv, monkeypatch)
    with monkeypatch.context() as m:
        m.setattr(concurrent.futures, "ThreadPoolExecutor", SlowExecutor)
        got = run(cli.main, argv, monkeypatch, device="cpu")
    assert got == want
    assert "locked.txt: [Errno 13] Permission denied" in got[1]


ISOLATION = r"""
import sys
import krep_tpu_torch, krep_tpu_torch.cli, krep_tpu_torch.engine.search
import krep_tpu_torch.io.walker, krep_tpu_torch.io.batch
import krep_tpu_torch.ops.multi, krep_tpu_torch.ops.dfa, krep_tpu_torch.ops.mxu
import krep_tpu_torch.ops.hostscan, krep_tpu_torch.output.printer
import krep_tpu_torch.native.runtime
import krep_tpu_torch.parallel.mesh, krep_tpu_torch.graft_entry
import krep_tpu_torch.ops.bytescan, krep_tpu_torch.tools.bench_kernel
import krep_tpu_torch.engine.regex_engine, krep_tpu_torch.engine.ere_analyze
import krep_tpu_torch.ops.ac
import krep_tpu_torch.daemon, krep_tpu_torch.native.client
import krep_tpu_torch.tools.bench
import os, tempfile
assert krep_tpu_torch.tools.bench.corpus_bytes(4096).shape == (4096,)
from krep_tpu_torch.ops import hostscan
with tempfile.TemporaryDirectory() as cache:
    os.environ["KREP_TPU_CACHE_DIR"] = cache
    os.environ["KREP_TORCH_DEVICE"] = "cpu"
    hostscan.calibrate(force=True, big_bytes=1 << 16, small_bytes=1 << 14)
    hostscan.threshold()
    krep_tpu_torch.daemon.warm()
bad = sorted(m for m in sys.modules
             if m in ("krep_tpu", "jax") or m.startswith(("krep_tpu.", "jax.", "jaxlib")))
print("foreign:", bad)
"""


def test_port_imports_nothing_of_krep_tpu_or_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", ISOLATION], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "foreign: []" in proc.stdout, proc.stdout


def test_no_module_of_the_port_names_krep_tpu():
    """An AST scan of krep_tpu_torch/**/*.py: no `import krep_tpu...` or
    `from krep_tpu... import`, and no jax."""
    found = []
    for path in sorted((REPO / "krep_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                if root in ("krep_tpu", "jax", "jaxlib"):
                    found.append(f"{path.relative_to(REPO)}:{node.lineno} {name}")
    assert found == []
