#!/usr/bin/env python
"""Differential soak of krep_tpu_torch (on the card) against krep_tpu.

    python tools/soak_fuzz_torch.py [--seconds 1800] [--seed-base N] [--device cuda|cpu]

tools/soak_fuzz.py drives the fuzz generators of tests/test_fuzz_oracle.py
and tests/test_fuzz_regex.py through fresh seeds against the C binary;
this soak drives the same generators, in the same batches and proportions
per round, through both packages' CLIs in this process, and adds one batch
of texts of 4-12 MiB (large_batch). Each case's stdout, stderr and exit code
must be identical, with the file path normalised.

- The port runs on --device (default cuda: the CUDA kernels of
  krep_tpu_torch/csrc on every case) with KREP_TPU_HOST_BREAKEVEN=0, so
  even a 2 KB text is staged and scanned on the card, its -E prefilter
  minimum at 0 (every text with a factor set goes through the prefilter's
  kernels), KREP_TPU_DFA=1 on a share of the sets of more than 64 patterns
  (csrc/dfa_scan.cu) and KREP_TPU_BACKEND=pallas on a share of the
  literal cases (csrc/byte_scan.cu).
- krep_tpu runs on its native host route, which imports no jax: a
  break-even above every n x K the soak makes, its -E prefilter off (glibc
  alone), its -r solo scans run synchronously (its walker's stderr order
  depends on their timing; the port's does not). An attempt to import jax
  ends the soak with exit 2 and a line that says the reference left its
  native route; it is never counted as a mismatch.

Each side's KREP_TPU_* settings are set around its own call and restored.
On the first mismatch the soak prints a standalone repro (seed, batch,
case, args, the port's device and knobs, the text or tree kept under the
temporary directory) and exits 1. A clean budget exits 0, after one line
per batch with its case count and one JSON line with the port's kernel
launches.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import io
import json
import os
import pathlib
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (REPO, os.path.join(REPO, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402


class _JaxGuard:
    """A meta-path finder that refuses jax and counts the attempts, even
    those a caller's `except Exception` swallows."""

    attempts = 0

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            self.attempts += 1
            raise ImportError(f"the soak refuses to import {name}")
        return None


_GUARD = _JaxGuard()
if __name__ == "__main__" and "jax" not in sys.modules:
    sys.meta_path.insert(0, _GUARD)


import test_fuzz_oracle as fo  # noqa: E402  (generators only: no oracle call)
import test_fuzz_regex as fr  # noqa: E402
from krep_tpu import cli as jcli  # noqa: E402
from krep_tpu.engine import regex_engine as jregex  # noqa: E402
from krep_tpu_torch import cli as tcli  # noqa: E402
from krep_tpu_torch.engine import regex_engine as tregex  # noqa: E402
from krep_tpu_torch.io import batch as tbatch  # noqa: E402
from krep_tpu_torch.tools.bench import launch_counts  # noqa: E402

# every knob either side reads at call time; unset unless a side sets it
KNOBS = ("KREP_TPU_HOST_BREAKEVEN", "KREP_TPU_DFA", "KREP_TPU_BACKEND", "KREP_TPU_STRICT",
         "KREP_TPU_MXU", "KREP_TPU_MXU_LINES", "KREP_TPU_PROFILE", "KREP_TORCH_DEVICE")
REFERENCE_KNOBS = {"KREP_TPU_HOST_BREAKEVEN": str(1 << 40), "KREP_TPU_STRICT": "1"}
DFA_SHARE = 0.5      # of the sets of more than 64 patterns
PALLAS_SHARE = 0.25  # of the literal cases


class Mismatch(Exception):
    """A case on which the two packages differ; str() is its repro."""


class ReferenceLeftNativeRoute(Exception):
    """krep_tpu tried to import jax: it left its native host route."""


@contextlib.contextmanager
def _knobs(values: dict):
    """Every KNOBS variable unset but those `values` sets, inside the block."""
    saved = {k: os.environ.get(k) for k in KNOBS}
    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ.update({k: v for k, v in values.items() if v is not None})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _SyncExecutor(concurrent.futures.Executor):
    """Runs each task when it is submitted: krep_tpu's -r solo scans then
    finish in walk order, and so do its stderr lines."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def submit(self, fn, /, *args, **kwargs):
        fut = concurrent.futures.Future()
        try:
            fut.set_result(fn(*args, **kwargs))
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            fut.set_exception(e)
        return fut


class Soak:
    """The two CLIs side by side, with each side's settings; a context
    manager that sets the prefilter minimums and restores them."""

    def __init__(self, device: str):
        self.device = device
        self.guard = None
        self.cases: dict[str, int] = {}

    def __enter__(self):
        self._saved = (tregex.REGEX_FILTER_MIN_BYTES, jregex.REGEX_FILTER_MIN_BYTES)
        tregex.REGEX_FILTER_MIN_BYTES = 0
        jregex.REGEX_FILTER_MIN_BYTES = 1 << 62
        return self

    def __exit__(self, *exc):
        tregex.REGEX_FILTER_MIN_BYTES, jregex.REGEX_FILTER_MIN_BYTES = self._saved

    @staticmethod
    def _call(main, argv, stdin: bytes | None, **kw) -> tuple[bytes, bytes, int]:
        out, err = io.BytesIO(), io.StringIO()
        old_stdin = sys.stdin
        if stdin is not None:
            class _Stdin:
                buffer = io.BytesIO(stdin)

            sys.stdin = _Stdin()
        try:
            with contextlib.redirect_stderr(err):
                rc = main(list(argv), out=out, **kw)
        finally:
            sys.stdin = old_stdin
        return out.getvalue(), err.getvalue().encode(), rc

    def port(self, argv, stdin=None, dfa=False, backend=None):
        knobs = {"KREP_TPU_HOST_BREAKEVEN": "0", "KREP_TPU_STRICT": "1",
                 "KREP_TPU_DFA": "1" if dfa else None, "KREP_TPU_BACKEND": backend}
        with _knobs(knobs):
            return self._call(tcli.main, argv, stdin, device=self.device)

    def reference(self, argv, stdin=None):
        before = self.guard.attempts if self.guard else 0
        real = concurrent.futures.ThreadPoolExecutor
        concurrent.futures.ThreadPoolExecutor = _SyncExecutor
        try:
            with _knobs(REFERENCE_KNOBS):
                got = self._call(jcli.main, argv, stdin)
        except ImportError as e:
            raise ReferenceLeftNativeRoute(f"{argv}: {e}") from e
        finally:
            concurrent.futures.ThreadPoolExecutor = real
        if self.guard and self.guard.attempts > before:
            raise ReferenceLeftNativeRoute(f"{argv}: krep_tpu tried to import jax")
        return got

    def compare(self, batch, seed, case, argv, keep, stdin=None, norm=(), dfa=False,
                backend=None) -> None:
        """Both CLIs on argv; raises Mismatch (with a repro that keeps
        `keep`, a text or a directory) unless stdout, stderr and the exit
        code are identical once each path in `norm` reads F."""
        try:
            got = self.port(argv, stdin, dfa, backend)
        except Exception as e:  # noqa: BLE001 - a CLI that raises differs: the repro says so
            got = (b"", f"raised {type(e).__name__}: {e}".encode(), None)
        try:
            want = self.reference(argv, stdin)
        except ReferenceLeftNativeRoute:
            raise
        except Exception as e:  # noqa: BLE001
            want = (b"", f"raised {type(e).__name__}: {e}".encode(), None)

        def normed(res):
            out, err, rc = res
            for p in norm:
                out, err = out.replace(p.encode(), b"F"), err.replace(p.encode(), b"F")
            return out, err, rc

        g, w = normed(got), normed(want)
        if g != w:
            raise Mismatch(repro(batch, seed, case, argv, keep, stdin, g, w, self.device,
                                 dfa, backend))
        self.cases[batch] = self.cases.get(batch, 0) + 1


def repro(batch, seed, case, argv, keep, stdin, got, want, device, dfa, backend) -> str:
    kept = tempfile.mkdtemp(prefix="soak_repro_")
    if isinstance(keep, (bytes, bytearray)):
        with open(os.path.join(kept, "text"), "wb") as f:
            f.write(keep)
    elif keep is not None:
        _unlock(keep)
        shutil.copytree(keep, os.path.join(kept, "tree"), symlinks=True)
    if stdin is not None:
        with open(os.path.join(kept, "stdin"), "wb") as f:
            f.write(stdin)
    knobs = ["KREP_TPU_HOST_BREAKEVEN=0"] + (["KREP_TPU_DFA=1"] if dfa else []) + (
        [f"KREP_TPU_BACKEND={backend}"] if backend else [])
    lines = [f"MISMATCH batch={batch} seed={seed} case={case}",
             f"  args: {argv}",
             f"  kept: {kept} (the text as 'text', a tree as 'tree', stdin as 'stdin'; "
             "the args name the original paths)",
             f"  port: device={device} {' '.join(knobs)} KREP_TPU_REGEX_FILTER_MIN=0",
             f"  exit {got[2]} vs krep_tpu {want[2]}"]
    for name, a, b in (("stdout", got[0], want[0]), ("stderr", got[1], want[1])):
        if a != b:
            at = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]), min(len(a), len(b)))
            lines += [f"  {name} differs at byte {at} ({len(a)} vs {len(b)} bytes)",
                      f"    port:     {a[max(0, at - 80):at + 160]!r}",
                      f"    krep_tpu: {b[max(0, at - 80):at + 160]!r}"]
    return "\n".join(lines)


def _text_file(text: bytes) -> str:
    with tempfile.NamedTemporaryFile(suffix=".txt", delete=False) as f:
        f.write(text)
        return f.name


# ---- the batches (tools/soak_fuzz.py's, the C binary's side replaced) ----

_ARG_SHORTS = set("efmts")
_LONG_ALIASES = {  # canonical -> equivalent respellings (same parse)
    "-e": lambda v, r: (["-e" + v], ["--regexp", v], ["--regexp=" + v], ["--regex", v])[r % 4],
    "-m": lambda v, r: (["-m" + v], ["--max-count=" + v], ["--max", v], ["-m", v])[r % 4],
}


def respell_args(rng, args):
    """tools/soak_fuzz.py's respelling of an argv into an equivalent
    getopt_long spelling (attached short arguments, aliases, long-option
    prefixes, bundles), so the option parser is fuzz surface too."""
    out: list[str] = []
    bundle: list[str] = []

    def flush():
        if bundle:
            out.append("-" + "".join(bundle))
            bundle.clear()

    i, n = 0, len(args)
    while i < n:
        a = args[i]
        if not a.startswith("-") or a in ("-", "--"):
            break
        if a.startswith("--"):
            flush()
            name, eq, val = a[2:].partition("=")
            if rng.random() < 0.5 and len(name) > 1:
                name = name[: int(rng.integers(1, len(name)))]
            out.append(f"--{name}={val}" if eq else f"--{name}")
            i += 1
            continue
        ch = a[1:]
        if len(ch) == 1 and ch in _ARG_SHORTS and i + 1 < n:
            flush()
            val = args[i + 1]
            alias = _LONG_ALIASES.get(a)
            if alias is not None and val:
                out += alias(val, int(rng.integers(0, 4)))
            elif val and rng.random() < 0.5:
                out.append(a + val)
            else:
                out += [a, val]
            i += 2
            continue
        if len(ch) == 1:
            bundle.append(ch)
            if rng.random() < 0.5:
                flush()
            i += 1
            continue
        flush()
        out.append(a)
        i += 1
    flush()
    return out + args[i:]


def literal_batch(soak: Soak, seed: int, cases: int) -> None:
    rng = np.random.default_rng(seed)
    for case in range(cases):
        text, args = fo.gen_case(rng)
        if rng.random() < 0.2:
            args = ["--color=always", *args]
        if rng.random() < 0.3:
            args = respell_args(rng, args)
        backend = "pallas" if rng.random() < PALLAS_SHARE else None
        path = _text_file(text)
        try:
            soak.compare("literal", seed, case, [*args, path], text, norm=(path,),
                         backend=backend)
        finally:
            os.unlink(path)


def ere_batch(soak: Soak, seed: int, cases: int) -> None:
    rng = np.random.default_rng(seed)
    for case in range(cases):
        if rng.random() < 0.3:
            text, pats, flags, _ = fr._multi_case(rng)
            if rng.random() < 0.2:
                flags = ["--color=always", *flags]
            args = ["-E", *flags]
            for p in pats:
                args += ["-e", p.decode("latin1")]
        else:
            text = fr.gen_corpus(rng)
            pat = fr.gen_pattern(rng)
            flags = fr.gen_flags(rng)
            if rng.random() < 0.2:
                flags = ["--color=always", *flags]
            args = ["-E", *flags, "-e", pat.decode("latin1")]
        path = _text_file(text)
        try:
            soak.compare("ere", seed, case, [*args, path], text, norm=(path,))
        finally:
            os.unlink(path)


def _many_patterns(rng, text: bytes, k: int, lo: int, hi: int) -> list[bytes]:
    """k distinct members of lo..hi-1 bytes cut from text (no '\\n', no NUL)."""
    pats: list[bytes] = []
    while len(pats) < k:
        m = int(rng.integers(lo, hi))
        s = int(rng.integers(0, len(text) - m))
        p = text[s : s + m].replace(b"\n", b"x").replace(b"\x00", b"y")
        if p and p not in pats:
            pats.append(p)
    return pats


def manypat_batch(soak: Soak, seed: int, cases: int) -> None:
    """-f sets of 16..96 members of 1..21 bytes: the K-pattern scan, the
    Hamming kernel (K >= 32), the grouped and mixed routes, and under
    KREP_TPU_DFA=1 (a share of K > 64) the dense DFA."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"the quick brown fox_ jumps over\nlazy ", np.uint8)
    for case in range(cases):
        n = int(rng.integers(10_000, 150_000))
        text = rng.choice(alpha, size=n).tobytes()
        k = int(rng.integers(16, 97))
        pats = _many_patterns(rng, text, k, 1, 22)
        flags = []
        if rng.random() < 0.3:
            flags.append("-i")
        if rng.random() < 0.25:
            flags.append("-w")
        mode = rng.random()
        if mode < 0.35:
            flags.append("-c")
        elif mode < 0.55:
            flags += ["-c", "-o"]
        elif mode < 0.9:
            flags.append("-o")
        if rng.random() < 0.2:
            flags += ["-m", str(int(rng.integers(1, 9)))]
        dfa = k > 64 and rng.random() < DFA_SHARE
        path, pf = _text_file(text), _text_file(b"\n".join(pats))
        try:
            soak.compare("manypat", seed, case, [*flags, "-f", pf, path], text,
                         norm=(path, pf), dfa=dfa)
        finally:
            os.unlink(path)
            os.unlink(pf)


def string_stdin_batch(soak: Soak, seed: int, cases: int) -> None:
    """Piped stdin and -s string mode, randomised flags (--color=always)."""
    rng = np.random.default_rng(seed)
    word = frozenset(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
    for case in range(cases):
        if rng.random() < 0.5:
            text, args = fo.gen_case(rng)
            if rng.random() < 0.3:
                args = ["--color=always", *args]
            soak.compare("string_stdin", seed, case, args, text, stdin=text)
            continue
        text, _ = fo.gen_case(rng)
        text = text.replace(b"\x00", b"x")
        if len(text) > 3 and rng.random() < 0.7:
            m = int(rng.integers(1, min(12, len(text))))
            s = int(rng.integers(0, len(text) - m + 1))
            pat = text[s : s + m]
        else:
            pat = bytes(rng.choice(np.frombuffer(b"theoq\nx", np.uint8),
                                   size=int(rng.integers(1, 6))))
        pat = pat.replace(b"\x00", b"x") or b"a"
        flags = []
        if rng.random() < 0.3:
            flags.append("-i")
        if rng.random() < 0.3:
            flags.append("-w")
        if rng.random() < 0.3:
            flags.append("--color=always")
        mode = rng.random()
        if mode < 0.3:
            flags.append("-c")
        elif mode < 0.6:
            flags.append("-o")
        elif mode < 0.7:
            flags += ["-c", "-o"]
        if rng.random() < 0.25:
            flags += ["-m", str(int(rng.integers(0, 5)))]
        if "-w" in flags and any(c not in word for c in pat) and rng.random() < 0.5:
            flags += ["--algo", "bm"]
        args = [*flags, "-s", pat.decode("latin1"), text.decode("latin1")]
        soak.compare("string_stdin", seed, case, args, text)


def degenerate_batch(soak: Soak, seed: int, cases: int) -> None:
    """Degenerate pattern sets (empty members, duplicates, whole lines,
    1023-1025 bytes) through a file, stdin and -s."""
    rng = np.random.default_rng(seed)
    for case in range(cases):
        text, args, kind = fo.gen_degenerate_case(rng)
        if rng.random() < 0.3:
            args = respell_args(rng, args)
        if kind == "file":
            path = _text_file(text)
            try:
                soak.compare("degenerate", seed, case, [*args, path], text, norm=(path,))
            finally:
                os.unlink(path)
        else:
            soak.compare("degenerate", seed, case, args, text,
                         stdin=text if kind == "stdin" else None)


TREE_WORDS = [b"the cat", b"a dog", b"no match here", b"the end", b"THE X",
              b"thing", b"over the lazy dog", b"xyz", b""]
TREE_EXTS = [".txt", ".log", ".md", ".js", ".min.js", ".png", ".o", ".c", ".json", ""]
SKIP_DIRS = [".git", "node_modules", "build", ".svn"]
GITIGNORE_LINES = [b"*.log", b"drop/", b"!keep.log", b"secret*", b"sub/*.md"]


def _gen_tree(rng, root: str) -> None:
    """tools/soak_fuzz.py's random tree: nested and skip-listed directories,
    files across the extension table, a .gitignore, a symlink, empty files
    and now and then a binary/text pair over 1 MB."""
    dirs = [pathlib.Path(root)]
    for _ in range(int(rng.integers(0, 6))):
        base = dirs[int(rng.integers(0, len(dirs)))]
        name = (SKIP_DIRS[int(rng.integers(0, len(SKIP_DIRS)))]
                if rng.random() < 0.25 else f"d{int(rng.integers(0, 100))}")
        p = base / name
        p.mkdir(exist_ok=True)
        dirs.append(p)
    made = []
    for i in range(int(rng.integers(1, 12))):
        base = dirs[int(rng.integers(0, len(dirs)))]
        ext = TREE_EXTS[int(rng.integers(0, len(TREE_EXTS)))]
        name = f"{'.' if rng.random() < 0.15 else ''}f{i}{ext}"
        lines = [TREE_WORDS[int(rng.integers(0, len(TREE_WORDS)))]
                 for _ in range(int(rng.integers(0, 8)))]
        fp = base / name
        fp.write_bytes(b"\n".join(lines) + (b"\n" if lines else b""))
        made.append(fp)
    if rng.random() < 0.1:
        (dirs[0] / "big.bin").write_bytes(b"\x00the\x01" * 300_000)
        (dirs[0] / "big.txt").write_bytes(b"the quick\n" * 120_000)
    if made and rng.random() < 0.2:
        link = dirs[0] / "lnk.txt"
        if not link.exists():
            link.symlink_to(made[0])
    if rng.random() < 0.4:
        gi = rng.permutation(len(GITIGNORE_LINES))[: int(rng.integers(1, 4))]
        (dirs[0] / ".gitignore").write_bytes(
            b"\n".join(GITIGNORE_LINES[j] for j in gi) + b"\n")


def _recursive_flags(rng, gitignore: float, count: float, only: float) -> list[str]:
    flags = ["-r"]
    if rng.random() < gitignore:
        flags.append("--gitignore")
    if rng.random() < 0.3:
        flags.append("-i")
    if rng.random() < 0.2:
        flags.append("-w")
    mode = rng.random()
    if mode < count:
        flags.append("-c")
    elif mode < only:
        flags.append("-o")
    return flags


def tree_batch(soak: Soak, seed: int, cases: int) -> None:
    """-r over random trees: the walker, the batches, the solo files."""
    rng = np.random.default_rng(seed)
    for case in range(cases):
        root = tempfile.mkdtemp(prefix="soak_tree_")
        try:
            _gen_tree(rng, root)
            flags = _recursive_flags(rng, 0.4, 0.45, 0.8)
            if rng.random() < 0.2:
                flags += ["-m", str(int(rng.integers(1, 4)))]
            pat = ["the", "THE", "dog", "thing", "e", "q"][int(rng.integers(0, 6))]
            soak.compare("tree", seed, case, [*flags, pat, root], root)
        finally:
            shutil.rmtree(root, ignore_errors=True)


NEG_GITIGNORE_CHAINS = [
    b"*.txt\n!keep.txt\n",
    b"sub0/\n!sub0/\n*.log\n",
    b"a*.txt\n!a1.txt\nsub1/*.txt\n!sub1/a*.txt\n",
    b"*.log\n!important.log\ndeep/\n",
    b"f0*\n!f00*\n",
]


def _gen_pipeline_tree(rng, root: str) -> None:
    """tools/soak_fuzz.py's pipeline tree: tiny, batchable and solo (over
    BATCH_FILE_MAX) files, a dangling symlink, an unreadable directory
    (unless root), .gitignore negation chains."""
    base = pathlib.Path(root)
    subs = [base]
    for d in range(int(rng.integers(1, 4))):
        p = base / f"sub{d}"
        p.mkdir()
        subs.append(p)
    n_solo = 0
    for i in range(int(rng.integers(8, 28))):
        d = subs[int(rng.integers(0, len(subs)))]
        r = rng.random()
        if r < 0.25:
            body = (b"" if rng.random() < 0.5
                    else TREE_WORDS[int(rng.integers(0, len(TREE_WORDS)))] + b"\n")
        elif r < 0.88 or n_solo >= 2:
            k = int(rng.integers(1, 300))
            body = b"\n".join(TREE_WORDS[int(j)] for j in rng.integers(0, len(TREE_WORDS), k)) + b"\n"
        else:
            unit = b" ".join(TREE_WORDS[int(j)] for j in rng.integers(0, len(TREE_WORDS), 8)) + b"\n"
            body = unit * (tbatch.BATCH_FILE_MAX // len(unit) + 2)
            n_solo += 1
        name = f"{'a' if rng.random() < 0.3 else 'f'}{i:02d}" + (
            ".log" if rng.random() < 0.2 else ".txt")
        (d / name).write_bytes(body)
    if rng.random() < 0.5:
        (base / "dangling.txt").symlink_to(base / "missing_target.txt")
    if rng.random() < 0.4 and os.geteuid() != 0:
        locked = base / "locked"
        locked.mkdir()
        (locked / "hidden.txt").write_bytes(b"the cat\n")
        os.chmod(locked, 0)
    if rng.random() < 0.6:
        chain = NEG_GITIGNORE_CHAINS[int(rng.integers(0, len(NEG_GITIGNORE_CHAINS)))]
        (base / ".gitignore").write_bytes(chain)


def pipeline_batch(soak: Soak, seed: int, cases: int) -> None:
    """-r over trees that stress the port's batch pipeline, with batches of
    at most 64 KiB so several are in flight: whenever a walk submits three
    or more, the ordered emit queue must have had two in flight at once
    (instrumented on the port's io/batch.submit_batch and drain_batch)."""
    rng = np.random.default_rng(seed)
    real_max, real_submit, real_drain = (tbatch.BATCH_BUFFER_MAX, tbatch.submit_batch,
                                         tbatch.drain_batch)
    tbatch.BATCH_BUFFER_MAX = 64 << 10
    try:
        for case in range(cases):
            root = tempfile.mkdtemp(prefix="soak_pipe_")
            in_flight, stats = [0], {"max": 0, "submits": 0}

            def submit(params, b, device, _s=real_submit):
                in_flight[0] += 1
                stats["submits"] += 1
                stats["max"] = max(stats["max"], in_flight[0])
                return _s(params, b, device)

            def drain(params, pending, _d=real_drain):
                in_flight[0] -= 1
                yield from _d(params, pending)

            tbatch.submit_batch, tbatch.drain_batch = submit, drain
            try:
                _gen_pipeline_tree(rng, root)
                flags = _recursive_flags(rng, 0.5, 0.5, 0.8)
                if rng.random() < 0.15:
                    flags += ["-m", str(int(rng.integers(1, 5)))]
                pat = ["the", "cat", "THE", "e", "no match"][int(rng.integers(0, 5))]
                argv = [*flags, pat, root]
                soak.compare("pipeline", seed, case, argv, root)
                if stats["submits"] >= 3 and stats["max"] < 2:
                    raise Mismatch(f"MISMATCH batch=pipeline seed={seed} case={case}\n"
                                   f"  args: {argv}\n  pipeline depth {stats}: expected "
                                   "two batches in flight")
            finally:
                tbatch.submit_batch, tbatch.drain_batch = real_submit, real_drain
                _unlock(root)
                shutil.rmtree(root, ignore_errors=True)
    finally:
        tbatch.BATCH_BUFFER_MAX = real_max


LARGE_ARGS = [  # tests/test_fuzz_oracle.py test_fuzz_large_text_parity's sets
    ["-c", "the"],
    ["-c", "e"],
    ["-c", "-i", "-w", "fox"],
    ["-c", "-e", "the", "-e", "qu", "-e", "fox"],
    ["-o", "-m", "17", "quick"],
]


def large_batch(soak: Soak, seed: int, cases: int, lo: int = 4 << 20, hi: int = 12 << 20) -> None:
    """Texts of lo..hi bytes (4-12 MiB: 64 to 192 of the kernels' 64 KiB
    blocks, so the scan tail's second fold level and whole DFA waves run)
    over test_fuzz_large_text_parity's alphabet, with its argument sets
    and: -c -o -f with 16 and with 64 members cut from the text (1-8 and
    1-21 bytes), -c -f with 64 mixed members of 4-20 bytes, -m N -o, and
    -c -o with 80 members under KREP_TPU_DFA=1 (its counting mode: the
    modes that need positions wait seconds on the host's attribution)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"the quick brown fox\n_", np.uint8)
    for case in range(cases):
        n = int(rng.integers(lo, hi + 1))
        text = rng.choice(alpha, size=n).tobytes()
        path = _text_file(text)
        files = []

        def pats_file(pats):
            files.append(_text_file(b"\n".join(pats)))
            return files[-1]

        try:
            f16 = pats_file(_many_patterns(rng, text, 16, 1, 9))
            f64 = pats_file(_many_patterns(rng, text, 64, 1, 22))
            fmixed = pats_file(_many_patterns(rng, text, 64, 4, 21))
            f80 = pats_file(_many_patterns(rng, text, 80, 1, 13))
            m = int(rng.integers(1, 200_000))
            sets = [(a, False) for a in LARGE_ARGS] + [
                (["-c", "-o", "-f", f16], False), (["-c", "-o", "-f", f64], False),
                (["-c", "-f", fmixed], False), (["-o", "-m", str(m), "the"], False),
                (["-c", "-o", "-f", f80], True)]
            for i, (args, dfa) in enumerate(sets):
                soak.compare("large", seed, case * 100 + i, [*args, path], text,
                             norm=(path, *files), dfa=dfa)
        finally:
            for p in (path, *files):
                os.unlink(p)


def _unlock(root: str) -> None:
    for r, dirs, _fs in os.walk(root):
        for d in dirs:
            try:
                os.chmod(os.path.join(r, d), 0o755)
            except OSError:
                pass


# one round: soak_fuzz.py's seven batches in its proportions, then one large text
ROUND = [(literal_batch, 20), (ere_batch, 15), (tree_batch, 6), (manypat_batch, 3),
         (string_stdin_batch, 12), (degenerate_batch, 10), (pipeline_batch, 4),
         (large_batch, 1)]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=1800.0)
    ap.add_argument("--seed-base", type=int, default=None,
                    help="default: derived from the clock (printed for the repro)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    if a.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("soak: no CUDA device: torch.cuda.is_available() is False "
                  "(--device cpu runs the port's plain versions)", flush=True)
            return 2
    base = a.seed_base if a.seed_base is not None else int(time.time())
    print(f"soak: seed-base={base} budget={a.seconds:.0f}s device={a.device}", flush=True)
    t0 = last = time.time()
    rounds = 0
    with Soak(a.device) as soak:
        if _GUARD in sys.meta_path:
            soak.guard = _GUARD
        try:
            while time.time() - t0 < a.seconds:
                for j, (batch, cases) in enumerate(ROUND):
                    batch(soak, base + len(ROUND) * rounds + j, cases)
                rounds += 1
                if time.time() - last >= 60:
                    last = time.time()
                    print(f"  t+{last - t0:5.0f}s  {sum(soak.cases.values())} cases clean",
                          flush=True)
        except Mismatch as e:
            print(e, flush=True)
            return 1
        except ReferenceLeftNativeRoute as e:
            print(f"soak: the reference left its native host route (it needs jax): {e}",
                  flush=True)
            return 2
    for name, count in soak.cases.items():
        print(f"  {name}: {count} cases", flush=True)
    print(json.dumps({"cases": soak.cases, "rounds": rounds, "device": a.device,
                      "launches": launch_counts()}), flush=True)
    print(f"soak clean: {sum(soak.cases.values())} cases in {time.time() - t0:.0f}s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
