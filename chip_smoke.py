#!/usr/bin/env python3
"""Smoke test of krep_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; needs one CUDA card)

Phases, each printing what it found:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — the CUDA kernels from krep_tpu_torch/csrc, timed, with the
               ptxas registers, stack frame and spills of every instance
               and the instance counts of the two word scans;
  3. kernels — each kernel against its plain PyTorch version on the card,
               exactly, at 64 MiB: count, matched lines, start mask and the
               slab (shard) stats with a start limit and prev_word, with and
               without -i and -w, for pattern lengths 1, 3, 5, 9, 17 and 64
               (each length class of the word scan; its count and mask
               instances); in every phase 3, and in 5, each launch's totals
               (folded by its own last block, the scan tail) are held to
               lines.combine_block_stats of its rows, and the standalone
               combine_blocks (the Hamming line mode's rows, the variants')
               to the same;
  4. main path — the port's CLI on a 1 GiB config-1 corpus (bench.py's
               recipe, seed 12345): `-c the` (twice), `-c -i -w the` and
               `-m 5 -o the` (the slab route), and on its first 64 MiB
               `-o the` and the default line mode. Every stdout and exit
               code must equal `python -m krep_tpu.cli` on the native host
               route (KREP_TPU_HOST_BREAKEVEN=4294967296, no jax and no
               kernel), and every kernel must have launched, the scan
               tail folding the totals (swar.TAIL_FOLDS > 0) with no
               combine_blocks launch (also in 4+, 4r's -r -c -e, 4v and
               4m). Before the runs, the 1 GiB bucket's pinned host buffer
               is timed cold and warm;
  5. shapes  — both kernels against their plain versions, exactly, at the
               shapes the main path gives them: 1 GiB `-c the` (no mask,
               16,384 blocks), 1 GiB shard stats with -i -w, start_limit and
               prev_word, and the slab loop's 64 MiB (1,536 blocks) and
               1 GiB (24,576 blocks) slabs; then each kernel timed against
               its plain version at the 1 GiB `-c the` shape, with CUDA
               events; then the K=1 scan's count, -i -w count, start-mask
               and shard instances for m = 1, 3, 5, 17 and 64 on the 1 GiB
               corpus and on 1 GiB of a-z text, each exact against plain and
               timed beside its bound and its plain time, and the shard
               instance at the 1 GiB slab (24,576 blocks); the scan tail
               (the count instance with its tail minus without it) and the
               standalone combine_blocks at 16,384 and 24,576 rows, each
               beside its bound and the plain fold.
The multi-pattern slice (-e/-f) adds, with bench.py's pattern sets rebuilt
here (PATTERNS_16, config 3; its 64 eight-byte variants, config 3b; 64
mixed 4-20 byte members, config 3c):
  3+. kernels — the K-pattern scan (K = 2, 16, 64, the 64 members of one
               4-byte prefix and a set that collides in its filter map;
               each in its count and mask instances), the
               Hamming kernel (the 64-variant and mixed sets) and the lines
               kernel (on both routes' union masks, with and without a
               '\n'-leading member) against their plain versions, exactly,
               at 64 MiB, with and without -i and -w;
  4+. main path — the port's CLI with several patterns: on 1 GiB, `-c -o`
               and `-c` with the 16 literals, `-c -o` with the 64 variants,
               `-c -o`, `-w -c -o` and `-c` with the mixed set, each held to
               identities over the single-pattern kernel (the -c -o total
               is the sum of the per-pattern counts; a -c count is the
               matched lines of the OR of the per-pattern masks); on
               64 MiB `-o` with three literals, on 16 MiB `-o` with the 64
               variants, `-m 1000 -c -o` with 100 patterns (the K > 64
               route) and `-c` with a member over 64 bytes (the slab
               route), each byte-identical to the native host route. Every
               new kernel must have launched;
  5+. shapes  — each new kernel against its plain version, exactly, and
               timed with CUDA events at 1 GiB: the K-pattern scan at K=16
               and K=64, the Hamming kernel on both sets (each beside its
               bound and torch._int_mm), the lines kernel on a 1 GiB union
               mask (beside its bound); the K-pattern scan's count and mask
               instances at K = 2,
               16 and 64 on the corpus and on 1 GiB of a-z text, each beside
               its bound; then the K-pattern scan against the Hamming kernel
               on bench.py's sets at K = 16, 32, 48 and 64 (count only, equal
               counts), the crossover that MXU_MIN_K stands for.
The recursive slice (-r) adds:
  3r. kernels — the scan kernel's first_line mode (one launch: its tail
               finishes the mask across blocks) against its plain version,
               and the fix-up step alone (the launch without it, finished by
               lines.first_line_fixup) against the launch with it, exactly,
               at 64 MiB, with and without -i and -w, for pattern lengths
               1, 3, 5, 17 and 64, on text whose lines cross the thread
               spans and block edges, span three blocks and more, and leave
               blocks without a newline;
  4r. main path — a source tree on the config-5 recipe (bench.py:640-666)
               scaled to 20,000 files in 400 directories plus 8 files of
               2-8 MiB (the solo route), about 0.50 GB, made with numpy from
               seed 7, its directories in groups of 50 under part0/ ..
               part7/: `-r --gitignore -c the`, `-r --gitignore -c -o the`
               and `-r -i -w -c THE` on the whole tree, `-r -o the`,
               `-r the` and `-r -c -e the -e fox` on part0 (2,501 files),
               and the config-5 tree itself with the break-even unset (the
               host route) and at 0 (the device route), each byte-identical
               to the native host route; during `-r -c` every batch must be
               one first_line launch (no fix-up launch). Each warm run
               prints its wall time, batches, files/s and the host seconds
               spent in staging, submit_batch and drain_batch; part0 is also
               walked and read alone, with no scan;
  5r. shapes  — the first_line scan and its fix-up step against their
               plain versions, exactly, and timed with CUDA events at the
               batch shapes: the walker's full batch (past 64 MiB: the
               1,536-block bucket, the main path's shape), the largest batch
               within 64 MiB (1,024 blocks) and 1,000 blocks (a last group
               of 40); the step's time is the launch with it minus the
               launch without it.
The sharded slice (parallel/mesh.py, -t) adds:
  3m. kernels — the shard modes against their plain versions, exactly, at
               64 MiB, on text with a match across the start limit and one
               at byte 0: the K-pattern scan with start_limit and prev_word
               (K = 2, 16, 64; with and without -i and -w; prev_word 0 and
               1; its count and mask instances) and the Hamming kernel with start_limit and prev_flag (the
               64-variant and mixed sets, with and without -w);
  4m. main path — search_string and the CLI on a machine that names this
               card 4 times (mesh.devices patched to (cuda:0,) * 4), so the
               engine's own rule routes to the sharded route: on the 1 GiB
               corpus `-c the`, `-c -i -w the`, `-c -o` and `-c` with the 16
               literals, `-c -o` with the 64 variants (the Hamming kernel per
               shard), `-c -o` with a 70-byte pattern across a shard edge (the
               sharded prefix filter), and on its first 64 MiB `-o the`, each
               equal to the single-device route (-t 1); the CLI's `-c the`
               and `-o the` byte-identical to the native host route and `-c`
               with the 16 literals to the single-device CLI; then, on a
               machine of 8 such devices, `-t 3`, `-t 4` and `-t 8` on a
               64 MiB text with "athe" planted across every shard edge,
               byte-identical to the native host route. Every run must have
               staged the mesh its -t asks for, and the shard modes must have
               launched; mesh.dryrun(4). With more than one card, the real
               mesh and the CLI too (`-c the`, `-o the`, `-c -f pats16`,
               byte-identical to the native host route);
  5m. shapes  — both shard modes at the main path's shard shape (a 256 MiB
               shard of the 1 GiB corpus: 4,096 blocks + the halo) against
               their plain versions, exactly, then timed with CUDA events
               beside their bounds, the Hamming mode beside torch._int_mm.
The last three TPU kernels (the byte scan of KREP_TPU_BACKEND=pallas, its
cost-attribution variants, the Hamming kernel's want_lines and strict) add:
  3v. kernels — the byte scan against its plain version, exactly, at 64 MiB
               of text with long lines: count, lines and mask, with and
               without -i and -w, for pattern lengths 1, 3, 5, 9, 17, 64, 65,
               1000 and 4096, the long ones planted across block edges,
               after "_^" and at the end; then the four variants;
  3h. kernels — the Hamming kernel's line mode (the 64 variants, the mixed
               set, -w, -i, a '\\n'-leading set) and strict mode (with_len
               views n - 0, 1, 17, 4095 of a buffer with live text past
               them, with and without -w) against their plain versions,
               exactly, at 64 MiB;
  4v. main path — the CLI under KREP_TPU_BACKEND=pallas: `-c the` and
               `-c -i -w the` on 1 GiB, `-o the`, line mode and `-c -o` with
               a 70-byte pattern on 64 MiB, `-r -o the` and `-r -c -o the`
               on part0, each byte-identical to the native host route; the
               byte scan (with and without a mask) must have launched;
  4b. main path — `python -m krep_tpu_torch.tools.bench_kernel` as a user
               runs it (256 MiB): each variant equal to its plain version,
               its rows folded by combine_blocks;
  4h. main path — the CLI under KREP_TPU_MXU_LINES=inkernel: `-c -f` with
               the 64 variants and `-c` / `-w -c` with the mixed set on
               1 GiB, each equal to the default route's output, and `-c -f`
               with the 64 variants on 16 MiB byte-identical to the native
               host route; the line mode and combine_blocks (its rows'
               fold) must have launched and the lines kernel not;
  4s. main path — bench.py's strict counts (fused_count_device(strict=True)
               on the 1 GiB staging and its with_len views), each equal to
               the -c -o count of phase 4+ adjusted at the new end;
  5v/5h. shapes — at 1 GiB, the byte scan (with and without a mask), the
               variants and both Hamming modes exact against plain, then
               timed beside their bounds, the chained pair (mask instance +
               lines_blocks), the count instance, torch.sum and
               torch._int_mm; the byte scan's count and mask also for
               m = 65, 1000 and 4096 (patterns cut from the corpus).
The regex and dense-DFA slice (-E, KREP_TPU_DFA=1) adds:
  3d. kernels — the dense-DFA kernel (csrc/dfa_scan.cu) against its plain
               version (ac.dfa_walk_plain on the card), exactly, at 64 MiB:
               each table kind (shared 16-bit, global 32-bit, wide with
               emit[]) in its count and mask instances, with and without -i,
               on bench.py's 100-pattern set (every kind), on 1,024 patterns
               whose automaton comes near the 65,536-state cap (a 64 MiB
               table; global and wide) and on 65,600 copies of "the" beside
               the 100 (a count past 65,535: wide);
  4d. main path — the CLI under KREP_TPU_DFA=1 with `-f pats100` on 16 MiB:
               `-c -o`, `-c`, `-m 1000 -o` and `-w -c -o`, each
               byte-identical to the native host route; both instances must
               have launched, on the shared table;
  4e. main path — -E on 1 GiB of bench.py's config-4 corpus (its recipe,
               seed 4242): `-c`, `-o` and `-i -c` with '[A-Z][a-z]+ing' (one
               factor: the K=1 word scan) and '[Mm]orning|[Nn]othing' (two:
               the K-pattern scan); `-c -E 'th[a-z]+'` on the config-1
               corpus (dense candidates: the prefilter declines and the fork
               pool answers, after the CUDA context exists, under
               KREP_TPU_STRICT=1); `-r -c -E` and `-r -o -E` on part0. Each
               byte-identical to krep_tpu.cli with its prefilter off
               (KREP_TPU_REGEX_FILTER_MIN above the size: glibc alone, no
               jax); the prefilter's kernels must have launched, and the
               host-only route (the port with its prefilter off) is timed;
  5d. shapes  — the dense-DFA kernel exact against plain at 1 GiB (every
               kind of the three sets, -i), then every instance timed beside
               its bound and plain time at 16 MiB, 64 MiB and 1 GiB, and the
               count by span (16 B to 4 KiB) at 16 MiB and 1 GiB.
The resident engine (daemon.py, native/client.c, hostscan.calibrate) adds,
after 5d:
  4c. main path — hostscan.calibrate(force=True) on the card in a fresh
               cache directory that also holds the JAX package's
               breakeven.json (the record printed; threshold() returns it,
               route_small(t) and not route_small(t + 1), the JAX record
               unread); the client built by build_client(); the daemon
               started through its double fork; through the client (no
               autospawn, KREP_TPU_PYTHON=/bin/false, so a missed daemon
               fails) `-c the` and `-o -m 1000 the` on 1 GiB, `-c -f` with
               the 16 literals on 16 MiB, `-r --gitignore -c the` on the
               config-5 tree, `-c -E '[A-Z][a-z]+ing'` on 64 MiB of the
               config-4 corpus (the prefilter's kernels), `-c -E 'th[a-z]+'`
               on 64 MiB (a declined prefilter: the fork pool, forked after
               the CUDA context) and `-c the` on 64 MiB with the break-even
               at 0 and at 4 GiB, each byte-identical to the port in process
               and to the native host route; the same `-c the` served by
               daemon.serve in a thread of this process launching the scan
               as the CLI does; the one-shot CLI's and the client's times
               (4 KiB and 1 GiB); `--stop` ending the daemon and removing
               its socket.
It then prints one JSON line of kernels and, last, the result line. It
exits non-zero, with no result line, when any phase fails; when no card is
available or the package is missing (a copy of the script run outside the
repository, from a working directory that is not its root), its last line
is {"ok": false, "error": ...} naming the cause. Imports nothing of jax.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# the repository: the script's own directory, or (for a copy of the script
# run elsewhere) the working directory
ROOT = HERE if os.path.isdir(os.path.join(HERE, "krep_tpu_torch")) else os.getcwd()
MIB64 = 64 << 20
MIB16 = 16 << 20
GIB = 1 << 30
WORDS = (
    b"the quick brown fox jumps over a lazy dog and then some more words "
    b"it was time for Sherlock to breathe deeply in the theatre"
).split()
REFERENCE_ENV = {"KREP_TPU_HOST_BREAKEVEN": str(1 << 32)}
PATTERNS_16 = [  # bench.py:32-35 (BASELINE config 3)
    b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy", b"dog",
    b"Sherlock", b"time", b"words", b"some", b"then", b"deeply", b"was", b"more",
]


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


def in_background(fn):
    """Starts fn() in a thread (the build's nvcc processes, the writing of
    data the later phases read) and returns a function that waits for it
    and returns (its result, its seconds), raising what it raised."""
    out = {}

    def run() -> None:
        t = time.perf_counter()
        try:
            out["value"] = fn()
        except Exception as e:  # noqa: BLE001 - raised again by wait()
            out["error"] = e
        out["s"] = time.perf_counter() - t

    thread = threading.Thread(target=run)
    thread.start()

    def wait():
        thread.join()
        if "error" in out:
            raise out["error"]
        return out["value"], out["s"]

    return wait


START = time.perf_counter()


def phase(name: str) -> None:
    """A phase's first line: the seconds since the script started."""
    say(f"-- phase {name} at {time.perf_counter() - START:.1f} s")


def token_table(tokens: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """The tokens as a zero-padded (V, L) uint8 table and its (V, L) mask
    of real bytes: table[idx][real[idx]] is the concatenation of the
    tokens idx, with no int64 index per output byte."""
    width = max(map(len, tokens))
    table = np.zeros((len(tokens), width), np.uint8)
    real = np.zeros((len(tokens), width), bool)
    for i, t in enumerate(tokens):
        table[i, : len(t)] = np.frombuffer(t, np.uint8)
        real[i, : len(t)] = True
    return table, real


def gen_corpus(path: str, size: int, seed: int = 12345) -> None:
    """bench.py's config-1 corpus recipe (lines of 3-8 words from its
    vocabulary, joined by spaces), vectorised over a million lines at a
    time."""
    rng = np.random.default_rng(seed)
    tokens = [w + b" " for w in WORDS]
    lens = np.array([len(t) for t in tokens], dtype=np.int64)
    table, real = token_table(tokens)
    written = 0
    with open(path, "wb") as f:
        while written < size:
            k = rng.integers(3, 9, 1 << 20)
            idx = rng.integers(0, len(WORDS), int(k.sum()))
            ends = np.cumsum(lens[idx])
            total = int(ends[-1])
            chunk = table[idx][real[idx]]
            chunk[ends[np.cumsum(k) - 1] - 1] = 10  # a line's last space -> '\n'
            take = min(total, size - written)
            f.write(chunk[:take].tobytes())
            written += take


ING_WORDS = [b"jumping", b"singing", b"working", b"morning", b"nothing",  # bench.py:516
             b"Running", b"Marking"]


def gen_corpus_ing(path: str, size: int, seed: int = 4242) -> None:
    """bench.py's config-4 corpus recipe (gen_corpus_ing, bench.py:520-549):
    config 1's lines, and in about 3% of them one word replaced by an 'ing'
    word; vectorised over a million lines at a time."""
    rng = np.random.default_rng(seed)
    tokens = [w + b" " for w in WORDS + ING_WORDS]
    lens = np.array([len(t) for t in tokens], dtype=np.int64)
    table, real = token_table(tokens)
    written = 0
    with open(path, "wb") as f:
        while written < size:
            k = rng.integers(3, 9, 1 << 20)
            idx = rng.integers(0, len(WORDS), int(k.sum()))
            first = np.cumsum(k) - k
            hit = rng.random(k.shape[0]) < 0.03
            at = first[hit] + (rng.random(int(hit.sum())) * k[hit]).astype(np.int64)
            idx[at] = len(WORDS) + rng.integers(0, len(ING_WORDS), int(hit.sum()))
            ends = np.cumsum(lens[idx])
            total = int(ends[-1])
            chunk = table[idx][real[idx]]
            chunk[ends[np.cumsum(k) - 1] - 1] = 10  # a line's last space -> '\n'
            take = min(total, size - written)
            f.write(chunk[:take].tobytes())
            written += take


def near_cap_set(text: np.ndarray, seed: int = 5) -> tuple[bytes, ...]:
    """1,024 lower-case patterns whose automaton comes near the dense
    table's cap of 65,536 states (a 64 MiB table): 1,000 random 64-byte
    strings of a-z and 24 pieces of 8-64 bytes cut from `text` (they
    match)."""
    rng = np.random.default_rng(seed)
    pats = [bytes(rng.integers(97, 123, 64, dtype=np.uint8)) for _ in range(1000)]
    for at in rng.integers(0, len(text) - 64, 24):
        pats.append(bytes(text[at : at + int(rng.integers(8, 65))]).lower())
    return tuple(pats)


def harden(text: np.ndarray, seed: int = 7) -> np.ndarray:
    """A copy with some upper case, digits, '_', '^', bytes next to the
    letter ranges and bytes above 0x7F mixed in, so -i and -w meet every
    byte class."""
    rng = np.random.default_rng(seed)
    out = text.copy()
    r = rng.random(out.shape[0], dtype=np.float32)
    lower = (out >= 0x61) & (out <= 0x7A)
    out[lower & (r < 0.15)] -= 32
    odd = np.frombuffer(b"_^9Z@[`{\xc1\xe1", np.uint8)
    out[r > 0.998] = odd[rng.integers(0, len(odd), int((r > 0.998).sum()))]
    return out


TREE_WORDS = b"the quick brown fox def class import return self value".split()  # bench.py:650


def tree_lines(rng, nbytes: int) -> np.ndarray:
    """At least nbytes of the config-5 recipe's lines (bench.py:652-661):
    six words drawn from TREE_WORDS, joined by spaces, each line ended by a
    newline; vectorised over a million lines at a time."""
    tokens = [w + b" " for w in TREE_WORDS]
    lens = np.array([len(t) for t in tokens], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    pool = np.frombuffer(b"".join(tokens), np.uint8)
    parts, total = [], 0
    while total < nbytes:
        idx = rng.integers(0, len(TREE_WORDS), 6 << 20)
        wl = lens[idx]
        ends = np.cumsum(wl)
        n = int(ends[-1])
        wid = np.repeat(np.arange(len(idx)), wl)
        chunk = pool[offs[idx][wid] + np.arange(n) - (ends - wl)[wid]]
        chunk[ends[5::6] - 1] = 10  # each line's last space -> '\n'
        parts.append(chunk)
        total += n
    return np.concatenate(parts)


def gen_tree(root: str, n_dirs: int, per_dir: int, n_big: int, part_dirs: int = 50,
             seed: int = 7) -> dict:
    """A source tree on the config-5 recipe (bench.py:640-666) at scale:
    n_dirs directories of per_dir files of 5,000-40,000 bytes (whole lines,
    joined by newlines, no newline at the end), `.gitignore` excluding the
    last directory, and n_big files of 2-8 MiB (over the batch's 1 MiB file
    limit: the solo route) spread over the walk. The directories sit in
    groups of part_dirs under part0/, part1/, ..., so part0 is a subtree of
    its own (with one of the big files). Returns counts and bytes, of the
    tree and of part0."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(5_000, 40_000, n_dirs * per_dir)
    big = rng.integers(2 << 20, 8 << 20, n_big)
    text = tree_lines(rng, int(sizes.sum() + big.sum()) + 64 * (len(sizes) + n_big) + 100_000)
    nl = np.flatnonzero(text == 10)
    pos = 0

    def take(k: int) -> np.ndarray:
        nonlocal pos
        cut = int(nl[np.searchsorted(nl, pos + k - 1)])  # the recipe's last line reaches k
        out, pos = text[pos:cut], cut + 1
        return out

    big_at = {int(d): j for j, d in enumerate(np.linspace(0, n_dirs - 1, n_big + 2)[1:-1])}
    total = files = part0_bytes = part0_files = 0
    for d in range(n_dirs):
        sub = os.path.join(root, f"part{d // part_dirs}", f"pkg{d:03d}")
        os.makedirs(sub)
        chunks = [(f"m{i:03d}.py", take(int(sizes[d * per_dir + i]))) for i in range(per_dir)]
        if d in big_at:
            chunks.append((f"big{big_at[d]}.txt", take(int(big[big_at[d]]))))
        for name, data in chunks:
            with open(os.path.join(sub, name), "wb") as f:
                f.write(data)
            total += data.shape[0]
            if d < part_dirs:
                part0_bytes += data.shape[0]
        files += len(chunks)
        if d < part_dirs:
            part0_files += len(chunks)
    with open(os.path.join(root, ".gitignore"), "w") as f:
        f.write(f"pkg{n_dirs - 1:03d}/\n")
    return {"files": files, "bytes": total, "part0_files": part0_files, "part0_bytes": part0_bytes}


def gen_config5_tree(root: str) -> None:
    """bench.py:640-666 itself: 20 directories of 50 files, seed 7, with the
    recipe's per-line loop (about 22 MB)."""
    rng = np.random.default_rng(7)
    for d in range(20):
        sub = os.path.join(root, f"pkg{d:02d}")
        os.makedirs(sub, exist_ok=True)
        for i in range(50):
            k = rng.integers(5_000, 40_000)
            lines = []
            t = 0
            while t < k:
                ln = b" ".join(TREE_WORDS[j] for j in rng.integers(0, len(TREE_WORDS), 6))
                lines.append(ln)
                t += len(ln) + 1
            with open(os.path.join(sub, f"m{i:03d}.py"), "wb") as f:
                f.write(b"\n".join(lines))
    with open(os.path.join(root, ".gitignore"), "w") as f:
        f.write("pkg19/\n")


def long_lines(text: np.ndarray, seed: int = 11) -> np.ndarray:
    """A copy of `text` with the newlines of some stretches blanked: lines of
    hundreds of bytes to hundreds of KiB, so lines cross the kernels'
    256-byte thread spans and 64 KiB block edges with matches on both
    sides, some span three or more blocks, and some blocks hold no
    newline."""
    rng = np.random.default_rng(seed)
    out = text.copy()
    n = out.shape[0]
    for lo, hi, k in ((300, 1_500, 4000), (5_000, 40_000, 400), (200_000, 400_000, 40)):
        for start, length in zip(rng.integers(0, n - hi, k), rng.integers(lo, hi, k)):
            seg = out[start : start + length]
            seg[seg == 10] = 32
    return out


def bound(nbytes: float, ops: float = 0.0, peak_ops: float = 1.0) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes moved over 3.35 TB/s
    (H100 SXM HBM3) or operations over their peak rate, whichever is larger."""
    t_bytes, t_ops = nbytes / 3.35e12, ops / peak_ops
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


INT8_PEAK = 1979e12  # H100 SXM dense int8 tensor-core operations per second


def int_mm_ms(st, g: torch.Tensor, chunk_words: int = 1 << 22,
              g2: torch.Tensor | None = None) -> float | None:
    """Summed CUDA-event time of torch._int_mm(G, W) over a staged text:
    the Hamming kernel's own int8 G (4Kp, 128) against the window bits W
    (128, words) of every 4-byte word, and with `g2` (a two-window set's
    G2, (4 kp_l, rows2)) also G2 against the bits of window bytes 16.., in
    chunks (the whole product does not fit the card's memory). Only the
    _int_mm calls are timed. None, with the error printed, if this torch's
    _int_mm takes neither layout of W."""
    from krep_tpu_torch.ops import mxu

    words_total = st.n_blocks * 65536 // 4
    total = 0.0
    column_major = True
    for w0 in range(0, words_total, chunk_words):
        words = torch.arange(w0, min(words_total, w0 + chunk_words), device=st.u8.device)
        pairs = [(g, 0, 16)] + ([] if g2 is None else [(g2, 16, g2.shape[1] // 8)])
        for gm, j0, nj in pairs:
            w = mxu._window_bits(st.u8, words, j0, nj).to(torch.int8)  # (8 nj, nw)
            if column_major:
                w = w.t().contiguous().t()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            for attempt in (0, 1):
                try:
                    t0.record()
                    torch._int_mm(gm, w)
                    t1.record()
                    break
                except RuntimeError as e:
                    if attempt or w0 or j0 or not column_major:
                        say(f"library yardstick: torch._int_mm refused the operands: {e}")
                        return None
                    column_major = False
                    w = w.contiguous()
            torch.cuda.synchronize()
            total += t0.elapsed_time(t1)
            del w
    return total


def ptxas_lines(log: str) -> list[str]:
    """One line per compiled kernel instance of an `nvcc -Xptxas -v` log:
    its mangled name cut to the kernel and template arguments (the Hamming
    kernel's as KS1, two windows, mode, G in shared memory; the K-pattern
    scan's as -i fold, -w, mask, shard; the word scans' as pattern-length
    class, -w, mask kind and, for the byte scan, lines), its registers,
    stack frame and spills."""
    import re

    out, name, frame = [], None, ""
    lens, masks = ("m<=4", "m<=8", "m>8"), ("none", "starts", "first_line")
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            h = re.search(r"hamming_scan_kernelILi(\d)ELb(\d)ELi(\d)ELb(\d)", name)
            k = re.search(r"scan_blocks_multi_kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)E", name)
            d = re.search(r"dfa_scan_kernelILi(\d)ELb(\d)E", name)
            w = re.search(r"(scan_blocks|byte_scan)_kernelILi(\d)ELb(\d)ELi(\d)E(?:Lb(\d)E)?", name)
            if w:
                kern, cls, word, mask, lin = w.groups()
                name = (f"{kern}_kernel<{lens[int(cls)]}, word={word}, mask={masks[int(mask)]}"
                        + (f", lines={lin}>" if lin is not None else ">"))
            elif h:
                ks, two, mode, gs = h.groups()
                name = (f"hamming_scan_kernel<KS1={ks}, two={two}, "
                        f"{('count', 'lines', 'strict')[int(mode)]}, G in smem={gs}>")
            elif k:
                name = "scan_blocks_multi_kernel<fold={}, word={}, mask={}, shard={}>".format(
                    *k.groups())
            elif d:
                name = "dfa_scan_kernel<{}, mask={}>".format(
                    ("shared", "global", "wide")[int(d.group(1))], d.group(2))
            else:
                k = re.search(r"\d+([a-z_]+kernel)(I\w+?EE)?", name)
                name = k.group(1) + (k.group(2) or "") if k else name[:80]
        elif "stack frame" in line:
            frame = line.strip()
        elif "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {frame}")
            name, frame = None, ""
    return out


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def reference_cli(args: list[str], env_extra: dict | None = None) -> tuple[bytes, int, float]:
    env = dict(os.environ, **REFERENCE_ENV, **(env_extra or {}))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "krep_tpu.cli", *args], cwd=ROOT, env=env,
        capture_output=True, timeout=600,
    )
    return proc.stdout, proc.returncode, time.perf_counter() - t0


def reference_clis(arg_lists: list[list[str]], jobs: int = 4,
                   env_extra: dict | None = None) -> list[tuple[bytes, int, float]]:
    """reference_cli over several argument lists, `jobs` processes at a time
    (their times overlap, so each is an upper bound of its own)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=jobs) as pool:
        return list(pool.map(lambda args: reference_cli(args, env_extra), arg_lists))


def reset_launches() -> None:
    from krep_tpu_torch.ops import ac, bytescan, mxu, swar

    ac.LAUNCHES = ac.MASK_LAUNCHES = 0
    ac.KIND_LAUNCHES.update(dict.fromkeys(ac.TABLE_KINDS, 0))

    swar.LAUNCHES = swar.COMBINE_LAUNCHES = swar.MULTI_LAUNCHES = swar.LINES_LAUNCHES = 0
    swar.FIRST_LINE_LAUNCHES = swar.MULTI_SHARD_LAUNCHES = 0
    swar.MASK_LAUNCHES = swar.SHARD_LAUNCHES = swar.TAIL_FOLDS = 0
    mxu.LAUNCHES = mxu.SHARD_LAUNCHES = mxu.LINES_LAUNCHES = mxu.STRICT_LAUNCHES = 0
    bytescan.LAUNCHES = bytescan.MASK_LAUNCHES = 0
    bytescan.VARIANT_LAUNCHES.update(dict.fromkeys(bytescan.VARIANTS, 0))


TAIL = "combine (scan tail)"  # the launches that folded their own totals (swar.TAIL_FOLDS)


def note_tail(max_err: dict, stats: torch.Tensor, totals: torch.Tensor) -> None:
    """Folds the scan tail's difference from its plain version (the
    totals of a launch against lines.combine_block_stats of its rows) into
    max_err[TAIL]."""
    from krep_tpu_torch.parallel import lines

    err = int((totals - lines.combine_block_stats(stats)).abs().max())
    max_err[TAIL] = max(max_err.get(TAIL, 0), err)


def note_combine(max_err: dict, stats: torch.Tensor) -> torch.Tensor:
    """The standalone combine_blocks on `stats` against its plain version,
    into max_err["combine_blocks"]; returns its totals."""
    from krep_tpu_torch.ops import swar
    from krep_tpu_torch.parallel import lines

    tot = swar.combine_blocks(stats)
    err = int((tot - lines.combine_block_stats(stats)).abs().max())
    max_err["combine_blocks"] = max(max_err.get("combine_blocks", 0), err)
    return tot


def read_launches(*names: str) -> dict:
    """Launch counts of the named kernels (all of them by default)."""
    from krep_tpu_torch.ops import ac, bytescan, mxu, swar

    counts = {"scan_blocks": swar.LAUNCHES, "combine_blocks": swar.COMBINE_LAUNCHES,
              TAIL: swar.TAIL_FOLDS,
              "scan_blocks mask": swar.MASK_LAUNCHES, "scan_blocks shard": swar.SHARD_LAUNCHES,
              "scan_blocks first_line": swar.FIRST_LINE_LAUNCHES,
              # each first_line launch finishes its mask in its tail
              "first_line_fixup": swar.FIRST_LINE_LAUNCHES,
              "scan_blocks_multi": swar.MULTI_LAUNCHES, "lines_blocks": swar.LINES_LAUNCHES,
              "hamming_scan": mxu.LAUNCHES,
              "scan_blocks_multi shard": swar.MULTI_SHARD_LAUNCHES,
              "hamming_scan shard": mxu.SHARD_LAUNCHES,
              "scan_bytes": bytescan.LAUNCHES, "scan_bytes mask": bytescan.MASK_LAUNCHES,
              **{f"bench_kernel {v}": n for v, n in bytescan.VARIANT_LAUNCHES.items()},
              "hamming_scan lines": mxu.LINES_LAUNCHES,
              "hamming_scan strict": mxu.STRICT_LAUNCHES,
              "dfa_scan": ac.LAUNCHES - ac.MASK_LAUNCHES, "dfa_scan mask": ac.MASK_LAUNCHES,
              **{f"dfa_scan {k}": n for k, n in ac.KIND_LAUNCHES.items()}}
    return {k: counts[k] for k in names or counts}


@contextlib.contextmanager
def env_set(name: str, value: str | None):
    """$name = value (unset for None) inside the block, restored after it."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def plant(text: np.ndarray, at: int, piece: bytes) -> None:
    """`piece` written into `text` at `at`, cut at the text's end."""
    piece = piece[: len(text) - at]
    text[at : at + len(piece)] = np.frombuffer(piece, np.uint8)


def tail_adjusted_count(text: np.ndarray, n: int, j: int, patterns, whole_word: bool) -> int:
    """How the ALL count of `patterns` over text[:n] changes when the text
    ends at n - j instead: the starts near the end counted over text[:n - j]
    minus those counted over text[:n], in the last 4,200 bytes before n - j
    (each region read from one byte earlier, for the -w before-byte)."""
    a = n - j - 4200

    def near_end(end):
        region = bytes(text[a - 1 : end])
        return sum(sum(1 for s in naive_starts(region, p, whole_word) if s >= 1)
                   for p in patterns)

    return near_end(n - j) - near_end(n)


def naive_starts(text: bytes, pattern: bytes, whole_word: bool) -> list[int]:
    """Every start of `pattern` in `text` (with -w, word-bounded, the text's
    edges counting as boundaries), by bytes.find."""
    out, i, m = [], text.find(pattern), len(pattern)

    def word(c):
        return c == 95 or 48 <= c <= 57 or 65 <= c <= 90 or 97 <= c <= 122

    while i >= 0:
        if not whole_word or ((i == 0 or not word(text[i - 1]))
                              and (i + m >= len(text) or not word(text[i + m]))):
            out.append(i)
        i = text.find(pattern, i + 1)
    return out


def multi_kernels_vs_plain(st, max_err, say_prefix: str, *, patterns, case_sensitive,
                           whole_word, route: str):
    """One multi-pattern kernel ("fused": scan_blocks_multi, its mask and
    count instances; "hamming": hamming_scan) and the lines kernel on its
    union mask against their plain versions; folds the differences into
    max_err (the fused route's and the lines kernel's totals under TAIL),
    returns the kernel's (per-block counts, mask)."""
    from krep_tpu_torch.ops import literal, mxu, swar

    kw = dict(case_sensitive=case_sensitive, whole_word=whole_word, want_mask=True)
    if route == "fused":
        stats, mask, totals = swar.scan_blocks_multi(st.u8, st.true_len, st.n_blocks,
                                                     patterns=patterns, **kw)
        pstats, pmask = literal.block_stats_multi(
            st.u8, st.true_len, st.n_blocks, patterns=patterns, **kw)
        name, counts = "scan_blocks_multi", stats[:, 0]
        kw["want_mask"] = False  # the count instance of the same set
        cstats, _, ctotals = swar.scan_blocks_multi(st.u8, st.true_len, st.n_blocks,
                                                    patterns=patterns, **kw)
        err = max(int((stats - pstats).abs().max()), int((cstats - pstats).abs().max()))
        note_tail(max_err, stats, totals)
        note_tail(max_err, cstats, ctotals)
    else:
        tables = mxu.device_tables(mxu.build_tables(patterns, case_sensitive, whole_word), st.u8.device)
        kw.pop("whole_word")  # built into the tables
        counts, mask = mxu.hamming_scan(st.u8, st.n_blocks, tables, **kw)
        pcounts, pmask = mxu.hamming_scan_plain(st.u8, st.n_blocks, tables, **kw)
        name = "hamming_scan"
        err = int((counts - pcounts).abs().max())
    err = max(err, int((mask != pmask).any()))
    max_err[name] = max(max_err[name], err)
    lstats, tot = swar.lines_blocks(st.u8, mask, st.n_blocks)
    lerr = int((lstats - literal.lines_block_stats(st.u8, mask, st.n_blocks)).abs().max())
    max_err["lines_blocks"] = max(max_err["lines_blocks"], lerr)
    note_tail(max_err, lstats, tot)
    say(f"{say_prefix}: {name} K={len(patterns)} cs={case_sensitive} -w={whole_word}: "
        f"{int(counts.sum())} matches, {int(tot[1])} lines, errors {err}/{lerr}")
    return counts, mask


def shard_modes_vs_plain(st, max_err, route: str, true_len, start_limit: int, prev: int, *,
                         patterns, case_sensitive, whole_word):
    """One kernel in its shard mode ("fused": scan_blocks_multi with
    start_limit and prev_word, its mask and count instances; "hamming":
    hamming_scan with start_limit and prev_flag) against its plain version
    on a staged text; folds the difference into max_err and returns
    [matches, set mask bytes]."""
    from krep_tpu_torch.ops import literal, mxu, swar

    if route == "fused":
        kw = dict(patterns=patterns, case_sensitive=case_sensitive, whole_word=whole_word,
                  prev_word=prev, start_limit=start_limit, want_mask=True)
        stats, mask, totals = swar.scan_blocks_multi(st.u8, true_len, st.n_blocks, **kw)
        pstats, pmask = literal.block_stats_multi(st.u8, true_len, st.n_blocks, **kw)
        name, counts = "scan_blocks_multi shard", stats[:, 0]
        cstats, _, ctotals = swar.scan_blocks_multi(st.u8, true_len, st.n_blocks,
                                                    **dict(kw, want_mask=False))
        err = max(int((stats - pstats).abs().max()), int((cstats - pstats).abs().max()))
        note_tail(max_err, stats, totals)
        note_tail(max_err, cstats, ctotals)
    else:
        tables = mxu.device_tables(mxu.build_tables(patterns, case_sensitive, whole_word),
                                   st.u8.device)
        kw = dict(case_sensitive=case_sensitive, want_mask=True, start_limit=start_limit,
                  prev_flag=prev)
        counts, mask = mxu.hamming_scan(st.u8, st.n_blocks, tables, **kw)
        pcounts, pmask = mxu.hamming_scan_plain(st.u8, st.n_blocks, tables, **kw)
        name = "hamming_scan shard"
        err = int((counts - pcounts).abs().max())
    err = max(err, int((mask != pmask).any()), int(mask[start_limit:].any()))
    max_err[name] = max(max_err[name], err)
    return [int(counts.sum()), int(mask.sum(dtype=torch.int64))]


def single_pattern_identities(st, patterns, *, case_sensitive=True, whole_word=False,
                              want_lines=False):
    """The -c -o total and (want_lines) the -c count of a pattern set from
    the single-pattern kernel path alone (dispatch.scan_literal_staged,
    one pass per pattern): the sum of the per-pattern counts, and the
    matched lines of the OR of the per-pattern masks."""
    from krep_tpu_torch.ops import dispatch, literal

    total = 0
    union = None
    for p in patterns:
        tot, mask, _ = dispatch.scan_literal_staged(
            st, pattern=p, case_sensitive=case_sensitive, whole_word=whole_word,
            want_mask=want_lines,
        )
        total += int(tot[0])
        if want_lines:
            union = mask if union is None else union.bitwise_or_(mask)
    if not want_lines:
        return total, None
    body = union.shape[0]
    return total, literal.matched_line_count(union.to(torch.bool), st.u8[:body])


def dfa_vs_plain(st, max_err, tables, *, case_sensitive: bool, n_lanes: int = 1 << 16):
    """The dense-DFA kernel's count and mask instances of every table kind
    in `tables` (table, emit, maxlen, {kind: packed}) on a staged text
    against its plain version on the card (ac.dfa_walk_plain over n_lanes
    lanes: the lane count changes only its time), exactly; folds the
    differences into max_err, returns (emissions, flagged ends)."""
    from krep_tpu_torch.ops import ac

    table, emit, maxlen, packs = tables
    kw = dict(maxlen=maxlen, case_sensitive=case_sensitive)
    ptotal, pmask = ac.dfa_walk_plain(st.u8, st.true_len, st.n_blocks, table, emit,
                                      want_mask=True, n_lanes=n_lanes, **kw)
    for kind, packed in packs.items():
        ctotal, _ = ac.dfa_walk(st.u8, st.true_len, st.n_blocks, table, emit, want_mask=False,
                                packed=packed, **kw)
        total, mask = ac.dfa_walk(st.u8, st.true_len, st.n_blocks, table, emit, want_mask=True,
                                  packed=packed, **kw)
        err = abs(int(ctotal) - int(ptotal))
        merr = max(abs(int(total) - int(ptotal)), int((mask != pmask).any()))
        max_err["dfa_scan"] = max(max_err["dfa_scan"], err)
        max_err["dfa_scan mask"] = max(max_err["dfa_scan mask"], merr)
        del mask
    return int(ptotal), int(pmask.sum(dtype=torch.int64))


def first_line_raw(u8, true_len: int, n_blocks: int, mode: int, *, pattern: bytes,
                   case_sensitive=True, whole_word=False, prev_word=0, start_limit=None,
                   out=None, **_):
    """One launch of the K=1 first_line instance through its library entry
    (not counted as a main-path launch), its tail included: mode 1 finishes
    the mask in the tail as swar.scan_blocks does, mode 2 leaves each
    block's flags as if it began on a closed line (the launch without the
    fix-up step). Returns (stats, mask, totals), into `out` when given."""
    from krep_tpu_torch.ops import _build, literal, swar

    dev = u8.device
    stats, mask, totals = out or (
        torch.empty((n_blocks, 8), dtype=torch.int32, device=dev),
        torch.empty(n_blocks * 65536, dtype=torch.uint8, device=dev),
        torch.empty(8, dtype=torch.int32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    pat = pattern if case_sensitive else literal.fold_bytes_host(pattern)
    err = _build.library().krep_scan_blocks(
        u8.data_ptr(), n_blocks, pat, len(pat), int(not case_sensitive), int(whole_word),
        int(true_len), int(bool(prev_word)), swar.NO_LIMIT if start_limit is None else
        int(start_limit), mode, mask.data_ptr(), stats.data_ptr(), totals.data_ptr(),
        swar.tail_scratch(dev, stream).data_ptr(), stream)
    check(err == 0, f"krep_scan_blocks first_line={mode}: CUDA error {err}")
    return stats, mask, totals


def dfa_raw(st, packed, maxlen: int, span: int, mask=None, total=None) -> None:
    """One launch of the dense-DFA kernel through its library entry (not
    counted as a main-path launch, no allocation: the kernel's own time
    where the wrapper's host work would outlast it); the emissions add
    into `total`."""
    from krep_tpu_torch.ops import _build, ac

    dev = st.u8.device
    entries = packed.entries
    err = _build.library().krep_dfa_scan(
        st.u8.data_ptr(), int(st.true_len), st.n_blocks * 65536, span, maxlen - 1,
        ac.TABLE_KINDS.index(packed.kind), entries.data_ptr(),
        entries.numel() * entries.element_size(), packed.emit.data_ptr(), packed.entry0,
        None if mask is None else mask.data_ptr(), total.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err == 0, f"krep_dfa_scan: CUDA error {err}")


def daemon_pid(sock: str) -> int | None:
    """The pid of the `krep_tpu_torch.daemon` process serving `sock` (its
    command line names the socket), else None."""
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if b"krep_tpu_torch.daemon" in argv and sock.encode() in argv:
            return int(d)
    return None


def alive(pid: int) -> bool:
    """The process exists and has not exited (a zombie has)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def wait_for(cond, timeout: float, what: str) -> float:
    """Polls cond() until it holds; returns the seconds waited."""
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout, f"timed out after {timeout} s: {what}")
        time.sleep(0.02)
    return time.perf_counter() - t0


def warmed(pid: int) -> bool:
    """The daemon's warm-up has loaded the kernel library (its staged scan
    follows within milliseconds)."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return "libkrep_tpu_torch_" in f.read()
    except OSError:
        return False


def resident_engine_phase(workdir: str, card: str, files: dict, port_cli) -> None:
    """Phase 4c: the calibrated route, the port's daemon and its native
    client on the card. `files`: big (1 GiB config-1 corpus), small and
    mid (its first 64 and 16 MiB), ing (1 GiB config-4 corpus), c5 (the
    config-5 tree), f16 (the 16 literals); port_cli(args) -> (stdout, rc, s) runs the
    port's CLI in this process."""
    from krep_tpu_torch import daemon as kdaemon
    from krep_tpu_torch.native import client as kclient
    from krep_tpu_torch.ops import hostscan

    # 1. calibrate on the card, in a cache directory that also holds the
    # JAX package's record with another value (never to be read)
    cache = os.path.join(workdir, "calibration")
    os.makedirs(cache)
    decoy = os.path.join(cache, "breakeven.json")
    with open(decoy, "w") as f:
        json.dump({"breakeven_bytes": 12_345}, f)
    with env_set("KREP_TPU_CACHE_DIR", cache), env_set("KREP_TPU_HOST_BREAKEVEN", None):
        t0 = time.perf_counter()
        rec = hostscan.calibrate(force=True)
        cal_s = time.perf_counter() - t0
        t = hostscan.threshold()
        routes = (hostscan.route_small(t), hostscan.route_small(t + 1))
    say(f"calibration ({cal_s:.2f} s): host {rec['host_gbps']} GB/s, device overhead "
        f"{rec['device_overhead_s']} s, device {rec['device_gbps']} GB/s, break-even "
        f"{rec['breakeven_bytes']} bytes on {rec['platform']} {rec['device']} [{card}]")
    say(f"  record: {rec}")
    check(rec["platform"] == "cuda" and rec["device"] == torch.cuda.get_device_name(0),
          f"the calibration did not run on the card: {rec}")
    check(t == rec["breakeven_bytes"], f"threshold() {t} is not the record's")
    check(routes == (True, False), f"route_small(t), route_small(t + 1) = {routes}")
    check(sorted(os.listdir(cache)) == ["breakeven-torch.json", "breakeven.json"],
          f"the calibration's files: {os.listdir(cache)}")
    with open(decoy) as f:
        check(json.load(f) == {"breakeven_bytes": 12_345}, "the JAX package's record changed")

    # 2. the client, and the daemon through its real start path (the double
    # fork), while the references run
    t0 = time.perf_counter()
    client = str(kclient.build_client())
    say(f"client: built in {time.perf_counter() - t0:.2f} s -> {os.path.relpath(client, ROOT)}")
    sock = os.path.join(workdir, "daemon.sock")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "krep_tpu_torch.daemon", "--sock", sock,
                    "--idle", "600"], cwd=ROOT, check=True, timeout=60)
    pid = None
    try:
        wait_for(lambda: os.path.exists(sock), 60, "the daemon's socket")
        pid = daemon_pid(sock)
        check(pid is not None, "no daemon process serves the socket")
        say(f"daemon: pid {pid} listening {time.perf_counter() - t0:.2f} s after the start")
        ing64 = os.path.join(workdir, "ing_64m.txt")
        with open(files["ing"], "rb") as f, open(ing64, "wb") as g:
            g.write(f.read(MIB64))
        tiny = os.path.join(workdir, "corpus_4k.txt")
        with open(files["big"], "rb") as f, open(tiny, "wb") as g:
            g.write(f.read(4096))
        big, small = files["big"], files["small"]
        ere_env = {"KREP_TPU_STRICT": "1"}  # a failed fork pool raises
        runs = [  # (arguments, the request's extra env)
            (["-c", "the", big], {}),
            (["-o", "-m", "1000", "the", big], {}),
            (["-c", "-f", files["f16"], files["mid"]], {}),
            (["-r", "--gitignore", "-c", "the", files["c5"]], {}),
            (["-c", "-E", "[A-Z][a-z]+ing", ing64], ere_env),  # the prefilter's kernels
            (["-c", "-E", "th[a-z]+", small], ere_env),  # declined: the fork pool
            (["-c", "the", small], {"KREP_TPU_HOST_BREAKEVEN": "0"}),
            (["-c", "the", small], {"KREP_TPU_HOST_BREAKEVEN": str(4 << 30)}),
        ]
        t0 = time.perf_counter()
        refs = reference_clis([args for args, _ in runs],
                              env_extra={"KREP_TPU_REGEX_FILTER_MIN": str(1 << 40)})
        say(f"native host references: {time.perf_counter() - t0:.1f} s, 4 at a time [{card}]")
        from krep_tpu_torch.engine import regex_engine

        pool_runs = []
        real_parallel = regex_engine._search_regex_parallel

        def counting_parallel(*a):
            pool_runs.append(len(a[1]))
            return real_parallel(*a)

        ports = []
        regex_engine._search_regex_parallel = counting_parallel
        try:
            for args, extra in runs:
                with contextlib.ExitStack() as stack:
                    for k, v in extra.items():
                        stack.enter_context(env_set(k, v))
                    ports.append(port_cli(args))
        finally:
            regex_engine._search_regex_parallel = real_parallel
        # the daemon runs the same code on the same request: its fork pool
        # forks a process that holds a CUDA context
        check(pool_runs == [MIB64], f"only `-c -E th[a-z]+` takes the fork pool: {pool_runs}")

        wait_s = wait_for(lambda: warmed(pid), 120, "the daemon's warm-up")
        say(f"daemon: warm (kernel library loaded) after a further {wait_s:.2f} s")
        time.sleep(0.5)  # its small staged scan
        base_env = dict(os.environ, KREP_TPU_DAEMON_SOCK=sock, KREP_TPU_DAEMON_AUTOSPAWN="0",
                        KREP_TPU_PYTHON="/bin/false")

        def via_client(args, extra=None, sock_path=sock):
            env = dict(base_env, KREP_TPU_DAEMON_SOCK=sock_path, **(extra or {}))
            t0 = time.perf_counter()
            proc = subprocess.run([client, *args], env=env, capture_output=True, timeout=600)
            return proc.stdout, proc.stderr, proc.returncode, time.perf_counter() - t0

        first = via_client(["-c", "the", tiny])
        # 3. parity: the client through the daemon, the port in process, the
        # native host route
        for (args, extra), port, ref in zip(runs, ports, refs):
            out, err, rc, dt = via_client(args, extra)
            same = (out, rc) == port[:2] == ref[:2] and err == b""
            label = " ".join(os.path.basename(a) if os.sep in a else a for a in args)
            say(f"daemon: krep {label} {extra or ''}: rc={rc} stdout={len(out)} B sha256="
                f"{hashlib.sha256(out).hexdigest()[:16]} client {dt:.3f} s | in process "
                f"{port[2]:.3f} s | native host {ref[2]:.3f} s | identical={same} [{card}]")
            if err:
                say(f"  stderr: {err[-400:]!r}")
            check(same, f"the client's output differs for {label} {extra}")
        tiny_port = port_cli(["-c", "the", tiny])
        check(first[:3] == (tiny_port[0], b"", tiny_port[1]), f"the first call: {first[:3]}")

        # 4. the daemon launched the kernels: the same request served by
        # daemon.serve in a thread of this process, whose counts are readable
        sock2 = os.path.join(workdir, "inproc.sock")
        server = threading.Thread(target=kdaemon.serve, args=(sock2, 300), daemon=True)
        server.start()
        wait_for(lambda: os.path.exists(sock2), 60, "the in-process daemon's socket")
        # a first request is served only once the warm-up thread exists;
        # then wait for it, since its staged scan launches too
        check(via_client(["-c", "the", tiny], sock_path=sock2)[2] == 0, "the in-process daemon")
        for th in threading.enumerate():
            if th.name == "krep-warm":
                th.join(120)
        reset_launches()
        port_cli(["-c", "the", big])
        want = read_launches("scan_blocks", TAIL)
        reset_launches()
        served = via_client(["-c", "the", big], sock_path=sock2)
        got = read_launches("scan_blocks", TAIL)
        kdaemon.stop(sock2)
        server.join(60)
        say(f"launches of one `-c the` (1 GiB) served by daemon.serve: {got} (in process: "
            f"{want}); rc={served[2]}")
        check(served[:3] == (ports[0][0], b"", ports[0][1]), "the in-process daemon's answer")
        check(got == want and got["scan_blocks"] > 0, f"daemon launches {got} != {want}")
        check(not server.is_alive() and not os.path.exists(sock2), "the in-process daemon stayed")

        # 5. startup: the one-shot CLI against the warm client
        def one_shot(path):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "krep_tpu_torch.cli", "-c", "the", path],
                                  cwd=ROOT, capture_output=True, timeout=300)
            check(proc.returncode == 0, f"one-shot CLI: {proc.stderr[-400:]!r}")
            return time.perf_counter() - t0

        def median(xs):
            return sorted(xs)[len(xs) // 2]

        times = {
            "one-shot CLI, 4 KiB": median([one_shot(tiny) for _ in range(3)]),
            "one-shot CLI, 1 GiB": median([one_shot(big) for _ in range(3)]),
            "client, first call after the warm-up, 4 KiB": first[3],
            "client, steady, 4 KiB": median([via_client(["-c", "the", tiny])[3]
                                             for _ in range(5)]),
            "client, steady, 1 GiB": median([via_client(["-c", "the", big])[3]
                                             for _ in range(5)]),
        }
        for what, dt in times.items():
            say(f"startup: `krep -c the` {what}: {dt:.4f} s (break-even 0: the device route; "
                f"one-shot median of 3, steady median of 5) [{card}]")
    finally:
        # 6. stop: --stop ends the daemon and removes its socket (a daemon
        # still there a minute later is killed, and the phase fails)
        subprocess.run([sys.executable, "-m", "krep_tpu_torch.daemon", "--stop", "--sock", sock],
                       cwd=ROOT, timeout=60)
        t0 = time.perf_counter()
        while ((os.path.exists(sock) or (pid is not None and alive(pid)))
               and time.perf_counter() - t0 < 60):
            time.sleep(0.02)
        stopped = time.perf_counter() - t0
        if pid is not None and alive(pid):
            os.kill(pid, signal.SIGKILL)
    check(pid is not None and not alive(pid) and not os.path.exists(sock),
          "--stop left the daemon or its socket")
    say(f"daemon: stopped, socket removed, process ended {stopped:.2f} s after --stop")


def refuse(cause: str) -> int:
    """Exit code 1 with a last line {"ok": false, "error": cause}."""
    sys.stderr.write(f"chip_smoke: {cause}\n")
    print(json.dumps({"ok": False, "error": cause}), flush=True)
    return 1


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "krep_tpu_torch")):
        return refuse(f"the krep_tpu_torch package is missing: neither {HERE} nor the working "
                      f"directory {os.getcwd()} holds it (run from the repository root)")
    if not torch.cuda.is_available():
        return refuse("no CUDA device: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    os.environ["KREP_TORCH_DEVICE"] = "cuda"
    os.environ["KREP_TPU_HOST_BREAKEVEN"] = "0"  # the port's runs take the device path
    os.environ.setdefault("KREP_TPU_CACHE_DIR", os.path.join(ROOT, "build", "krep_tpu_cache"))

    from krep_tpu_torch import SearchParams, cli, search_string
    from krep_tpu_torch.ops import _build, dispatch, literal, mxu, swar
    from krep_tpu_torch.parallel import lines
    # bench.py's pattern sets: config 3b's variants, config 3c's mixed members
    from krep_tpu_torch.tools.bench_hamming import mixed_set, variant_set
    # sets that stress the K-pattern scan's verify: one 4-byte prefix for 64
    # members, members that collide in its filter map
    from krep_tpu_torch.tools.bench_multi import collision_set, common_prefix_set

    dev = torch.device("cuda", 0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")

    # 2. build, in a thread while the corpus is written (nvcc runs in
    # processes of its own, so the two overlap)
    built = in_background(_build.build)
    workdir = tempfile.mkdtemp(prefix="krep_chip_smoke_")
    try:
        big = os.path.join(workdir, "corpus_1g.txt")
        small = os.path.join(workdir, "corpus_64m.txt")
        mid = os.path.join(workdir, "corpus_16m.txt")
        t0 = time.perf_counter()
        gen_corpus(big, GIB)
        with open(big, "rb") as f:
            head = f.read(MIB64)
        with open(small, "wb") as f:
            f.write(head)
        with open(mid, "wb") as f:
            f.write(head[:MIB16])
        say(f"corpus: 1 GiB + 64 MiB + 16 MiB written in {time.perf_counter() - t0:.1f} s")
        lib, build_s = built()
        say(f"build: {build_s:.2f} s -> {os.path.relpath(lib, ROOT)}")
        ptx = ptxas_lines(lib.with_suffix(".log").read_text())
        for line in ptx:
            say(f"  ptxas: {line}")
        for kern in ("scan_blocks_kernel", "byte_scan_kernel"):
            mine = [line for line in ptx if line.startswith(kern + "<")]
            regs = [int(line.split("Used ")[1].split()[0]) for line in mine if "Used " in line]
            spills = [line for line in mine
                      if "spill" in line and " 0 bytes spill stores" not in line]
            say(f"  ptxas: {kern}: {len(mine)} instances, {min(regs, default=0)}-"
                f"{max(regs, default=0)} registers, {len(spills)} with spills")

        max_err = {"scan_blocks": 0, "combine_blocks": 0, TAIL: 0, "scan_blocks mask": 0,
                   "scan_blocks shard": 0}

        def kernels_vs_plain(st, **kw):
            """The scan and its tail against their plain versions on one
            staged text; folds the differences into max_err (the start-mask
            and shard instances also under their own names) and returns the
            kernel's (totals, mask)."""
            stats, mask, tot = swar.scan_blocks(st.u8, st.true_len, st.n_blocks, **kw)
            pstats, pmask = literal.block_stats(st.u8, st.true_len, st.n_blocks, **kw)
            errs = [int((stats - pstats).abs().max())]
            if kw.get("want_mask"):
                errs.append(int((mask != pmask).any()))  # 0/1 bytes
            names = ["scan_blocks"] + (["scan_blocks mask"] if kw.get("want_mask") else []) + (
                ["scan_blocks shard"] if kw.get("start_limit") is not None else [])
            for name in names:
                max_err[name] = max(max_err[name], *errs)
            note_tail(max_err, stats, tot)
            return tot, mask

        phase("3")
        # 3. kernels against their plain versions, exactly
        text = harden(np.frombuffer(head, np.uint8))
        st = dispatch.stage(text, dev)
        n_checks = 0
        limit = MIB64 - 12_345
        line_start = int(np.flatnonzero(text[1000:] == 10)[7]) + 1001
        for m in (1, 3, 5, 9, 17, 64):  # each pattern-length class of the word scan
            pat = {1: b"e", 3: b"the", 5: b"quick"}.get(m) or bytes(text[line_start : line_start + m])
            counts = []
            for cs in (True, False):
                for ww in (False, True):
                    for prev, sl in ((0, None), (1, limit)):
                        kernels_vs_plain(  # the count instance
                            st, pattern=pat, case_sensitive=cs, whole_word=ww,
                            prev_word=prev, start_limit=sl,
                        )
                        tot, mask = kernels_vs_plain(
                            st, pattern=pat, case_sensitive=cs, whole_word=ww,
                            prev_word=prev, start_limit=sl, want_mask=True,
                        )
                        # end to end against the literal.py port's own algorithm
                        if sl is None:
                            c, nl_, mk = literal.scan_literal(
                                st.u8, st.true_len, pattern=pat,
                                case_sensitive=cs, whole_word=ww,
                            )
                            want = [c, nl_]
                            check(torch.equal(mask, mk[: mask.shape[0]]),
                                  f"start mask m={m} cs={cs} ww={ww}")
                            got = tot[:2].tolist()
                        else:
                            r = literal.scan_shard(
                                st.u8, st.true_len, prev, sl, pattern=pat,
                                case_sensitive=cs, whole_word=ww,
                            )
                            want = [int(x) for x in r[:5]]
                            got = tot[:5].tolist()
                        check(got == want, f"totals m={m} cs={cs} ww={ww} limit={sl}: {got} != {want}")
                        n_checks += 1
                        if sl is None:
                            counts.append(got)
            say(f"kernels vs plain: m={m} pattern={pat!r} exact; [matches, lines] "
                f"for (cs, -w, -i, -i -w): {counts}")
        torch.cuda.synchronize()
        check(max(max_err.values()) == 0, f"kernel != plain: {max_err}")
        say(f"kernels vs plain at 64 MiB: {n_checks} cases (count and mask instances), all exact")
        del tot, mask

        phase("3+")
        # 3+. the multi-pattern kernels against their plain versions at 64 MiB
        pats16, pats64, pats_mixed = tuple(PATTERNS_16), variant_set(64), mixed_set()
        max_err.update(scan_blocks_multi=0, lines_blocks=0, hamming_scan=0)
        by_set = {}
        n_multi = 0
        for route, pats in (("fused", (b"the", b"fox")), ("fused", pats16), ("fused", pats64),
                            ("hamming", pats64), ("hamming", pats_mixed),
                            ("fused", common_prefix_set()), ("fused", collision_set())):
            for cs in (True, False):
                for ww in (False, True):
                    out = multi_kernels_vs_plain(
                        st, max_err, "multi kernels vs plain at 64 MiB", patterns=pats,
                        case_sensitive=cs, whole_word=ww, route=route)
                    n_multi += 1
                    other = by_set.setdefault((pats, cs, ww), out)
                    if other is not out:  # both routes on one set: same counts, same mask
                        check(torch.equal(other[0], out[0]) and torch.equal(other[1], out[1]),
                              f"fused and Hamming kernels differ on K={len(pats)} cs={cs} -w={ww}")
        del by_set, other, out
        # members that start with '\n' put flags on newline bytes
        for route, pats in (("fused", (b"\nthe", b"e\nt", b"fox")),
                            ("hamming", pats64[:62] + (b"\nthe", b"e\nt"))):
            multi_kernels_vs_plain(st, max_err, "multi kernels vs plain at 64 MiB", patterns=pats,
                                   case_sensitive=True, whole_word=False, route=route)
            n_multi += 1
        torch.cuda.synchronize()
        check(max(max_err.values()) == 0, f"multi-pattern kernel != plain: {max_err}")
        say(f"multi-pattern kernels vs plain at 64 MiB: {n_multi} cases, all exact")
        del st

        phase("3r")
        # 3r. the first_line mode (scan, carry fold and the tail's fix-up, one
        # launch) against its plain version at 64 MiB, on text whose lines cross the thread
        # spans and the block edges, span three blocks and more, and leave
        # whole blocks without a newline
        ltext = long_lines(text)
        st = dispatch.stage(ltext, dev)
        max_err.update({"scan_blocks first_line": 0, "first_line_fixup": 0})

        def first_line_vs_plain(staged, **kw):
            """The first_line scan (its tail finishing the mask) against
            literal.block_stats' first_line mode; the fix-up step alone as
            the same launch without it (block-by-block flags) finished by
            its plain twin, lines.first_line_fixup. Folds the differences
            into max_err, returns (stats, mask, totals, block-by-block
            flags)."""
            kw.update(want_mask=True, mask_kind="first_line")
            stats, mask, totals = swar.scan_blocks(staged.u8, staged.true_len, staged.n_blocks,
                                                   **kw)
            pstats, pmask = literal.block_stats(staged.u8, staged.true_len, staged.n_blocks, **kw)
            err = max(int((stats - pstats).abs().max()), int((mask != pmask).any()))
            note_tail(max_err, stats, totals)
            max_err["scan_blocks first_line"] = max(max_err["scan_blocks first_line"], err)
            bstats, blockwise, btotals = first_line_raw(staged.u8, staged.true_len,
                                                        staged.n_blocks, 2, **kw)
            fixed = lines.first_line_fixup(bstats, blockwise.clone())
            ferr = max(int((bstats != stats).any()), int((btotals != totals).any()),
                       int((fixed != mask).any()))
            max_err["first_line_fixup"] = max(max_err["first_line_fixup"], ferr)
            return stats, mask, totals, blockwise

        nl_free = None
        line_start = int(np.flatnonzero(ltext[5000:] == 10)[3]) + 5001
        for m in (1, 3, 5, 17, 64):
            pat = {1: b"e", 3: b"the"}.get(m) or bytes(ltext[line_start : line_start + m])
            got = []
            for cs in (True, False):
                for ww in (False, True):
                    stats, mask, tot, _ = first_line_vs_plain(st, pattern=pat,
                                                              case_sensitive=cs, whole_word=ww)
                    flags = int(mask.sum(dtype=torch.int64))
                    check(flags == int(tot[1]), f"first_line flags {flags} != lines {int(tot[1])}")
                    got.append([int(tot[0]), flags, int((stats[:, 5] >= 0).sum())])
                    nl_free = int((stats[:, 4] == 0).sum())
            say(f"first_line vs plain: m={m} pattern={pat!r} exact; [matches, first-in-line "
                f"flags, blocks with a lead flag] for (cs, -w, -i, -i -w): {got}")
        gaps = np.diff(np.flatnonzero(ltext == 10))
        check(nl_free > 0 and int(gaps.max()) > 3 * 65536, "the text lacks long lines")
        torch.cuda.synchronize()
        check(max_err["scan_blocks first_line"] == 0 and max_err["first_line_fixup"] == 0
              and max_err[TAIL] == 0, f"first_line kernel != plain: {max_err}")
        say(f"first_line kernels vs plain at 64 MiB: 20 cases, all exact; {nl_free} of "
            f"{st.n_blocks} blocks hold no newline, longest line {int(gaps.max())} bytes")
        del st, stats, mask, tot, ltext

        phase("3m")
        # 3m. the shard modes of the K-pattern scan and of the Hamming kernel
        # against their plain versions at 64 MiB: a start limit inside the
        # body with a match across it (matches end past it, in what is the
        # halo on a shard), and a match at byte 0 with a word byte before
        # the text (prev_word / prev_flag)
        limit = MIB64 - 12_345
        stext = text.copy()
        for at in (0, limit - 2):
            stext[at : at + 4] = np.frombuffer(b"the ", np.uint8)
        st = dispatch.stage(stext, dev)
        max_err.update({"scan_blocks_multi shard": 0, "hamming_scan shard": 0})
        n_shard = 0
        for pats in ((b"the", b"fox"), pats16, pats64):
            tl = limit + max(map(len, pats)) - 1
            for cs in (True, False):
                for ww in (False, True):
                    for prev in (0, 1):
                        got = shard_modes_vs_plain(st, max_err, "fused", tl, limit, prev,
                                                   patterns=pats, case_sensitive=cs,
                                                   whole_word=ww)
                        n_shard += 1
            say(f"shard mode vs plain at 64 MiB: scan_blocks_multi K={len(pats)} limit={limit}: "
                f"[matches, mask bytes] of the last case {got}")
        for pats in (pats64, pats_mixed):
            for ww in (False, True):
                for prev in (0, 1):
                    got = shard_modes_vs_plain(st, max_err, "hamming", None, limit, prev,
                                               patterns=pats, case_sensitive=True, whole_word=ww)
                    n_shard += 1
            say(f"shard mode vs plain at 64 MiB: hamming_scan K={len(pats)} limit={limit}: "
                f"[matches, mask bytes] of the last case {got}")
        torch.cuda.synchronize()
        check(max_err["scan_blocks_multi shard"] == 0 and max_err["hamming_scan shard"] == 0
              and max_err[TAIL] == 0, f"shard mode != plain: {max_err}")
        say(f"shard modes vs plain at 64 MiB: {n_shard} cases, all exact")
        del st, stext

        phase("3v")
        # 3v. the byte scan (KREP_TPU_BACKEND=pallas) against its plain
        # version at 64 MiB, exactly: pattern lengths 1..4096, each long one
        # planted across 64 KiB block edges, after "_^" and at the end, on
        # text with long lines (lines that span blocks); then its four
        # cost-attribution variants against theirs
        from krep_tpu_torch.ops import bytescan

        vtext = long_lines(text, seed=13)
        line_start = int(np.flatnonzero(vtext[3000:] == 10)[5]) + 3001
        max_err.update({"scan_bytes": 0, "scan_bytes mask": 0})
        vpats = {}
        for i, m in enumerate((1, 3, 5, 9, 17, 64, 65, 1000, 4096)):
            pat = {1: b"e", 3: b"the", 5: b"quick"}.get(m) or bytes(vtext[line_start : line_start + m])
            vpats[m] = pat
            if m > 5:  # each length at its own blocks; the longest last at the end
                for k in (3, 100, 500, 1000):
                    plant(vtext, (k + 3 * i) * 65536 - m // 2, b" " + pat + b" ")
                plant(vtext, (700 + 3 * i) * 65536 + 999, b"_^" + pat + b" ")
                plant(vtext, MIB64 - m - 1, b" " + pat)
        long70 = b" ".join(WORDS)[:70]
        for at in range(1 << 20, MIB64 - (1 << 20), 5 << 20):
            plant(vtext, at - 35, long70)  # some across block edges
        st = dispatch.stage(vtext, dev)
        n_v = 0
        for m, pat in vpats.items():
            got = []
            for cs in (True, False):
                for ww in (False, True):
                    for want_mask in (False, True):
                        kw = dict(pattern=pat, case_sensitive=cs, whole_word=ww,
                                  want_mask=want_mask)
                        stats, mask, tot = bytescan.scan_blocks_bytes(st.u8, st.true_len,
                                                                      st.n_blocks, **kw)
                        note_tail(max_err, stats, tot)
                        pstats, pmask = bytescan.block_stats_bytes(st.u8, st.true_len,
                                                                   st.n_blocks, **kw)
                        err = int((stats - pstats).abs().max())
                        if want_mask:
                            err = max(err, int((mask != pmask).any()))
                        name = "scan_bytes mask" if want_mask else "scan_bytes"
                        max_err[name] = max(max_err[name], err)
                        n_v += 1
                    got.append(tot[:2].tolist())
            check(m <= 5 or got[0][0] >= 5, f"the plants of m={m} did not match: {got}")
            say(f"byte scan vs plain: m={m} exact; [matches, lines] for (cs, -w, -i, -i -w): {got}")
        max_err.update({f"bench_kernel {v}": 0 for v in bytescan.VARIANTS})
        for v in bytescan.VARIANTS:
            stats = bytescan.scan_variant(st.u8, st.true_len, st.n_blocks, mode=v)
            pstats = bytescan.variant_stats_plain(st.u8, st.true_len, st.n_blocks, mode=v)
            max_err[f"bench_kernel {v}"] = int((stats - pstats).abs().max())
            say(f"variant vs plain at 64 MiB: {v}: {note_combine(max_err, stats)[:2].tolist()}")
        torch.cuda.synchronize()
        check(all(max_err[k] == 0 for k in max_err
                  if k.startswith(("scan_bytes", "bench_kernel", "combine"))),
              f"byte scan != plain: {max_err}")
        say(f"byte scan vs plain at 64 MiB: {n_v} cases and 4 variants, all exact")
        vpath = os.path.join(workdir, "plants_64m.txt")
        vtext.tofile(vpath)
        del st, stats, mask, pstats, pmask, vtext

        phase("3h")
        # 3h. the Hamming kernel's line mode and strict mode against their
        # plain versions at 64 MiB: lines on the 64 variants, the mixed set,
        # -w, -i and a '\n'-leading set (plain: literal.lines_block_stats of
        # the plain union mask); strict on with_len(n - j) views of a buffer
        # whose bytes past n - j are live text, with members planted to end
        # at and to cross n - j
        htext = text.copy()
        for j in (4095, 17, 1, 0):  # the nearer ends last: their plants stay whole
            plant(htext, MIB64 - j - 60, b" " + pats_mixed[0] + b" ")
            plant(htext, MIB64 - j - len(pats64[3]), pats64[3])                 # ends at n - j
            plant(htext, MIB64 - j - 4, b" " + pats_mixed[1] + b" " + pats64[5])  # crosses n - j
        st = dispatch.stage(htext, dev)
        max_err.update({"hamming_scan lines": 0, "hamming_scan strict": 0})
        nl_set = pats64[:62] + (b"\nthe", b"e\nt")
        for pats, cs, ww in ((pats64, True, False), (pats_mixed, True, False),
                             (pats_mixed, True, True), (pats64, False, False),
                             (nl_set, True, False)):
            tables = mxu.device_tables(mxu.build_tables(pats, cs, ww), dev)
            stats, _ = mxu.hamming_scan(st.u8, st.n_blocks, tables, case_sensitive=cs,
                                        want_lines=True)
            pstats, _ = mxu.hamming_scan_plain(st.u8, st.n_blocks, tables, case_sensitive=cs,
                                               want_lines=True)
            err = int((stats - pstats).abs().max())
            max_err["hamming_scan lines"] = max(max_err["hamming_scan lines"], err)
            say(f"Hamming lines vs plain at 64 MiB: K={len(pats)} cs={cs} -w={ww}: "
                f"[matches, lines] {note_combine(max_err, stats)[:2].tolist()}, error {err}")
        for pats in (pats64, pats_mixed):
            for ww in (False, True):
                tables = mxu.device_tables(mxu.build_tables(pats, True, ww), dev)
                got = []
                for j in (0, 1, 17, 4095):
                    view = st.with_len(MIB64 - j)
                    kw = dict(want_mask=True, strict=True, true_len=view.true_len)
                    counts, mask = mxu.hamming_scan(view.u8, view.n_blocks, tables, **kw)
                    pcounts, pmask = mxu.hamming_scan_plain(view.u8, view.n_blocks, tables, **kw)
                    err = max(int((counts - pcounts).abs().max()), int((mask != pmask).any()))
                    max_err["hamming_scan strict"] = max(max_err["hamming_scan strict"], err)
                    got.append(int(counts.sum()))
                say(f"Hamming strict vs plain at 64 MiB: K={len(pats)} -w={ww}: counts of the "
                    f"views n - (0, 1, 17, 4095): {got}")
                check(len(set(got)) > 1, "strict: the views' ends changed no count")
        torch.cuda.synchronize()
        check(max_err["hamming_scan lines"] == 0 and max_err["hamming_scan strict"] == 0
              and max_err["combine_blocks"] == 0, f"Hamming modes != plain: {max_err}")
        say("Hamming line and strict modes vs plain at 64 MiB: 21 cases, all exact (the line "
            "mode's rows folded by the standalone combine_blocks, exact too)")
        del st, htext, stats, pstats, counts, mask, pcounts, pmask

        phase("3d")
        # 3d. the dense-DFA kernel of KREP_TPU_DFA=1 (csrc/dfa_scan.cu)
        # against its plain version at 64 MiB, exactly: every instance
        # (shared 16-bit table, global 32-bit table, the wide table that
        # reads emit[] for counts past 16 bits; count and mask), with and
        # without -i, on bench.py's 100-pattern set (every kind), on a set
        # whose automaton comes near the 65,536-state cap (global, wide),
        # and on a -f list of 65,600 copies of "the" beside the 100 (its
        # count passes 65,535: the wide kind by default)
        from krep_tpu_torch.ops import ac

        t0 = time.perf_counter()
        cap_pats = near_cap_set(text)
        dup_pats = (b"the",) * 65_600 + variant_set(100)
        dfa_tables = {}  # (set, case) -> (table, emit, maxlen, {kind: packed}) on the card
        for label, pats, kinds in (("variant_set(100)", variant_set(100), ac.TABLE_KINDS),
                                   ("near the cap", cap_pats, ("global", "wide")),
                                   ("65,600 duplicates", dup_pats, ("wide",))):
            for cs in (True, False):
                if label != "near the cap" or cs:  # lower-case members: one automaton for -i
                    built = ac.build_dense_ac(list(pats), cs)
                check(built is not None, f"{label}: the automaton is over the cap")
                check(ac.pack_dense_table(*built, cs).kind == kinds[0],
                      f"{label}: the default table kind is not {kinds[0]}")
                dfa_tables[(label, cs)] = (
                    *(torch.from_numpy(a).to(dev) for a in built), max(map(len, pats)),
                    {k: ac.pack_dense_table(*built, cs, k).to(dev) for k in kinds})
        states = {k: int(v[0].shape[0]) for k, v in dfa_tables.items()}
        say(f"dense automata built and packed in {time.perf_counter() - t0:.1f} s: states {states}; "
            f"largest count {int(dfa_tables[('65,600 duplicates', True)][1].max())}")
        check(states[("near the cap", True)] > 60_000, "the near-cap automaton is small")
        check(states[("variant_set(100)", True)] <= ac.SHARED_MAX_STATES,
              "the 100-pattern automaton does not fit the shared table")
        max_err.update({"dfa_scan": 0, "dfa_scan mask": 0})
        st = dispatch.stage(text, dev)
        n_dfa = 0
        for (label, cs), tables in dfa_tables.items():
            got = dfa_vs_plain(st, max_err, tables, case_sensitive=cs)
            n_dfa += 2 * len(tables[3])
            say(f"dfa_scan vs plain at 64 MiB: {label} cs={cs} ({'/'.join(tables[3])}): "
                f"[emissions, flagged ends] {got}")
            check(got[0] > 0, f"dfa_scan: {label} found nothing")
        torch.cuda.synchronize()
        check(max_err["dfa_scan"] == 0 and max_err["dfa_scan mask"] == 0,
              f"dfa_scan != plain: {max_err}")
        say(f"dfa_scan vs plain at 64 MiB: {n_dfa} cases (every kind's count and mask "
            f"instances), all exact")
        del st

        phase("4")
        # 4. main path through the CLI, held to the native host route.
        # First the 1 GiB bucket's pinned host buffer, cold (the first in the
        # process at that size) and warm (from the caching host allocator),
        # so the first query below does not pay that allocation.
        for when in ("cold", "warm"):
            t0 = time.perf_counter()
            pinned = dispatch.host_buffer(dispatch.bucket_size(GIB), dev)
            say(f"pinned host buffer for the 1 GiB bucket, {when}: "
                f"{time.perf_counter() - t0:.4f} s [{card}]")
            del pinned
        runs = [
            (["-c", "the", big], GIB),
            (["-c", "the", big], GIB),
            (["-c", "-i", "-w", "the", big], GIB),
            (["-m", "5", "-o", "the", big], GIB),
            (["-o", "the", small], MIB64),
            (["the", small], MIB64),
        ]
        refs = reference_clis([args for args, _ in runs])

        def port_cli(args, one_card=True):
            """The port's CLI on `args`: (stdout, rc, wall s). On a machine
            with several cards the single-card phases pass -t 1, which
            keeps the CLI off the sharded route (phase 4m drives that)."""
            if one_card and torch.cuda.device_count() > 1:
                args = ["-t", "1", *args]
            buf = io.BytesIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(args, out=buf)
            torch.cuda.synchronize()
            return buf.getvalue(), rc, time.perf_counter() - t0

        def label_of(args):
            return " ".join(os.path.basename(a) if os.sep in a else a for a in args)

        def check_identical(args, nbytes, got, ref):
            (out, rc, dt), (rout, rrc, rdt) = got, ref
            label = label_of(args)
            digest = hashlib.sha256(out).hexdigest()[:16]
            same = out == rout and rc == rrc
            say(f"main path: krep {label}: rc={rc} stdout={len(out)} B sha256={digest} "
                f"port {dt:.3f} s ({nbytes / dt / 1e9:.2f} GB/s) | native host "
                f"{rdt:.3f} s | identical={same} [{card}]")
            if len(out) < 200:
                say(f"  stdout: {out!r}")
            check(same, f"port output differs from the native host route for {label}")

        def check_tail(counts: dict, what: str) -> None:
            """The scan tail folded the totals of `what` and the standalone
            combine_blocks never launched."""
            check(counts[TAIL] > 0 and counts["combine_blocks"] == 0,
                  f"{what}: the scan tail did not fold the totals alone: {counts}")

        reset_launches()
        outs = [port_cli(args) for args, _ in runs]
        launches = read_launches("scan_blocks", TAIL, "scan_blocks mask", "scan_blocks shard",
                                 "combine_blocks")
        for (args, nbytes), got, ref in zip(runs, outs, refs):
            check_identical(args, nbytes, got, ref)
        say(f"launches during the main path: {launches}")
        check_tail(launches, "the main path")
        check(all(launches[k] > 0 for k in launches if k != "combine_blocks"),
              f"a kernel never launched: {launches}")

        phase("4+")
        # 4+. the multi-pattern main path through the CLI: on 64 MiB held to
        # the native host route, on 1 GiB to single-pattern identities below
        def pattern_file(name, pats):
            path = os.path.join(workdir, name)
            with open(path, "wb") as f:
                f.write(b"\n".join(pats) + b"\n")
            return path

        f64 = pattern_file("pats64.txt", pats64)
        fmixed = pattern_file("pats_mixed.txt", pats_mixed)
        f100 = pattern_file("pats100.txt", variant_set(100))
        flong = pattern_file("pats_long.txt", pats16 + (b" ".join(WORDS)[:70],))
        e16 = [a for p in PATTERNS_16 for a in ("-e", p.decode())]
        big_runs = [  # (arguments, (identity, patterns, -w))
            (["-c", "-o", *e16, big], ("count", pats16, False)),
            (["-c", *e16, big], ("lines", pats16, False)),
            (["-c", "-o", "-f", f64, big], ("count", pats64, False)),
            (["-c", "-o", "-f", fmixed, big], ("count", pats_mixed, False)),
            (["-w", "-c", "-o", "-f", fmixed, big], ("count", pats_mixed, True)),
            (["-c", "-f", fmixed, big], ("lines", pats_mixed, False)),
        ]
        small_runs = [  # (arguments, bytes searched)
            (["-o", "-e", "the", "-e", "fox", "-e", "Sherlock", small], MIB64),
            (["-o", "-f", f64, mid], MIB16),
            (["-m", "1000", "-c", "-o", "-f", f100, mid], MIB16),
            (["-c", "-f", flong, mid], MIB16),
        ]
        small_refs = reference_clis([args for args, _ in small_runs])
        reset_launches()
        big_outs = [port_cli(args) for args, _ in big_runs]
        small_outs = [port_cli(args) for args, _ in small_runs]
        mlaunches = read_launches("scan_blocks", TAIL, "scan_blocks_multi", "lines_blocks",
                                  "hamming_scan", "combine_blocks")
        for (args, nbytes), got, ref in zip(small_runs, small_outs, small_refs):
            check_identical(args, nbytes, got, ref)
        say(f"launches during the multi-pattern main path: {mlaunches}")
        check_tail(mlaunches, "the multi-pattern main path")
        check(all(mlaunches[k] > 0 for k in mlaunches if k != "combine_blocks"),
              f"a kernel never launched: {mlaunches}")

        phase("4d")
        # 4d. KREP_TPU_DFA=1: sets of more than 64 patterns through the
        # dense DFA (ops/ac.py), on 16 MiB byte-identical to the native
        # host route (16 MiB x 100 patterns keeps krep_tpu on that route)
        # the trees of phase 4r, written while phase 4d runs (its runs wait
        # on the host attribution; no phase before it shares the host)
        tree = os.path.join(workdir, "tree")
        c5 = os.path.join(workdir, "config5_tree")

        def write_trees():
            os.makedirs(tree)
            info = gen_tree(tree, 400, 50, 8)
            os.makedirs(c5)
            gen_config5_tree(c5)
            return info

        trees_written = in_background(write_trees)
        d_runs = [["-c", "-o", "-f", f100, mid], ["-c", "-f", f100, mid],
                  ["-m", "1000", "-o", "-f", f100, mid], ["-w", "-c", "-o", "-f", f100, mid]]
        d_refs = reference_clis(d_runs)
        with env_set("KREP_TPU_DFA", "1"):
            reset_launches()
            d_outs = [port_cli(args) for args in d_runs]
            dlaunches = read_launches("dfa_scan", "dfa_scan mask",
                                      *(f"dfa_scan {k}" for k in ac.TABLE_KINDS))
        for args, got, ref in zip(d_runs, d_outs, d_refs):
            check_identical(args, MIB16, got, ref)
        say(f"launches under KREP_TPU_DFA=1: {dlaunches}")
        check(dlaunches["dfa_scan"] > 0 and dlaunches["dfa_scan mask"] > 0,
              f"the dense-DFA kernel never launched: {dlaunches}")
        check(dlaunches["dfa_scan shared"] == dlaunches["dfa_scan"] + dlaunches["dfa_scan mask"],
              f"the 100-pattern set left the shared table: {dlaunches}")
        del d_outs

        phase("4r")
        # 4r. recursive search through the walker and the batched scan, on
        # a config-5 tree scaled up and on the config-5 tree itself, held to
        # the native host route of krep_tpu.cli
        from krep_tpu_torch.io import batch as batch_mod
        from krep_tpu_torch.io import walker

        t0 = time.perf_counter()
        tree_info, trees_s = trees_written()
        part0 = os.path.join(tree, "part0")
        say(f"trees: {tree_info['files']} files ({tree_info['bytes']} bytes) in 400 directories "
            f"(part0: {tree_info['part0_files']} files, {tree_info['part0_bytes']} bytes in 50), "
            f"and the config-5 tree, written in {trees_s:.1f} s in the background (waited "
            f"{time.perf_counter() - t0:.1f} s)")

        # the counting modes run on the whole tree; the modes that print
        # every match and the multi-pattern run (every file solo) run on
        # part0, since they reach no kernel that the counting modes and
        # phase 4+ do not, and cost the printer's and the per-file syncs' time
        r_runs = [
            ["-r", "--gitignore", "-c", "the", tree],
            ["-r", "--gitignore", "-c", "-o", "the", tree],
            ["-r", "-i", "-w", "-c", "THE", tree],
            ["-r", "-o", "the", part0],
            ["-r", "the", part0],
            ["-r", "-c", "-e", "the", "-e", "fox", part0],
        ]
        c5_args = ["-r", "--gitignore", "-c", "the", c5]
        t0 = time.perf_counter()
        r_refs = reference_clis(r_runs + [c5_args])
        say(f"native host references of the -r runs: {time.perf_counter() - t0:.1f} s, "
            f"4 at a time [{card}]")

        # host seconds inside the layers of a -r run: staging (its host
        # half: the pinned buffer and the copy into it), the rest of
        # submit_batch (concatenation, launches), and drain_batch (the
        # readback's wait and the per-file split; the printer runs between
        # its yields and is not counted)
        batch_sizes: list[int] = []
        spent = {"stage": 0.0, "submit": 0.0, "drain": 0.0}
        real_submit, real_drain, real_stage = (batch_mod.submit_batch, batch_mod.drain_batch,
                                               dispatch.stage)

        def timed_stage(*a, **k):
            t = time.perf_counter()
            try:
                return real_stage(*a, **k)
            finally:
                if threading.current_thread() is threading.main_thread():  # not the solo thread
                    spent["stage"] += time.perf_counter() - t

        def counting_submit(params, b, device):
            batch_sizes.append(b.size)
            t = time.perf_counter()
            try:
                return real_submit(params, b, device)
            finally:
                spent["submit"] += time.perf_counter() - t

        def timed_drain(params, pending):
            it = real_drain(params, pending)
            while True:
                t = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                finally:
                    spent["drain"] += time.perf_counter() - t
                yield item

        def reset_spent():
            batch_sizes.clear()
            spent.update(stage=0.0, submit=0.0, drain=0.0)

        batch_mod.submit_batch, batch_mod.drain_batch = counting_submit, timed_drain
        dispatch.stage = timed_stage
        try:
            # the first -r of the process (pinned buffers, first launches),
            # on part0; then part0 walked and read as the walker does, no scan
            port_cli(["-r", "--gitignore", "-c", "the", part0])
            t0 = time.perf_counter()
            walked = n_walked = 0
            for path, _ in walker._walk(part0, True, None, [0]):
                with open(path, "rb") as f:
                    walked += len(f.read())
                n_walked += 1
            dt = time.perf_counter() - t0
            say(f"-r walk and read alone (part0, --gitignore, no scan): {dt:.3f} s for {n_walked} "
                f"files, {walked} bytes, {n_walked / dt:.0f} files/s [{card}]")
            reset_launches()
            r_outs, r_batches, r_spent, first_rc, solo_rce = [], [], [], None, None
            for args in r_runs:
                if args[-3:-1] == ["-e", "fox"]:
                    reset_launches()
                reset_spent()
                r_outs.append(port_cli(args))
                r_batches.append(list(batch_sizes))
                r_spent.append(dict(spent))
                if first_rc is None:  # the -r -c run alone
                    first_rc = read_launches("scan_blocks first_line", "first_line_fixup")
                if args[-3:-1] == ["-e", "fox"]:  # the solo -r -c -e run alone
                    solo_rce = read_launches("scan_blocks_multi", TAIL, "combine_blocks")
            c5_outs = {}
            for be in (None, "0"):  # the 32 MiB default (host route), then the device route
                if be is None:
                    del os.environ["KREP_TPU_HOST_BREAKEVEN"]
                reset_spent()
                c5_outs[be] = (port_cli(c5_args), list(batch_sizes))
                os.environ["KREP_TPU_HOST_BREAKEVEN"] = "0"
        finally:
            batch_mod.submit_batch, batch_mod.drain_batch = real_submit, real_drain
            dispatch.stage = real_stage
        n_all = r_outs[2][0].count(b"\n")  # -c prints one line per searched file
        n_gi = r_outs[0][0].count(b"\n")
        for args, got, ref, sizes, sp in zip(r_runs, r_outs, r_refs, r_batches, r_spent):
            if args[-1] == part0:
                nbytes, nfiles = tree_info["part0_bytes"], tree_info["part0_files"]
            else:
                nbytes, nfiles = tree_info["bytes"], n_gi if "--gitignore" in args else n_all
            check_identical(args, nbytes, got, ref)
            buckets = sorted({dispatch.bucket_size(n) // 65536 for n in sizes})
            say(f"  -r warm: {got[2]:.3f} s, {len(sizes)} batches (staged buckets of "
                f"{buckets} x 64 KiB), {nfiles} files, {nfiles / got[2]:.0f} files/s; host s in "
                f"stage {sp['stage']:.3f}, rest of submit_batch {sp['submit'] - sp['stage']:.3f}, "
                f"drain_batch {sp['drain']:.3f} [{card}]")
        c5_bytes = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(c5) for f in fs)
        for be, (got, sizes) in c5_outs.items():
            label = "break-even unset (32 MiB: host route)" if be is None else "break-even 0 (device)"
            check_identical(c5_args, c5_bytes, got, r_refs[-1])
            nfiles = got[0].count(b"\n")
            say(f"  config-5 tree, {label}: {got[2]:.3f} s, {len(sizes)} batches, {nfiles} files, "
                f"{nfiles / got[2]:.0f} files/s [{card}]")
        say(f"launches during -r --gitignore -c: {first_rc}; during the solo -r -c -e: "
            f"{solo_rce}")
        check(all(v > 0 for v in first_rc.values()), f"-r -c did not run first_line: {first_rc}")
        # one launch a batch: the scan finishes its first_line mask in its tail
        check(first_rc["scan_blocks first_line"] == len(r_batches[0]),
              f"-r -c: {first_rc} for {len(r_batches[0])} batches")
        say(f"-r --gitignore -c: {len(r_batches[0])} batches, {first_rc['scan_blocks first_line']} "
            f"first_line launches, each finishing its mask in its tail (no fix-up launch)")
        check(solo_rce["scan_blocks_multi"] > 0, f"-r -c -e never launched: {solo_rce}")
        check_tail(solo_rce, "the solo -r -c -e")
        launches.update(first_rc)
        del r_outs, c5_outs

        phase("4e")
        # 4e. regex (-E): the literal-factor prefilter on the card, glibc on
        # the candidate lines. On 1 GiB of bench.py's config-4 corpus a
        # one-factor ERE (the K=1 word scan) and a two-factor one (the
        # K-pattern scan); on the config-1 corpus an ERE whose factor is
        # everywhere (the prefilter declines, the fork pool answers after
        # the CUDA context exists); -r -E on part0. Each byte-identical to
        # krep_tpu with its prefilter off (glibc alone, no jax)
        from krep_tpu_torch.engine import regex_engine

        ing = os.path.join(workdir, "ing_1g.txt")
        t0 = time.perf_counter()
        gen_corpus_ing(ing, GIB)
        say(f"config-4 corpus: 1 GiB written in {time.perf_counter() - t0:.1f} s")
        one, two = "[A-Z][a-z]+ing", "[Mm]orning|[Nn]othing"
        e_runs = [(["-c", "-E", one, ing], GIB), (["-o", "-E", one, ing], GIB),
                  (["-i", "-c", "-E", one, ing], GIB), (["-c", "-E", two, ing], GIB),
                  (["-o", "-E", two, ing], GIB), (["-i", "-c", "-E", two, ing], GIB),
                  (["-c", "-E", "th[a-z]+", big], GIB),
                  (["-r", "-c", "-E", "import self [a-z]+ def", part0], tree_info["part0_bytes"]),
                  (["-r", "-o", "-E", "fox (def|class) [a-z]+", part0], tree_info["part0_bytes"])]
        t0 = time.perf_counter()
        e_refs = reference_clis([args for args, _ in e_runs], jobs=2,
                                env_extra={"KREP_TPU_REGEX_FILTER_MIN": str(1 << 40)})
        say(f"krep_tpu -E references (glibc alone): {time.perf_counter() - t0:.1f} s, "
            f"2 at a time [{card}]")
        pool_runs = []
        real_parallel = regex_engine._search_regex_parallel

        def counting_parallel(*a):
            pool_runs.append(len(a[1]))
            return real_parallel(*a)

        regex_engine._search_regex_parallel = counting_parallel
        try:
            with env_set("KREP_TPU_STRICT", "1"):
                reset_launches()
                e_outs = [port_cli(args) for args, _ in e_runs]
                elaunches = read_launches("scan_blocks", "scan_blocks mask",
                                          "scan_blocks_multi", TAIL, "combine_blocks")
                e_pool_runs = list(pool_runs)
                # the same program with its prefilter off: the host-only route
                real_min = regex_engine.REGEX_FILTER_MIN_BYTES
                regex_engine.REGEX_FILTER_MIN_BYTES = 1 << 62
                try:
                    host_only = port_cli(e_runs[0][0])
                finally:
                    regex_engine.REGEX_FILTER_MIN_BYTES = real_min
        finally:
            regex_engine._search_regex_parallel = real_parallel
        for (args, nbytes), got, ref in zip(e_runs, e_outs, e_refs):
            check_identical(args, nbytes, got, ref)
        check(host_only[:2] == e_outs[0][:2], "the host-only -E route differs")
        say(f"-E host-only route (glibc, fork pool): krep {label_of(e_runs[0][0])}: "
            f"{host_only[2]:.3f} s | with the prefilter {e_outs[0][2]:.3f} s [{card}]")
        say(f"launches during -E: {elaunches}; fork-pool runs (text bytes): {e_pool_runs}")
        check(elaunches["scan_blocks"] > 0 and elaunches["scan_blocks mask"] > 0
              and elaunches["scan_blocks_multi"] > 0, f"the prefilter never launched: {elaunches}")
        check(e_pool_runs == [GIB], f"-c -E th[a-z]+ alone should take the fork pool: "
                                    f"{e_pool_runs}")
        check(pool_runs == [GIB, GIB], f"the host-only route took no fork pool: {pool_runs}")
        check_tail(elaunches, "-E")
        del e_outs, e_refs

        phase("4v")
        # 4v. KREP_TPU_BACKEND=pallas: the byte scan on the single-array
        # route, the prefix filter and the -r position and -c -o batches,
        # each run byte-identical to the native host route
        v_runs = [  # (arguments, bytes searched, the reference's output)
            (["-c", "the", big], GIB, refs[0]),
            (["-c", "-i", "-w", "the", big], GIB, refs[2]),
            (["-o", "the", small], MIB64, refs[4]),
            (["the", small], MIB64, refs[5]),
            (["-r", "-o", "the", part0], tree_info["part0_bytes"], r_refs[3]),
        ]
        new_refs = reference_clis([["-c", "-o", long70.decode(), vpath],
                                   ["-r", "-c", "-o", "the", part0]])
        v_runs += [(["-c", "-o", long70.decode(), vpath], MIB64, new_refs[0]),
                   (["-r", "-c", "-o", "the", part0], tree_info["part0_bytes"], new_refs[1])]
        with env_set("KREP_TPU_BACKEND", "pallas"):
            reset_launches()
            v_outs = [port_cli(args) for args, _, _ in v_runs]
            vlaunches = read_launches("scan_bytes", "scan_bytes mask", TAIL, "combine_blocks")
        for (args, nbytes, ref), got in zip(v_runs, v_outs):
            check_identical(args, nbytes, got, ref)
        say(f"launches under KREP_TPU_BACKEND=pallas: {vlaunches}")
        check_tail(vlaunches, "KREP_TPU_BACKEND=pallas")
        check(vlaunches["scan_bytes"] > 0 and vlaunches["scan_bytes mask"] > 0,
              f"the byte scan never launched: {vlaunches}")
        launches.update({k: vlaunches[k] for k in ("scan_bytes", "scan_bytes mask")})
        del v_outs, r_refs

        phase("4b")
        # 4b. the cost-attribution tool, as a user runs it
        # (python -m krep_tpu_torch.tools.bench_kernel, 256 MiB of a-z)
        from krep_tpu_torch.tools import bench_kernel

        reset_launches()
        t0 = time.perf_counter()
        rc = bench_kernel.main([])
        blaunches = read_launches(*(f"bench_kernel {v}" for v in bytescan.VARIANTS),
                                  "combine_blocks")
        say(f"bench_kernel: rc={rc}, {time.perf_counter() - t0:.1f} s, launches {blaunches} [{card}]")
        check(rc == 0, "bench_kernel: a variant differs from its plain version")
        check(all(v > 0 for v in blaunches.values()),
              f"a variant or the combine of its rows never launched: {blaunches}")
        launches.update({k: n for k, n in blaunches.items() if k != "combine_blocks"})

        phase("4h")
        # 4h. KREP_TPU_MXU_LINES=inkernel: multi-pattern -c counts its lines in
        # the Hamming kernel; each count equal to the default (chained)
        # route's, and on 16 MiB byte-identical to the native host route
        h_runs = [["-c", "-f", f64, big], ["-c", "-f", fmixed, big], ["-w", "-c", "-f", fmixed, big]]
        h_small = ["-c", "-f", f64, mid]
        h_ref = reference_cli(h_small)
        h_default = [port_cli(h_runs[0]), big_outs[5], port_cli(h_runs[2])]
        with env_set("KREP_TPU_MXU_LINES", "inkernel"):
            reset_launches()
            h_outs = [port_cli(args) for args in h_runs + [h_small]]
            hlaunches = read_launches("hamming_scan lines", "lines_blocks", "combine_blocks")
        for args, got, want in zip(h_runs, h_outs, h_default):
            same = got[:2] == want[:2]
            say(f"main path: krep {label_of(args)} (inkernel lines): {got[0]!r} rc={got[1]} "
                f"{got[2]:.3f} s | default route {want[0]!r} {want[2]:.3f} s | equal={same} [{card}]")
            check(same, f"inkernel lines differ from the chained route for {label_of(args)}")
        check_identical(h_small, MIB16, h_outs[3], h_ref)
        say(f"launches under KREP_TPU_MXU_LINES=inkernel: {hlaunches}")
        check(hlaunches["hamming_scan lines"] == 4 and hlaunches["lines_blocks"] == 0,
              f"the in-kernel line mode did not carry -c: {hlaunches}")
        check(hlaunches["combine_blocks"] > 0,
              f"the line mode's rows were not folded by combine_blocks: {hlaunches}")
        launches.update({k: hlaunches[k] for k in ("hamming_scan lines", "combine_blocks")})
        del h_outs, h_default

        phase("4m")
        # 4m. the sharded route (parallel/mesh.py) through the port's own
        # entry points, search_string and the CLI, on this card named four
        # times: mesh.devices answers (cuda:0,) * k, as the tests fake a
        # machine of several devices, so the engine's own rule (_shards, -t)
        # routes and shapes the mesh. The shards run one after another on
        # the one card, so the wall time is no multi-GPU speed. Each result
        # must equal the single-device route's (held to the native host
        # route in phases 4 and 4+) or the native host route's own output.
        from krep_tpu_torch.parallel import mesh as mesh_mod

        corpus = np.memmap(big, dtype=np.uint8, mode="r")
        long_pat = bytes(corpus[(256 << 20) - 30 : (256 << 20) + 40])  # across shard edge 1
        mesh_runs = [  # (label, params, bytes searched)
            ("-c the", SearchParams(patterns=(b"the",), count_mode=True), GIB),
            ("-c -i -w the", SearchParams(patterns=(b"the",), count_mode=True,
                                          case_sensitive=False, whole_word=True), GIB),
            ("-o the (64 MiB)", SearchParams(patterns=(b"the",), only_matching=True), MIB64),
            ("-c -o, 16 literals", SearchParams(patterns=pats16, count_mode=True,
                                                only_matching=True), GIB),
            ("-c, 16 literals", SearchParams(patterns=pats16, count_mode=True), GIB),
            ("-c -o -f pats64 (Hamming)", SearchParams(patterns=pats64, count_mode=True,
                                                       only_matching=True), GIB),
            (f"-c -o, a {len(long_pat)}-byte pattern",
             SearchParams(patterns=(long_pat,), count_mode=True, only_matching=True), GIB),
        ]

        def timed_search(p, nbytes, threads):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = search_string(p, corpus[:nbytes], threads=threads, device=dev)
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        singles = [timed_search(p, nbytes, 1) for _, p, nbytes in mesh_runs]
        real_devices, real_stage = mesh_mod.devices, mesh_mod.stage_shards
        staged_meshes: list[int] = []  # the shard count of every staging, in order

        def counting_stage(data, mesh):
            staged_meshes.append(len(mesh))
            return real_stage(data, mesh)

        def meshes_of(run):
            """The shard counts that `run` staged."""
            staged_meshes.clear()
            out = run()
            return out, list(staged_meshes)

        # a 64 MiB text with "athe" planted across every shard edge of 3, 4
        # and 8 shards: "athe" straddles the edge, and "the" starts the
        # shard after the word byte 'a' (-w must reject it there)
        edge_text = harden(np.frombuffer(head, np.uint8), seed=21)
        for d in (3, 4, 8):
            S = mesh_mod.shard_bytes(MIB64, d)
            for e in range(S, MIB64, S):
                edge_text[e - 2 : e + 4] = np.frombuffer(b" athe ", np.uint8)
        edge_path = os.path.join(workdir, "edges_64m.txt")
        edge_text.tofile(edge_path)
        del edge_text
        edge_runs = [["-c", "-o", "the"], ["-c", "-o", "-w", "the"], ["-c", "-w", "athe"],
                     ["-c", "-o", "-w", "-e", "the", "-e", "athe"],
                     ["-c", "-o", "-w", "-f", f64]]
        edge_refs = reference_clis([args + [edge_path] for args in edge_runs])
        cli_mesh_runs = [  # (arguments, bytes searched, reference's (stdout, rc), reference)
            (["-c", "the", big], GIB, refs[0][:2], "native host route"),
            (["-o", "the", small], MIB64, refs[4][:2], "native host route"),
            (["-c", *e16, big], GIB, big_outs[1][:2], "single-device route"),
        ]
        mesh_mod.stage_shards = counting_stage
        try:
            mesh_mod.devices = lambda device: (dev,) * 4
            reset_launches()
            shard_outs = [meshes_of(lambda: timed_search(p, nbytes, None))
                          for _, p, nbytes in mesh_runs]
            cli_outs = [meshes_of(lambda: port_cli(args, one_card=False))
                        for args, _, _, _ in cli_mesh_runs]
            mesh_launches = read_launches("scan_blocks", TAIL, "scan_blocks_multi shard",
                                          "hamming_scan shard", "combine_blocks")
            # -t N shapes the mesh of a machine of eight devices
            mesh_mod.devices = lambda device: (dev,) * 8
            edge_outs = [(d, args, meshes_of(lambda: port_cli(["-t", str(d), *args, edge_path],
                                                               one_card=False)))
                         for d in (3, 4, 8) for args in edge_runs]
        finally:
            mesh_mod.devices, mesh_mod.stage_shards = real_devices, real_stage
        for (label, p, nbytes), ((got, dt), shards), (want, sdt) in zip(mesh_runs, shard_outs,
                                                                         singles):
            equal = got.count == want.count and np.array_equal(got.positions, want.positions)
            say(f"sharded route, search_string on 4 shards of one card: krep {label}: count "
                f"{got.count}, {len(got.positions)} positions, {dt:.3f} s | single-device route "
                f"{sdt:.3f} s | identical={equal}, meshes staged {shards} [{card}]")
            check(equal, f"sharded route differs from the single-device route for {label}")
            check(shards and set(shards) == {4}, f"{label} did not take the 4-shard route")
        for (args, nbytes, ref, what), ((out, rc, dt), shards) in zip(cli_mesh_runs, cli_outs):
            same = (out, rc) == ref
            say(f"sharded route, CLI on 4 shards of one card: krep {label_of(args)}: rc={rc} "
                f"stdout={len(out)} B sha256={hashlib.sha256(out).hexdigest()[:16]} {dt:.3f} s "
                f"({nbytes / dt / 1e9:.2f} GB/s) | identical to the {what}={same}, meshes "
                f"staged {shards} [{card}]")
            check(same, f"krep {label_of(args)} on 4 shards differs from the {what}")
            check(shards and set(shards) == {4}, f"krep {label_of(args)} did not shard: {shards}")
        for (d, args, ((out, rc, dt), shards)), (rout, rrc, _) in zip(edge_outs, edge_refs * 3):
            same = out == rout and rc == rrc
            say(f"sharded route, CLI of 8 devices, edges planted: krep -t {d} {label_of(args)} "
                f"edges_64m.txt: {out!r} | native host route {rout!r} | identical={same}, "
                f"meshes staged {shards}, {dt:.3f} s")
            check(same, f"-t {d} differs from the native host route: {args}")
            check(shards and set(shards) == {d}, f"-t {d} staged meshes of {shards}")
        say(f"launches during the sharded route: {mesh_launches}")
        check_tail(mesh_launches, "the sharded route")
        check(all(mesh_launches[k] > 0 for k in mesh_launches if k != "combine_blocks"),
              f"a kernel never launched: {mesh_launches}")
        launches.update({k: mesh_launches[k] for k in ("scan_blocks_multi shard",
                                                       "hamming_scan shard")})
        del shard_outs, cli_outs, edge_outs
        t0 = time.perf_counter()
        mesh_mod.dryrun(4, dev)
        say(f"mesh.dryrun(4) on {mesh_mod.mesh_of(4, dev)}: ok, {time.perf_counter() - t0:.2f} s")
        if torch.cuda.device_count() > 1:
            # the real devices: search_string and the CLI shard on their own (-t unset)
            say(f"real mesh: {mesh_mod.devices(dev)}")
            f16 = pattern_file("pats16.txt", pats16)
            real_runs = [(["-c", "the", big], GIB), (["-o", "the", small], MIB64),
                         (["-c", "-f", f16, big], GIB)]
            real_refs = reference_clis([args for args, _ in real_runs])
            for (args, nbytes), ref in zip(real_runs, real_refs):
                check_identical(args, nbytes, port_cli(args, one_card=False), ref)
            for (label, p, nbytes), (want, _) in zip(mesh_runs, singles):
                got, dt = timed_search(p, nbytes, None)
                check(got.count == want.count and np.array_equal(got.positions, want.positions),
                      f"real mesh differs from the single-device route for {label}")
                say(f"real mesh of {torch.cuda.device_count()} cards: krep {label}: identical, "
                    f"{dt:.3f} s [{card}]")
        else:
            say("real mesh: this machine has one card; only the repeated mesh ran")
        del corpus, singles

        phase("5")
        # 5. kernels vs plain at the main path's shapes, then timed at the
        # 1 GiB `-c the` shape
        corpus = np.memmap(big, dtype=np.uint8, mode="r")
        t0 = time.perf_counter()
        st = dispatch.stage(corpus, dev)
        torch.cuda.synchronize()
        say(f"staging 1 GiB (page cache -> pinned -> device): "
            f"{time.perf_counter() - t0:.4f} s [{card}]")
        shapes = [  # (name, staged text, scan arguments)
            ("1 GiB -c the", st, dict(pattern=b"the")),
            ("1 GiB -c -i -w the, shard stats", st,
             dict(pattern=b"the", case_sensitive=False, whole_word=True,
                  prev_word=1, start_limit=GIB - 12_345, want_mask=True)),
        ]
        # the slab loop's slabs: 64 MiB early-exit slabs (-m) and the 1 GiB
        # slabs of texts over 1 GiB, each with its (m-1)-byte halo and the
        # -w after-byte, owned region bounded by start_limit
        for owned, prev in ((MIB64, 1), (GIB, 0)):
            slab = dispatch.stage(np.concatenate([corpus[:owned], corpus[:3]]),
                                  dev, true_len=owned + 2)
            for cs, ww in ((True, False), (False, True)):
                shapes.append((
                    f"slab of {owned >> 20} MiB{' -i -w' if ww else ''}", slab,
                    dict(pattern=b"the", case_sensitive=cs, whole_word=ww,
                         prev_word=prev, start_limit=owned, want_mask=True),
                ))
        for name, staged, kw in shapes:
            tot, _ = kernels_vs_plain(staged, **kw)
            say(f"kernels vs plain: {name}: {staged.n_blocks} blocks, totals "
                f"{tot[:5].tolist()}, max_abs_err so far {max_err}")
        check(max(max_err.values()) == 0, f"kernel != plain at the main path's shapes: {max_err}")
        del shapes, slab, staged, tot
        kw = dict(pattern=b"the")
        stats, _, _ = swar.scan_blocks(st.u8, st.true_len, st.n_blocks, **kw)
        timing = {
            "scan_blocks": (
                cuda_ms(lambda: swar.scan_blocks(st.u8, st.true_len, st.n_blocks, **kw), 20),
                cuda_ms(lambda: literal.block_stats(st.u8, st.true_len, st.n_blocks, **kw), 3),
            ),
        }
        plain_scan_ms = cuda_ms(
            lambda: literal.scan_literal(st.u8, st.true_len, pattern=b"the", want_mask=False), 2
        )
        say(f"timing 1 GiB -c the: scan_blocks (count instance and its tail, one launch) "
            f"kernel {timing['scan_blocks'][0]:.4f} ms, plain {timing['scan_blocks'][1]:.4f} ms; "
            f"plain literal.scan_literal {plain_scan_ms:.4f} ms; the query's kernels "
            f"{timing['scan_blocks'][0]:.4f} ms ({GIB / timing['scan_blocks'][0] / 1e6:.1f} GB/s) "
            f"[{card}]")

        def tail_and_combine(u8, true_len, n_blocks, start_limit, rows, label):
            """The scan tail and the standalone combine_blocks on the count
            instance's rows of "the" at n_blocks rows: the tail's time is
            the count instance launched with its tail minus without it
            (krep_scan_blocks with no totals; 3 rounds in turns, medians),
            the combine's a launch of its own; each beside its bound and
            the plain fold. Returns {name: (ms, plain ms)} and the bound."""
            lib = _build.library()
            stream = torch.cuda.current_stream(dev).cuda_stream
            scratch = swar.tail_scratch(dev, stream)
            out = torch.empty((n_blocks, 8), dtype=torch.int32, device=dev)
            tot = torch.empty(8, dtype=torch.int32, device=dev)

            def scan(with_tail):
                err = lib.krep_scan_blocks(
                    u8.data_ptr(), n_blocks, b"the", 3, 0, 0, int(true_len), 0, int(start_limit),
                    0, None, out.data_ptr(), tot.data_ptr() if with_tail else None,
                    scratch.data_ptr() if with_tail else None, stream)
                check(err == 0, f"krep_scan_blocks: CUDA error {err}")

            scan(True)
            check(torch.equal(out, rows), f"{label}: krep_scan_blocks differs from the wrapper")
            note_tail(max_err, out, tot)
            note_combine(max_err, rows)
            w, wo = [], []
            for _ in range(3):
                w.append(cuda_ms(lambda: scan(True), 20))
                wo.append(cuda_ms(lambda: scan(False), 20))
            w, wo = sorted(w)[1], sorted(wo)[1]
            plain_ms = cuda_ms(lambda: lines.combine_block_stats(rows), 20)
            out_ms = {TAIL: (w - wo, plain_ms),
                      "combine_blocks": (cuda_ms(lambda: swar.combine_blocks(rows), 200), plain_ms)}
            b = bound(32 * n_blocks + 32)
            say(f"timing {label} ({n_blocks} rows): the count instance with its tail {w:.4f} ms, "
                f"without {wo:.4f} ms: the tail {w - wo:.4f} ms; the standalone combine_blocks "
                f"{out_ms['combine_blocks'][0]:.4f} ms; plain lines.combine_block_stats "
                f"{plain_ms:.4f} ms; bound {b[0]:.4f} ms ({b[1]}) [{card}]")
            return out_ms, b

        fold_ms, fold_bound = tail_and_combine(st.u8, st.true_len, st.n_blocks, swar.NO_LIMIT,
                                               stats, "1 GiB -c the")
        timing.update(fold_ms)
        check(max_err[TAIL] == 0 and max_err["combine_blocks"] == 0,
              f"the folds != plain at 1 GiB: {max_err}")

        # the word scan's K=1 instances at 1 GiB, on the corpus and on a-z
        # text (bench_scan's cases): count, -i -w count, start mask and
        # shard stats (a start limit 12,345 bytes before the end, prev_word
        # 1) for m = 1, 3, 5, 17 and 64, each exact against plain, then
        # timed beside its bound and its plain time (first_line is timed at
        # the batch shapes, 5r); then the shard instance at the 1 GiB slab
        # of the slab loop (24,576 blocks, a third of them past start_limit)
        from krep_tpu_torch.tools import bench_scan

        word_ms = {}
        for tname, src in (("corpus", corpus), ("a-z", bench_scan.a_to_z(GIB))):
            wst = st if tname == "corpus" else dispatch.stage(src, dev)
            for name, pat, kw, tl, nbytes in bench_scan.k1_cases(src, wst.n_blocks * 65536):
                if name.endswith("first_line"):
                    continue
                tl = wst.true_len if tl is None else tl
                kw = dict(kw, pattern=pat)
                stats, mask, totals = swar.scan_blocks(wst.u8, tl, wst.n_blocks, **kw)
                pstats, pmask = literal.block_stats(wst.u8, tl, wst.n_blocks, **kw)
                err = int((stats - pstats).abs().max())
                note_tail(max_err, stats, totals)
                if mask is not None:
                    err = max(err, int((mask != pmask).any()))
                key = ("scan_blocks mask" if name.endswith(" mask") else
                       "scan_blocks shard" if name.endswith(" shard") else "scan_blocks")
                max_err[key] = max(max_err[key], err)
                k_ms = cuda_ms(lambda: swar.scan_blocks(wst.u8, tl, wst.n_blocks, **kw), 20)
                p_ms = cuda_ms(lambda: literal.block_stats(wst.u8, tl, wst.n_blocks, **kw), 2)
                b_ms, b_by = bound(nbytes + 64 + 32 * wst.n_blocks)
                word_ms[(tname, name)] = (k_ms, p_ms, (b_ms, b_by))
                say(f"timing 1 GiB {tname}: scan_blocks {name} {k_ms:.4f} ms, plain {p_ms:.4f} "
                    f"ms, bound {b_ms:.4f} ms ({b_by}), {int(stats[:, 0].sum())} matches, error "
                    f"{err} [{card}]")
                del stats, mask, pstats, pmask, totals
            del wst, src
        check(max(max_err.values()) == 0, f"word scan != plain at 1 GiB: {max_err}")
        slab = dispatch.stage(np.concatenate([corpus[:GIB], corpus[:3]]), dev, true_len=GIB + 2)
        check(slab.n_blocks == 24_576, f"1 GiB slab bucket of {slab.n_blocks} blocks")
        skw = dict(pattern=b"the", prev_word=0, start_limit=GIB)
        shard_slab = (
            cuda_ms(lambda: swar.scan_blocks(slab.u8, slab.true_len, slab.n_blocks, **skw), 20),
            cuda_ms(lambda: literal.block_stats(slab.u8, slab.true_len, slab.n_blocks, **skw), 2),
        )
        slab_bound = bound(GIB + 64 + 32 * slab.n_blocks)
        say(f"timing the 1 GiB slab (24,576 blocks, start_limit 1 GiB): scan_blocks shard "
            f"{shard_slab[0]:.4f} ms, plain {shard_slab[1]:.4f} ms, bound {slab_bound[0]:.4f} ms "
            f"({slab_bound[1]}); the count instance on the 1 GiB staging "
            f"{word_ms[('corpus', 'm=3 count')][0]:.4f} ms [{card}]")
        srows, _, _ = swar.scan_blocks(slab.u8, slab.true_len, slab.n_blocks, **skw)
        tail_and_combine(slab.u8, slab.true_len, slab.n_blocks, GIB, srows, "the 1 GiB slab")
        check(max_err[TAIL] == 0 and max_err["combine_blocks"] == 0,
              f"the folds != plain at the 1 GiB slab: {max_err}")
        del slab, srows
        timing["scan_blocks mask"] = word_ms[("corpus", "m=3 mask")][:2]
        timing["scan_blocks shard"] = shard_slab

        # 4+, continued: each 1 GiB multi-pattern CLI count against the
        # single-pattern kernel path on the same staged corpus
        for (args, (kind, pats, ww)), (out, rc, dt) in zip(big_runs, big_outs):
            got = int(out.rsplit(b":", 1)[-1])
            total, nlines = single_pattern_identities(st, pats, whole_word=ww,
                                                      want_lines=kind == "lines")
            want = nlines if kind == "lines" else total
            say(f"main path: krep {label_of(args)}: rc={rc} count {got} port {dt:.3f} s "
                f"({GIB / dt / 1e9:.2f} GB/s) | single-pattern identity ({kind}, "
                f"{len(pats)} passes) {want} | equal={got == want} [{card}]")
            check(rc == 0 and got == want, f"multi-pattern {kind} identity fails for {label_of(args)}")

        phase("5+")
        # 5+. the multi-pattern kernels at 1 GiB: exact against plain, then timed
        for route, pats in (("fused", pats16), ("fused", pats64), ("hamming", pats64),
                            ("hamming", pats_mixed)):
            _, umask = multi_kernels_vs_plain(st, max_err, "kernels vs plain at 1 GiB",
                                              patterns=pats, case_sensitive=True,
                                              whole_word=False, route=route)
        check(max(max_err.values()) == 0, f"multi-pattern kernel != plain at 1 GiB: {max_err}")
        t64 = mxu.device_tables(mxu.build_tables(pats64, True), dev)
        tmixed = mxu.device_tables(mxu.build_tables(pats_mixed, True), dev)
        n_blk = st.n_blocks

        def fused(pats):
            return lambda: swar.scan_blocks_multi(st.u8, st.true_len, n_blk, patterns=pats)

        def fused_plain(pats):
            return lambda: literal.block_stats_multi(st.u8, st.true_len, n_blk, patterns=pats)

        mtiming = {
            "scan_blocks_multi": (cuda_ms(fused(pats16), 5), cuda_ms(fused_plain(pats16), 1)),
            "scan_blocks_multi K=64": (cuda_ms(fused(pats64), 3), cuda_ms(fused_plain(pats64), 1)),
            "hamming_scan": (cuda_ms(lambda: mxu.hamming_scan(st.u8, n_blk, t64), 5),
                             cuda_ms(lambda: mxu.hamming_scan_plain(st.u8, n_blk, t64), 1)),
            "hamming_scan mixed": (cuda_ms(lambda: mxu.hamming_scan(st.u8, n_blk, tmixed), 5),
                                   cuda_ms(lambda: mxu.hamming_scan_plain(st.u8, n_blk, tmixed), 1)),
            "lines_blocks": (cuda_ms(lambda: swar.lines_blocks(st.u8, umask, n_blk), 20),
                             cuda_ms(lambda: literal.lines_block_stats(st.u8, umask, n_blk), 2)),
        }
        for name, (k_ms, p_ms) in mtiming.items():
            say(f"timing 1 GiB multi-pattern: {name} kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms [{card}]")
        # the K-pattern scan's count and mask instances at K = 2, 16, 64 on
        # the corpus and on 1 GiB of a-z text (rare matches; its K=64 case
        # exact against plain first), each beside its bound
        az = dispatch.stage(np.random.default_rng(0).integers(97, 123, GIB, dtype=np.uint8), dev)
        multi_kernels_vs_plain(az, max_err, "kernels vs plain at 1 GiB of a-z", patterns=pats64,
                               case_sensitive=True, whole_word=False, route="fused")
        check(max(max_err.values()) == 0, f"K-pattern scan != plain on a-z: {max_err}")
        for tname, tst in (("corpus", st), ("a-z", az)):
            for pk in ((b"the", b"fox"), pats16, pats64):
                for want_mask in (False, True):
                    k_ms = cuda_ms(lambda: swar.scan_blocks_multi(
                        tst.u8, tst.true_len, tst.n_blocks, patterns=pk, want_mask=want_mask), 5)
                    b_ms, b_by = bound((2 if want_mask else 1) * tst.n_blocks * 65536 + 64
                                       + swar.MULTI_TABLE_BYTES + 32 * tst.n_blocks)
                    say(f"timing 1 GiB {tname}: scan_blocks_multi K={len(pk)} "
                        f"{'mask' if want_mask else 'count'} {k_ms:.4f} ms, bound {b_ms:.4f} ms "
                        f"({b_by}) [{card}]")
        del az, tst
        # the K-pattern scan / Hamming crossover on bench.py's sets
        # (variant_set(k): PATTERNS_16, then numbered variants of at most 8
        # bytes), 1 GiB, count only; both kernels' block counts equal
        for k in (16, 32, 48, 64):
            pk = variant_set(k)
            tk = mxu.device_tables(mxu.build_tables(pk, True), dev)
            fstats, _, _ = swar.scan_blocks_multi(st.u8, st.true_len, n_blk, patterns=pk)
            hcounts, _ = mxu.hamming_scan(st.u8, n_blk, tk)
            check(torch.equal(fstats[:, 0], hcounts), f"K={k}: the two kernels' counts differ")
            f_ms = cuda_ms(fused(pk), 3)
            h_ms = cuda_ms(lambda: mxu.hamming_scan(st.u8, n_blk, tk), 5)
            say(f"crossover K={k} (bench.py's set, 1 GiB, count only, {int(hcounts.sum())} "
                f"matches in both): K-pattern scan {f_ms:.4f} ms vs Hamming {h_ms:.4f} ms [{card}]")
            del fstats, hcounts, tk
        timing.update({k: mtiming[k] for k in ("scan_blocks_multi", "hamming_scan", "lines_blocks")})
        launches.update({k: mlaunches[k] for k in ("scan_blocks_multi", "lines_blocks", "hamming_scan")})

        # bounds at the timed shapes (HBM bytes, or int8 tensor-core
        # operations for the Hamming products), and the library yardstick
        body = st.n_blocks * 65536
        g1 = t64.g1
        hamming_ops = 2 * g1.shape[0] * g1.shape[1] * (body // 4)
        bounds = {
            "scan_blocks": bound(body + 64 + 32 * st.n_blocks),
            "scan_blocks mask": word_ms[("corpus", "m=3 mask")][2],
            "scan_blocks shard": slab_bound,
            "combine_blocks": fold_bound,
            TAIL: fold_bound,
            "scan_blocks_multi": bound(body + 64 + swar.MULTI_TABLE_BYTES + 32 * n_blk),
            "lines_blocks": bound(2 * body + 32 * n_blk + 32),
            "hamming_scan": bound(body + 64 + t64.g1_frags.numel() + t64.rows.numel() * 4
                                  + 4 * n_blk, hamming_ops, INT8_PEAK),
        }
        say(f"timing 1 GiB multi-pattern: lines_blocks (and its tail) on the 16 literals' union "
            f"mask {mtiming['lines_blocks'][0]:.4f} ms, plain {mtiming['lines_blocks'][1]:.4f} ms, "
            f"bound {bounds['lines_blocks'][0]:.4f} ms ({bounds['lines_blocks'][1]}) [{card}]")
        library = {"hamming_scan": int_mm_ms(st, g1)}
        say(f"library yardstick: torch._int_mm of the Hamming kernel's G (64 variants, "
            f"{tuple(g1.shape)}) against the window-bit features of 1 GiB, in 4 Mi-word "
            f"chunks: {library['hamming_scan']} ms [{card}]")
        # the mixed set: G1 over every row and G2 over the long rows
        mixed_ops = 2 * (tmixed.g1.shape[0] * tmixed.g1.shape[1]
                         + tmixed.g2.shape[0] * tmixed.g2.shape[1]) * (body // 4)
        mixed_bound = bound(body + 64 + tmixed.g1_frags.numel() + tmixed.g2_frags.numel()
                            + tmixed.rows.numel() * 4 + 4 * n_blk, mixed_ops, INT8_PEAK)
        mixed_lib = int_mm_ms(st, tmixed.g1, g2=tmixed.g2)
        say(f"mixed set (G1 {tuple(tmixed.g1.shape)}, G2 {tuple(tmixed.g2.shape)}): Hamming "
            f"{mtiming['hamming_scan mixed'][0]:.4f} ms, bound {mixed_bound[0]:.4f} ms "
            f"({mixed_bound[1]}); torch._int_mm of G1 and G2 against the window bits of "
            f"1 GiB: {mixed_lib} ms [{card}]")

        phase("4s")
        # 4s. the bench's strict count (bench.py:397, :439, :468):
        # multi.fused_count_device(staged, pats, True, ww, strict=True) on the
        # 1 GiB staging and on with_len(n - j) views of it, whose bytes past
        # n - j are live text; each equal to the -c -o count of phase 4+
        # adjusted by the starts near the new end (counted on the host)
        from krep_tpu_torch.ops import multi

        s_cases = [(pats64, False, big_outs[2]), (pats_mixed, False, big_outs[3]),
                   (pats_mixed, True, big_outs[4])]
        ends = (0, 1, 17, 4095)
        reset_launches()
        s_got = [[multi.fused_count_device(st.with_len(GIB - j), pats, True, ww, strict=True)
                  for j in ends] for pats, ww, _ in s_cases]
        slaunches = read_launches("hamming_scan strict")
        for (pats, ww, out), got in zip(s_cases, s_got):
            full = int(out[0].rsplit(b":", 1)[-1])
            want = [full + tail_adjusted_count(corpus, GIB, j, pats, ww) for j in ends]
            say(f"bench strict count: K={len(pats)} -w={ww}, views n - {ends}: {got} | "
                f"-c -o count adjusted at the end {want} | equal={got == want}")
            check(got == want, f"strict counts differ: {got} != {want}")
        say(f"launches during the strict counts: {slaunches}")
        check(slaunches["hamming_scan strict"] == 12, f"strict launches: {slaunches}")
        launches.update(slaunches)

        phase("5v")
        # 5v. the byte scan (both instances) and its variants at the 1 GiB
        # `-c the` shape: exact against plain, then timed
        for want_mask in (False, True):
            kw = dict(pattern=b"the", want_mask=want_mask)
            stats, mask, totals = bytescan.scan_blocks_bytes(st.u8, st.true_len, n_blk, **kw)
            pstats, pmask = bytescan.block_stats_bytes(st.u8, st.true_len, n_blk, **kw)
            err = int((stats - pstats).abs().max())
            if want_mask:
                err = max(err, int((mask != pmask).any()))
            name = "scan_bytes mask" if want_mask else "scan_bytes"
            max_err[name] = max(max_err[name], err)
            note_tail(max_err, stats, totals)
            say(f"byte scan vs plain at 1 GiB, mask={want_mask}: {totals[:5].tolist()}, "
                f"error {err}")
        del stats, mask, pstats, pmask, totals
        for v in bytescan.VARIANTS:
            got = bytescan.scan_variant(st.u8, st.true_len, n_blk, mode=v)
            want = bytescan.variant_stats_plain(st.u8, st.true_len, n_blk, mode=v)
            err = int((got - want).abs().max())
            max_err[f"bench_kernel {v}"] = max(max_err[f"bench_kernel {v}"], err)
            say(f"variant vs plain at 1 GiB: {v}: {note_combine(max_err, got)[:2].tolist()}, "
                f"error {err}")
        check(all(max_err[k] == 0 for k in max_err
                  if k.startswith(("scan_bytes", "bench_kernel", "combine"))),
              f"byte scan != plain at 1 GiB: {max_err}")

        def byte_scan(**kw):
            return lambda: bytescan.scan_blocks_bytes(st.u8, st.true_len, n_blk, pattern=b"the",
                                                      **kw)

        def byte_plain(**kw):
            return lambda: bytescan.block_stats_bytes(st.u8, st.true_len, n_blk, pattern=b"the",
                                                      **kw)

        vtiming = {
            "scan_bytes": (cuda_ms(byte_scan(), 20), cuda_ms(byte_plain(), 3)),
            "scan_bytes mask": (cuda_ms(byte_scan(want_mask=True), 20),
                                cuda_ms(byte_plain(want_mask=True), 3)),
        }
        for v in bytescan.VARIANTS:
            vtiming[f"bench_kernel {v}"] = (
                cuda_ms(lambda: bytescan.scan_variant(st.u8, st.true_len, n_blk, mode=v), 20),
                cuda_ms(lambda: bytescan.variant_stats_plain(st.u8, st.true_len, n_blk, mode=v), 3),
            )
        swar_mask_ms = cuda_ms(lambda: swar.scan_blocks(st.u8, st.true_len, n_blk, pattern=b"the",
                                                        want_mask=True), 20)
        library["bench_kernel passthrough"] = cuda_ms(
            lambda: torch.sum(st.u8[:body], dtype=torch.int32), 20)
        read_bound = bound(body + bytescan.HALO_BYTES + 32 * n_blk)
        bounds.update({
            "scan_bytes": read_bound,
            "scan_bytes mask": bound(2 * body + bytescan.HALO_BYTES + 32 * n_blk),
            "bench_kernel passthrough": bound(body + 32 * n_blk),
            **{f"bench_kernel {v}": read_bound for v in bytescan.VARIANTS[1:]},
        })
        for name, (k_ms, p_ms) in vtiming.items():
            say(f"timing 1 GiB -c the: {name} kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}) [{card}]")
        say(f"timing 1 GiB -c the: the SWAR scan with a mask {swar_mask_ms:.4f} ms; "
            f"torch.sum(text, dtype=torch.int32) {library['bench_kernel passthrough']:.4f} ms [{card}]")
        # long patterns, cut from the corpus at a line start (each occurs at
        # least once): count and mask, exact against plain, then timed
        nl0 = int(np.flatnonzero(corpus[7000:6_000_000] == 10)[1]) + 7001
        for m in (65, 1000, 4096):
            lpat = bytes(corpus[nl0 : nl0 + m])
            for want_mask in (False, True):
                kw = dict(pattern=lpat, want_mask=want_mask)
                stats, mask, totals = bytescan.scan_blocks_bytes(st.u8, st.true_len, n_blk, **kw)
                pstats, pmask = bytescan.block_stats_bytes(st.u8, st.true_len, n_blk, **kw)
                err = int((stats - pstats).abs().max())
                if want_mask:
                    err = max(err, int((mask != pmask).any()))
                name = "scan_bytes mask" if want_mask else "scan_bytes"
                max_err[name] = max(max_err[name], err)
                note_tail(max_err, stats, totals)
                k_ms = cuda_ms(lambda: bytescan.scan_blocks_bytes(st.u8, st.true_len, n_blk, **kw),
                               10)
                p_ms = cuda_ms(lambda: bytescan.block_stats_bytes(st.u8, st.true_len, n_blk, **kw),
                               1)
                b_ms, b_by = bounds[name]
                say(f"timing 1 GiB corpus: byte scan m={m} {'mask' if want_mask else 'count'} "
                    f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                    f"{int(stats[:, 0].sum())} matches, error {err} [{card}]")
                del stats, mask, pstats, pmask, totals
        check(max_err["scan_bytes"] == 0 and max_err["scan_bytes mask"] == 0 and max_err[TAIL] == 0,
              f"byte scan != plain at 1 GiB for long patterns: {max_err}")
        timing.update(vtiming)

        phase("5h")
        # 5h. the Hamming kernel's line and strict modes at 1 GiB: exact
        # against plain, then timed beside the chained pair (the mask
        # instance + lines_blocks), the count instance (re-timed) and
        # torch._int_mm
        view = st.with_len(GIB - 17)
        for tables, label in ((t64, "64 variants"), (tmixed, "mixed")):
            got, _ = mxu.hamming_scan(st.u8, n_blk, tables, want_lines=True)
            want, _ = mxu.hamming_scan_plain(st.u8, n_blk, tables, want_lines=True)
            err = int((got - want).abs().max())
            max_err["hamming_scan lines"] = max(max_err["hamming_scan lines"], err)
            skw = dict(strict=True, true_len=view.true_len, want_mask=True)
            got, gmask = mxu.hamming_scan(view.u8, n_blk, tables, **skw)
            want, wmask = mxu.hamming_scan_plain(view.u8, n_blk, tables, **skw)
            serr = max(int((got - want).abs().max()), int((gmask != wmask).any()))
            max_err["hamming_scan strict"] = max(max_err["hamming_scan strict"], serr)
            say(f"Hamming modes vs plain at 1 GiB, {label}: lines error {err}, strict (n - 17) "
                f"error {serr}")
            del got, want, gmask, wmask
        check(max_err["hamming_scan lines"] == 0 and max_err["hamming_scan strict"] == 0,
              f"Hamming modes != plain at 1 GiB: {max_err}")
        htiming = {}
        for tables, label in ((t64, ""), (tmixed, " mixed")):
            skw = dict(strict=True, true_len=view.true_len)
            htiming["hamming_scan lines" + label] = (
                cuda_ms(lambda: mxu.hamming_scan(st.u8, n_blk, tables, want_lines=True), 5),
                cuda_ms(lambda: mxu.hamming_scan_plain(st.u8, n_blk, tables, want_lines=True), 1))
            htiming["hamming_scan strict" + label] = (
                cuda_ms(lambda: mxu.hamming_scan(view.u8, n_blk, tables, **skw), 5),
                cuda_ms(lambda: mxu.hamming_scan_plain(view.u8, n_blk, tables, **skw), 1))
            htiming["hamming_scan count" + label] = (
                cuda_ms(lambda: mxu.hamming_scan(st.u8, n_blk, tables), 5), None)
            htiming["chained mask + lines_blocks" + label] = (cuda_ms(lambda: swar.lines_blocks(
                st.u8, mxu.hamming_scan(st.u8, n_blk, tables, want_mask=True)[1], n_blk), 5), None)
        for name, (k_ms, p_ms) in htiming.items():
            plain = "" if p_ms is None else f", plain {p_ms:.4f} ms"
            say(f"timing 1 GiB multi-pattern: {name} {k_ms:.4f} ms{plain} [{card}]")
        timing.update({k: htiming[k] for k in ("hamming_scan lines", "hamming_scan strict")})
        bounds.update({k: bounds["hamming_scan"] for k in ("hamming_scan lines",
                                                           "hamming_scan strict")})
        library.update({k: library["hamming_scan"] for k in ("hamming_scan lines",
                                                             "hamming_scan strict")})
        del view
        del st, umask

        phase("5r")
        # 5r. the first_line kernels at the batch shapes: the walker's full
        # batch (files of the tree in walk order until Batch.full, as the
        # walker flushes it: past 64 MiB, so the 1,536-block bucket, about a
        # third of it zero padding past true_len), the shape of the main
        # path's batches, the largest batch that fits 64 MiB (1,024 blocks),
        # and the first 1,000 blocks of the full batch (a last group of 40
        # blocks); exact against plain, then timed. The fix-up step is
        # timed as the tail is: the launch with it minus the same
        # launch without it (block-by-block flags), both through the
        # library entry, in turns
        full_b = batch_mod.Batch()
        for path, size in walker._walk(tree, False, None, [0]):
            if size > batch_mod.BATCH_FILE_MAX:
                continue  # a solo file never enters a batch
            with open(path, "rb") as f:
                full_b.add(path, f.read())
            if full_b.full:
                break
        small_b = batch_mod.Batch()
        for e, data in zip(full_b.entries, full_b.chunks[::2]):
            if small_b.size + e.size + 4 + batch_mod.GAP > MIB64:
                break
            small_b.add(e.path, data)
        for label, b, want_blocks in (("walker's full batch", full_b, 1536),
                                      ("64 MiB batch", small_b, 1024),
                                      ("1,000-block batch", full_b, 1000)):
            if want_blocks == 1000:  # not a staging bucket: the flat text and its zero halo
                raw = np.zeros(1000 * 65536 + dispatch.HALO_BYTES, np.uint8)
                raw[: 1000 * 65536] = np.frombuffer(b.buffer(), np.uint8)[: 1000 * 65536]
                st = types.SimpleNamespace(u8=torch.from_numpy(raw).to(dev),
                                           true_len=1000 * 65536, n_blocks=1000)
            else:
                st = dispatch.stage(b.buffer(), dev)
            check(st.n_blocks == want_blocks, f"{label}: bucket of {st.n_blocks} blocks")
            kw = dict(pattern=b"the", want_mask=True, mask_kind="first_line")
            stats, mask, totals, blockwise = first_line_vs_plain(st, pattern=b"the")
            check(max_err["scan_blocks first_line"] == 0 and max_err["first_line_fixup"] == 0,
                  f"first_line kernel != plain at the {label} shape: {max_err}")
            cleared = int((blockwise != mask).sum())
            work = blockwise.clone()
            outs = {mode: tuple(torch.empty_like(x) for x in (stats, mask, totals))
                    for mode in (1, 2)}
            for mode, want in ((1, mask), (2, blockwise)):
                got = first_line_raw(st.u8, st.true_len, st.n_blocks, mode, out=outs[mode], **kw)
                check(torch.equal(got[0], stats) and torch.equal(got[1], want)
                      and torch.equal(got[2], totals),
                      f"{label}: the library launch (first_line={mode}) differs from the wrapper's")
            turns = [cuda_ms(lambda: first_line_raw(st.u8, st.true_len, st.n_blocks, mode,
                                                    out=outs[mode], **kw), 200)
                     for mode in (1, 2, 2, 1)]
            with_ms, without_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            shape_ms = {
                "scan_blocks first_line": (
                    with_ms,
                    cuda_ms(lambda: literal.block_stats(st.u8, st.true_len, st.n_blocks, **kw), 3),
                ),
                "first_line_fixup": (
                    with_ms - without_ms,
                    cuda_ms(lambda: lines.first_line_fixup(stats, work), 20),
                ),
            }
            wrapper_ms = cuda_ms(lambda: swar.scan_blocks(st.u8, st.true_len, st.n_blocks, **kw),
                                 20)
            sbody = st.n_blocks * 65536
            shape_bounds = {
                "scan_blocks first_line": bound(2 * sbody + 64 + 32 * st.n_blocks),
                "first_line_fixup": bound(32 * st.n_blocks + cleared),
            }
            say(f"{label}: {st.n_blocks} blocks, {st.true_len} bytes; {int(mask.sum())} "
                f"first-in-line flags, {cleared} cleared by the tail's fix-up; exact")
            for name, (k_ms, p_ms) in shape_ms.items():
                say(f"timing {label}: {name} kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                    f"bound {shape_bounds[name][0]:.4f} ms ({shape_bounds[name][1]}) [{card}]")
            say(f"timing {label}: the launch with the fix-up step {with_ms:.4f} ms, without it "
                f"{without_ms:.4f} ms (turns {[round(t, 4) for t in turns]}); "
                f"swar.scan_blocks(first_line), one launch, {wrapper_ms:.4f} ms [{card}]")
            if want_blocks != 1000:
                edges = torch.tensor([(e.offset, e.offset + e.size) for e in b.entries],
                                     device=dev)
                counts_ms = cuda_ms(
                    lambda: batch_mod._file_counts_dev(mask, edges[:, 0], edges[:, 1]), 20)
                say(f"timing {label}: {len(b.entries)} files; per-file counts "
                    f"(_file_counts_dev, a torch cumsum) {counts_ms:.4f} ms [{card}]")
            if want_blocks == 1536:  # the main path's shape goes into the kernels line
                timing.update(shape_ms)
                bounds.update(shape_bounds)
            del st, stats, mask, blockwise, work, outs, totals

        phase("5m")
        # 5m. both shard modes at the main path's shard shape: shard 1 of the
        # 1 GiB corpus on 4 shards (S = 256 MiB: 4,096 blocks + the halo,
        # the byte before it a word byte or not), against the plain
        # versions on that one shard, exactly; then timed
        corpus = np.memmap(big, dtype=np.uint8, mode="r")
        sh = list(mesh_mod.stage_shards(corpus, (dev,) * 4))[1]
        check(sh.n_blocks == 4096 and sh.owned == 256 << 20, f"shard shape {sh.owned}")
        tl16 = sh.owned + max(map(len, pats16)) - 1
        for route, pats, tl in (("fused", pats16, tl16), ("hamming", pats64, None)):
            got = shard_modes_vs_plain(sh, max_err, route, tl, sh.owned, sh.prev_word,
                                       patterns=pats, case_sensitive=True, whole_word=False)
            say(f"shard mode vs plain at the 256 MiB shard: {route} K={len(pats)}: "
                f"[matches, mask bytes] {got}, prev_word {sh.prev_word}, exact")
        check(max_err["scan_blocks_multi shard"] == 0 and max_err["hamming_scan shard"] == 0,
              f"shard mode != plain at the shard shape: {max_err}")
        kw16 = dict(patterns=pats16, prev_word=sh.prev_word, start_limit=sh.owned)
        t64s = mxu.device_tables(mxu.build_tables(pats64, True), dev)
        hk = dict(start_limit=sh.owned, prev_flag=sh.prev_word)
        shard_ms = {
            "scan_blocks_multi shard": (
                cuda_ms(lambda: swar.scan_blocks_multi(sh.u8, tl16, sh.n_blocks, **kw16), 10),
                cuda_ms(lambda: literal.block_stats_multi(sh.u8, tl16, sh.n_blocks, **kw16), 1),
            ),
            "hamming_scan shard": (
                cuda_ms(lambda: mxu.hamming_scan(sh.u8, sh.n_blocks, t64s, **hk), 5),
                cuda_ms(lambda: mxu.hamming_scan_plain(sh.u8, sh.n_blocks, t64s, **hk), 1),
            ),
        }
        sbody = sh.n_blocks * 65536
        shard_bounds = {
            "scan_blocks_multi shard": bound(sbody + 64 + swar.MULTI_TABLE_BYTES
                                             + 32 * sh.n_blocks),
            "hamming_scan shard": bound(
                sbody + 64 + t64s.g1_frags.numel() + t64s.rows.numel() * 4 + 4 * sh.n_blocks,
                2 * t64s.g1.shape[0] * t64s.g1.shape[1] * (sh.owned // 4), INT8_PEAK),
        }
        library["hamming_scan shard"] = int_mm_ms(sh, t64s.g1)
        for name, (k_ms, p_ms) in shard_ms.items():
            say(f"timing the 256 MiB shard: {name} kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                f"bound {shard_bounds[name][0]:.4f} ms ({shard_bounds[name][1]}) [{card}]")
        # the same bytes through each kernel's unbounded instance: the cost
        # of the shard mode itself
        unbounded_ms = (
            cuda_ms(lambda: swar.scan_blocks_multi(sh.u8, sh.owned, sh.n_blocks, patterns=pats16),
                    10),
            cuda_ms(lambda: mxu.hamming_scan(sh.u8, sh.n_blocks, t64s), 5),
        )
        say(f"timing the 256 MiB shard without a limit: scan_blocks_multi K=16 "
            f"{unbounded_ms[0]:.4f} ms, hamming_scan {unbounded_ms[1]:.4f} ms [{card}]")
        say(f"library yardstick: torch._int_mm of G (64 variants) against the window bits of "
            f"the 256 MiB shard: {library['hamming_scan shard']:.4f} ms [{card}]")
        timing.update(shard_ms)
        bounds.update(shard_bounds)
        del sh, corpus

        phase("5d")
        # 5d. the dense-DFA kernel at 1 GiB: every instance exact against
        # plain (the three sets, -i), then timed with CUDA events beside its
        # bound and its plain time at 16 MiB (the 4d main path's shape),
        # 64 MiB and 1 GiB: each kind of the 100-pattern set at each size,
        # -i, the near-cap set and the duplicates at 1 GiB. The bound counts
        # the text, the packed table (and emit[] for the wide kind) and
        # (mask) the body's flags once each. Then the span: the default
        # kind's count at spans of 16 B to 4 KiB at 16 MiB and 1 GiB
        corpus = np.memmap(big, dtype=np.uint8, mode="r")
        st = dispatch.stage(corpus, dev)
        for (label, cs), tables in dfa_tables.items():  # 2^20 lanes: the plain walk's 1,024 steps
            got = dfa_vs_plain(st, max_err, tables, case_sensitive=cs, n_lanes=1 << 20)
            say(f"dfa_scan vs plain at 1 GiB: {label} cs={cs} ({'/'.join(tables[3])}): "
                f"[emissions, flagged ends] {got}")
        torch.cuda.synchronize()
        check(max_err["dfa_scan"] == 0 and max_err["dfa_scan mask"] == 0,
              f"dfa_scan != plain at 1 GiB: {max_err}")
        del st
        for size in (MIB16, MIB64, GIB):
            st = dispatch.stage(corpus[:size], dev)
            body = st.n_blocks * 65536
            dmask = torch.empty(body, dtype=torch.uint8, device=dev)
            dtotal = torch.zeros(1, dtype=torch.int64, device=dev)
            for (label, cs), (table, emit, maxlen, packs) in dfa_tables.items():
                if size != GIB and (label, cs) != ("variant_set(100)", True):
                    continue
                kw = dict(maxlen=maxlen, case_sensitive=cs)
                for want_mask in (False, True):
                    name = "dfa_scan mask" if want_mask else "dfa_scan"
                    out = dmask if want_mask else None
                    p_ms = None  # the plain walk timed on the 100 patterns alone
                    if (label, cs) == ("variant_set(100)", True):
                        p_ms = cuda_ms(lambda: ac.dfa_walk_plain(
                            st.u8, st.true_len, st.n_blocks, table, emit, want_mask=want_mask,
                            n_lanes=1 << 16, **kw), 1, warm=size != GIB)
                    for kind, packed in packs.items():
                        reps = 100 if size == MIB16 else 20
                        tbytes = packed.entries.numel() * packed.entries.element_size()
                        span = ac.lane_span(body, maxlen - 1, ac.resident_threads(
                            dev.index, kind, want_mask, tbytes))
                        k_ms = cuda_ms(lambda: dfa_raw(st, packed, maxlen, span, out, dtotal),
                                       reps)
                        w_ms = cuda_ms(lambda: ac.dfa_walk(
                            st.u8, st.true_len, st.n_blocks, table, emit, want_mask=want_mask,
                            packed=packed, **kw), reps)
                        b = bound(st.true_len + tbytes + (body if want_mask else 0)
                                  + (packed.emit.numel() * 4 if kind == "wide" else 0))
                        plain = "not timed" if p_ms is None else f"{p_ms:.4f} ms"
                        say(f"timing {size >> 20} MiB: {name} {label} cs={cs} {kind} "
                            f"({packed.states} states, span {span}, "
                            f"{-(-body // span)} threads): kernel {k_ms:.4f} ms (ac.dfa_walk, "
                            f"its host work included: {w_ms:.4f}), plain {plain}, bound "
                            f"{b[0]:.4f} ms ({b[1]}) [{card}]")
                        if size == MIB16 and kind == "shared":  # the 4d main path: kernels line
                            timing[name] = (k_ms, p_ms)
                            bounds[name] = b
            for label, kind in (("variant_set(100)", "shared"), ("near the cap", "global")):
                if size == MIB64:
                    continue
                table, emit, maxlen, packs = dfa_tables[(label, True)]
                packed = packs[kind]
                default = ac.lane_span(body, maxlen - 1, ac.resident_threads(
                    dev.index, kind, False, packed.entries.numel() * packed.entries.element_size()))
                spans = sorted({16, 32, 64, 128, 256, 512, 1024, 4096, default}
                               - ({16, 32} if label == "near the cap" else set()))
                got = [round(cuda_ms(lambda: dfa_raw(st, packed, maxlen, span, None, dtotal),
                                     20), 4) for span in spans]
                say(f"timing {size >> 20} MiB: dfa_scan {label} {kind} count by span "
                    f"{dict(zip(spans, got))} ms (the default span {default}) [{card}]")
            del st, dmask, dtotal
        launches.update(dlaunches)
        del corpus

        phase("4c")
        # 4c. the resident engine: the calibrated route, the daemon started
        # through its double fork and its native client, each query
        # byte-identical to the port in process and the native host route
        resident_engine_phase(workdir, card, {
            "big": big, "small": small, "mid": mid, "ing": ing, "c5": c5,
            "f16": pattern_file("pats16_4c.txt", pats16)}, port_cli)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    csrc = "krep_tpu_torch/csrc/"
    sources = {  # kernel: (source, the Pallas kernel it replaces)
        "scan_blocks": ("swar_scan.cu", "krep_tpu/ops/pallas_swar.py:396"),
        "scan_blocks mask": ("swar_scan.cu", "krep_tpu/ops/pallas_swar.py:396"),
        "scan_blocks shard": ("swar_scan.cu", "krep_tpu/ops/pallas_swar.py:396"),
        "combine_blocks": ("swar_scan.cu", "krep_tpu/ops/pallas_swar.py:396"),
        TAIL: ("scan_common.cuh", "krep_tpu/ops/pallas_swar.py:396"),
        "scan_blocks first_line": ("swar_scan.cu", "krep_tpu/ops/pallas_swar.py:396"),
        "first_line_fixup": ("scan_common.cuh", "krep_tpu/ops/pallas_swar.py:396"),
        "scan_blocks_multi": ("multi_scan.cu", "krep_tpu/ops/pallas_swar.py:396"),
        "lines_blocks": ("lines_scan.cu", "krep_tpu/ops/pallas_swar.py:1011"),
        "hamming_scan": ("hamming_scan.cu", "krep_tpu/ops/mxu_multi.py:209"),
        "scan_blocks_multi shard": ("multi_scan.cu", "krep_tpu/ops/pallas_swar.py:396"),
        "hamming_scan shard": ("hamming_scan.cu", "krep_tpu/ops/mxu_multi.py:209"),
        "scan_bytes": ("byte_scan.cu", "krep_tpu/ops/pallas_scan.py:116"),
        "scan_bytes mask": ("byte_scan.cu", "krep_tpu/ops/pallas_scan.py:116"),
        **{f"bench_kernel {v}": ("byte_scan.cu", "tools/bench_kernel.py:23")
           for v in ("passthrough", "compares_only", "lines_only", "full")},
        "hamming_scan lines": ("hamming_scan.cu", "krep_tpu/ops/mxu_multi.py:209"),
        "hamming_scan strict": ("hamming_scan.cu", "krep_tpu/ops/mxu_multi.py:209"),
        "dfa_scan": ("dfa_scan.cu", "krep_tpu/ops/ac.py:85"),
        "dfa_scan mask": ("dfa_scan.cu", "krep_tpu/ops/ac.py:85"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": csrc + src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": timing[name][0], "plain_ms": timing[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library.get(name)}
        for name, (src, replaces) in sources.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
