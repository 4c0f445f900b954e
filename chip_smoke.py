#!/usr/bin/env python3
"""Smoke test of krep_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; needs one CUDA card)

Phases, each printing what it found:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — the CUDA kernels from krep_tpu_torch/csrc, timed;
  3. kernels — each kernel against its plain PyTorch version on the card,
               exactly, at 64 MiB: count, matched lines, start mask and the
               slab (shard) stats with a start limit and prev_word, with and
               without -i and -w, for pattern lengths 1, 3, 5, 17 and 64;
  4. main path — the port's CLI on a 1 GiB config-1 corpus (bench.py's
               recipe, seed 12345): `-c the` (twice), `-c -i -w the` and
               `-m 5 -o the` (the slab route), and on its first 64 MiB
               `-o the` and the default line mode. Every stdout and exit
               code must equal `python -m krep_tpu.cli` on the native host
               route (KREP_TPU_HOST_BREAKEVEN=4294967296, no jax and no
               kernel), and every kernel must have launched. Before the
               runs, the 1 GiB bucket's pinned host buffer is timed cold
               and warm;
  5. shapes  — both kernels against their plain versions, exactly, at the
               shapes the main path gives them: 1 GiB `-c the` (no mask,
               16,384 blocks), 1 GiB shard stats with -i -w, start_limit and
               prev_word, and the slab loop's 64 MiB (1,536 blocks) and
               1 GiB (24,576 blocks) slabs; then each kernel timed against
               its plain version at the 1 GiB `-c the` shape, with CUDA
               events.
The multi-pattern slice (-e/-f) adds, with bench.py's pattern sets rebuilt
here (PATTERNS_16, config 3; its 64 eight-byte variants, config 3b; 64
mixed 4-20 byte members, config 3c):
  3+. kernels — the K-pattern scan (K = 2, 16, 64), the Hamming kernel (the
               64-variant and mixed sets) and the lines kernel (on both
               routes' union masks, with and without a '\n'-leading member)
               against their plain versions, exactly, at 64 MiB, with and
               without -i and -w;
  4+. main path — the port's CLI with several patterns: on 1 GiB, `-c -o`
               and `-c` with the 16 literals, `-c -o` with the 64 variants,
               `-c -o`, `-w -c -o` and `-c` with the mixed set, each held to
               identities over the single-pattern kernel (the -c -o total
               is the sum of the per-pattern counts; a -c count is the
               matched lines of the OR of the per-pattern masks); on
               64 MiB, `-o` with three literals and with the 64 variants,
               `-m 1000 -c -o` with 100 patterns (the K > 64 route) and `-c`
               with a member over 64 bytes (the slab route), each
               byte-identical to the native host route. Every new kernel
               must have launched;
  5+. shapes  — each new kernel against its plain version, exactly, and
               timed with CUDA events at 1 GiB: the K-pattern scan at K=16
               and K=64, the Hamming kernel on both sets, the lines kernel
               on a 1 GiB union mask.
It then prints one JSON line of kernels and, last, the result line. It
exits non-zero, with no result line, when any phase fails or no card is
available. Imports nothing of jax.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MIB64 = 64 << 20
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


def variant_set(k: int) -> tuple[bytes, ...]:
    """bench.py:362-371 (config 3b at k=64): PATTERNS_16, then numbered
    variants, at most 8 bytes each."""
    out = []
    i = 0
    while len(out) < k:
        w = PATTERNS_16[i % 16]
        r = i // 16
        p = (w[:5] + str(r).encode() if r else w)[:8]
        if p not in out:
            out.append(p)
        i += 1
    return tuple(out)


def mixed_set() -> tuple[bytes, ...]:
    """bench.py:417-430 (config 3c): 64 members of 4-20 bytes, some over
    13 bytes (the Hamming kernel's second window)."""
    rng = np.random.default_rng(777)
    out = []
    while len(out) < 64:
        ws = [WORDS[int(i)] for i in rng.integers(0, len(WORDS), int(rng.integers(1, 4)))]
        p = b" ".join(ws)[: int(rng.integers(4, 21))]
        if len(p) >= 4 and p not in out:
            out.append(p)
    return tuple(out)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


def gen_corpus(path: str, size: int, seed: int = 12345) -> None:
    """bench.py's config-1 corpus recipe (lines of 3-8 words from its
    vocabulary, joined by spaces), vectorised over a million lines at a
    time."""
    rng = np.random.default_rng(seed)
    tokens = [w + b" " for w in WORDS]
    lens = np.array([len(t) for t in tokens], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    pool = np.frombuffer(b"".join(tokens), np.uint8)
    written = 0
    with open(path, "wb") as f:
        while written < size:
            k = rng.integers(3, 9, 1 << 20)
            idx = rng.integers(0, len(WORDS), int(k.sum()))
            wl = lens[idx]
            ends = np.cumsum(wl)
            total = int(ends[-1])
            wid = np.repeat(np.arange(len(idx)), wl)
            chunk = pool[offs[idx][wid] + np.arange(total) - (ends - wl)[wid]]
            chunk[ends[np.cumsum(k) - 1] - 1] = 10  # a line's last space -> '\n'
            take = min(total, size - written)
            f.write(chunk[:take].tobytes())
            written += take


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


def cuda_ms(fn, reps: int) -> float:
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


def reference_cli(args: list[str]) -> tuple[bytes, int, float]:
    env = dict(os.environ, **REFERENCE_ENV)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "krep_tpu.cli", *args], cwd=ROOT, env=env,
        capture_output=True, timeout=600,
    )
    return proc.stdout, proc.returncode, time.perf_counter() - t0


def reset_launches() -> None:
    from krep_tpu_torch.ops import mxu, swar

    swar.LAUNCHES = swar.COMBINE_LAUNCHES = swar.MULTI_LAUNCHES = swar.LINES_LAUNCHES = 0
    mxu.LAUNCHES = 0


def read_launches() -> dict:
    from krep_tpu_torch.ops import mxu, swar

    return {"scan_blocks": swar.LAUNCHES, "combine_blocks": swar.COMBINE_LAUNCHES,
            "scan_blocks_multi": swar.MULTI_LAUNCHES, "lines_blocks": swar.LINES_LAUNCHES,
            "hamming_scan": mxu.LAUNCHES}


def multi_kernels_vs_plain(st, max_err, say_prefix: str, *, patterns, case_sensitive,
                           whole_word, route: str):
    """One multi-pattern kernel ("fused": scan_blocks_multi, "hamming":
    hamming_scan) and the lines kernel on its union mask against their plain
    versions; folds the differences into max_err, returns the kernel's
    (per-block counts, mask)."""
    from krep_tpu_torch.ops import literal, mxu, swar

    kw = dict(case_sensitive=case_sensitive, whole_word=whole_word, want_mask=True)
    if route == "fused":
        stats, mask = swar.scan_blocks_multi(st.u8, st.true_len, st.n_blocks, patterns=patterns, **kw)
        pstats, pmask = literal.block_stats_multi(
            st.u8, st.true_len, st.n_blocks, patterns=patterns, **kw)
        name, counts = "scan_blocks_multi", stats[:, 0]
        err = int((stats - pstats).abs().max())
    else:
        tables = mxu.device_tables(mxu.build_tables(patterns, case_sensitive, whole_word), st.u8.device)
        kw.pop("whole_word")  # built into the tables
        counts, mask = mxu.hamming_scan(st.u8, st.n_blocks, tables, **kw)
        pcounts, pmask = mxu.hamming_scan_plain(st.u8, st.n_blocks, tables, **kw)
        name = "hamming_scan"
        err = int((counts - pcounts).abs().max())
    err = max(err, int((mask != pmask).any()))
    max_err[name] = max(max_err[name], err)
    lstats = swar.lines_blocks(st.u8, mask, st.n_blocks)
    lerr = int((lstats - literal.lines_block_stats(st.u8, mask, st.n_blocks)).abs().max())
    max_err["lines_blocks"] = max(max_err["lines_blocks"], lerr)
    tot = swar.combine_blocks(lstats)
    say(f"{say_prefix}: {name} K={len(patterns)} cs={case_sensitive} -w={whole_word}: "
        f"{int(counts.sum())} matches, {int(tot[1])} lines, errors {err}/{lerr}")
    return counts, mask


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


def main() -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is False\n")
        return 1
    sys.path.insert(0, ROOT)
    os.environ["KREP_TORCH_DEVICE"] = "cuda"
    os.environ["KREP_TPU_HOST_BREAKEVEN"] = "0"  # the port's runs take the device path
    os.environ.setdefault("KREP_TPU_CACHE_DIR", os.path.join(ROOT, "build", "krep_tpu_cache"))

    from krep_tpu_torch import cli
    from krep_tpu_torch.ops import _build, dispatch, literal, mxu, swar
    from krep_tpu_torch.parallel import lines

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

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    say(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(lib, ROOT)}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "stack frame" in line:
            say(f"  ptxas: {line.strip()}")

    workdir = tempfile.mkdtemp(prefix="krep_chip_smoke_")
    try:
        big = os.path.join(workdir, "corpus_1g.txt")
        small = os.path.join(workdir, "corpus_64m.txt")
        t0 = time.perf_counter()
        gen_corpus(big, GIB)
        with open(big, "rb") as f:
            head = f.read(MIB64)
        with open(small, "wb") as f:
            f.write(head)
        say(f"corpus: 1 GiB + 64 MiB written in {time.perf_counter() - t0:.1f} s")

        max_err = {"scan_blocks": 0, "combine_blocks": 0}

        def kernels_vs_plain(st, **kw):
            """Both kernels against their plain versions on one staged text;
            folds the differences into max_err and returns the kernels'
            (totals, mask)."""
            stats, mask = swar.scan_blocks(st.u8, st.true_len, st.n_blocks, **kw)
            tot = swar.combine_blocks(stats)
            pstats, pmask = literal.block_stats(st.u8, st.true_len, st.n_blocks, **kw)
            errs = [int((stats - pstats).abs().max())]
            if kw.get("want_mask"):
                errs.append(int((mask != pmask).any()))  # 0/1 bytes
            max_err["scan_blocks"] = max(max_err["scan_blocks"], *errs)
            max_err["combine_blocks"] = max(
                max_err["combine_blocks"],
                int((tot - lines.combine_block_stats(stats)).abs().max()),
            )
            return tot, mask

        # 3. kernels against their plain versions, exactly
        text = harden(np.frombuffer(head, np.uint8))
        st = dispatch.stage(text, dev)
        n_checks = 0
        limit = MIB64 - 12_345
        line_start = int(np.flatnonzero(text[1000:] == 10)[7]) + 1001
        for m in (1, 3, 5, 17, 64):
            pat = {1: b"e", 3: b"the", 5: b"quick"}.get(m) or bytes(text[line_start : line_start + m])
            counts = []
            for cs in (True, False):
                for ww in (False, True):
                    for prev, sl in ((0, None), (1, limit)):
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
        say(f"kernels vs plain at 64 MiB: {n_checks} cases, all exact")
        del tot, mask

        # 3+. the multi-pattern kernels against their plain versions at 64 MiB
        pats16, pats64, pats_mixed = tuple(PATTERNS_16), variant_set(64), mixed_set()
        max_err.update(scan_blocks_multi=0, lines_blocks=0, hamming_scan=0)
        by_set = {}
        n_multi = 0
        for route, pats in (("fused", (b"the", b"fox")), ("fused", pats16), ("fused", pats64),
                            ("hamming", pats64), ("hamming", pats_mixed)):
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
        refs = [reference_cli(args) for args, _ in runs]

        def port_cli(args):
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

        reset_launches()
        outs = [port_cli(args) for args, _ in runs]
        launches = {k: v for k, v in read_launches().items() if k in ("scan_blocks", "combine_blocks")}
        for (args, nbytes), got, ref in zip(runs, outs, refs):
            check_identical(args, nbytes, got, ref)
        say(f"launches during the main path: {launches}")
        check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")

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
        small_runs = [
            ["-o", "-e", "the", "-e", "fox", "-e", "Sherlock", small],
            ["-o", "-f", f64, small],
            ["-m", "1000", "-c", "-o", "-f", f100, small],
            ["-c", "-f", flong, small],
        ]
        small_refs = [reference_cli(args) for args in small_runs]
        reset_launches()
        big_outs = [port_cli(args) for args, _ in big_runs]
        small_outs = [port_cli(args) for args in small_runs]
        mlaunches = read_launches()
        for args, got, ref in zip(small_runs, small_outs, small_refs):
            check_identical(args, MIB64, got, ref)
        say(f"launches during the multi-pattern main path: {mlaunches}")
        check(all(v > 0 for v in mlaunches.values()), f"a kernel never launched: {mlaunches}")

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
        stats, _ = swar.scan_blocks(st.u8, st.true_len, st.n_blocks, **kw)
        timing = {
            "scan_blocks": (
                cuda_ms(lambda: swar.scan_blocks(st.u8, st.true_len, st.n_blocks, **kw), 20),
                cuda_ms(lambda: literal.block_stats(st.u8, st.true_len, st.n_blocks, **kw), 3),
            ),
            "combine_blocks": (
                cuda_ms(lambda: swar.combine_blocks(stats), 200),
                cuda_ms(lambda: lines.combine_block_stats(stats), 20),
            ),
        }
        plain_scan_ms = cuda_ms(
            lambda: literal.scan_literal(st.u8, st.true_len, pattern=b"the", want_mask=False), 2
        )
        for name, (k_ms, p_ms) in timing.items():
            say(f"timing 1 GiB -c the: {name} kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms [{card}]")
        say(f"timing 1 GiB -c the: plain literal.scan_literal {plain_scan_ms:.4f} ms, "
            f"kernels {sum(t[0] for t in timing.values()):.4f} ms "
            f"({GIB / (timing['scan_blocks'][0] + timing['combine_blocks'][0]) / 1e6:.1f} GB/s) [{card}]")

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
        say(f"crossover at K=64 (64 eight-byte variants, 1 GiB, count only): K-pattern scan "
            f"{mtiming['scan_blocks_multi K=64'][0]:.4f} ms vs Hamming "
            f"{mtiming['hamming_scan'][0]:.4f} ms [{card}]")
        timing.update({k: mtiming[k] for k in ("scan_blocks_multi", "hamming_scan", "lines_blocks")})
        launches.update({k: mlaunches[k] for k in ("scan_blocks_multi", "lines_blocks", "hamming_scan")})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    csrc = "krep_tpu_torch/csrc/"
    sources = {  # kernel: (source, the Pallas kernel it replaces)
        "scan_blocks": ("swar_scan.cu", "krep_tpu/ops/pallas_swar.py:396"),
        "combine_blocks": ("swar_scan.cu", "krep_tpu/ops/pallas_swar.py:396"),
        "scan_blocks_multi": ("multi_scan.cu", "krep_tpu/ops/pallas_swar.py:396"),
        "lines_blocks": ("lines_scan.cu", "krep_tpu/ops/pallas_swar.py:1011"),
        "hamming_scan": ("hamming_scan.cu", "krep_tpu/ops/mxu_multi.py:209"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": csrc + src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": timing[name][0], "plain_ms": timing[name][1]}
        for name, (src, replaces) in sources.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
