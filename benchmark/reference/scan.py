"""Plain NumPy literal search: the reference's counting and matching.

- `count_lines(text, members)`: the number of lines that hold at least one
  occurrence of any member. An Aho-Corasick automaton (a dense table of
  states x 256 bytes) walks the text in lockstep over chunks: every step
  advances all chunks by one byte. Each chunk starts maxlen - 1 bytes early
  from the root state, so at its first byte it is in the state a walk from
  the start of the text would be in (the state depends only on the last
  maxlen - 1 bytes read). Each chunk keeps how its lines begin and end, and
  a fold in text order joins the lines that cross chunks.
- `find_all(text, literal)`: sorted start offsets of every occurrence.
- `only_matching(...)`: the `-o` records `[FILE:]LINENO:MATCH\\n`.
- `count_lines_file` and `only_matching_file` do the same for a file, its
  byte range split over worker processes (plain subprocesses).

`edge` is the control: with edge = E, an occurrence that crosses a multiple
of E is lost, as a scan that reads each E-byte block alone would lose it.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np

NL = 10
_POW10 = 10 ** np.arange(1, 19, dtype=np.int64)


def automaton(members: list[bytes]) -> np.ndarray:
    """Dense Aho-Corasick table, flat int32 (states * 256,): the entry for
    state s and byte b, at s * 256 + b, is 512 * next_state +
    accept(next_state), the accept bit in bit 0, so entry >> 1 is the start
    of the next state's row."""
    goto = [dict()]
    out = [False]
    for m in members:
        if not m:
            raise NotImplementedError("an empty member")
        s = 0
        for b in m:
            nxt = goto[s].get(b)
            if nxt is None:
                nxt = len(goto)
                goto[s][b] = nxt
                goto.append(dict())
                out.append(False)
            s = nxt
        out[s] = True
    n = len(goto)
    if n >= 1 << 22:
        raise NotImplementedError("more than 4 M automaton states")
    delta = np.zeros((n, 256), np.int64)
    fail = [0] * n
    order = []
    for b, t in goto[0].items():
        delta[0, b] = t
        order.append(t)
    head = 0
    while head < len(order):
        # breadth first: a state's fail link is shallower, so its row is done
        s = order[head]
        head += 1
        out[s] = out[s] or out[fail[s]]
        delta[s] = delta[fail[s]]
        for b, t in goto[s].items():
            delta[s, b] = t
            fail[t] = int(delta[fail[s], b])
            order.append(t)
    acc = np.array(out, np.int64)
    return (delta * 512 + acc[delta]).astype(np.int32).ravel()


class Pieces(NamedTuple):
    """How the lines of a run of chunks begin and end. inner: lines closed
    by a chunk's second or later newline that hold a match; per chunk:
    seen (it holds a newline), head (the piece before its first newline
    holds a match), tail (the piece after its last newline, or all of it,
    holds a match)."""

    inner: int
    seen: np.ndarray
    head: np.ndarray
    tail: np.ndarray


def fold(pieces: list[Pieces]) -> int:
    """Matched lines of the text whose chunks, in order, gave `pieces`."""
    total, carry = 0, False
    for p in pieces:
        total += p.inner
        for seen, head, tail in zip(p.seen.tolist(), p.head.tolist(), p.tail.tolist()):
            if seen:
                total += carry or head
                carry = tail
            else:
                carry = carry or tail
    return total + carry


def line_pieces(text: np.ndarray, members: list[bytes], before: np.ndarray | None = None,
                width: int = 1 << 16, edge: int | None = None) -> Pieces:
    """Pieces of `text` (uint8), in chunks that walk in lockstep; `before`:
    the bytes that precede it (the first chunk's warm-up reads them). With
    `edge`, chunks are edge bytes and read nothing before their own."""
    if any(NL in m for m in members):
        raise NotImplementedError("members that hold a newline")
    n = int(text.shape[0])
    table = automaton(members)
    if edge is not None:
        if edge % 8:
            raise ValueError("edge must be a multiple of 8")
        chunk, warm = edge, 0
    else:
        chunk = -(-max(1, -(-n // width)) // 8) * 8
        warm = max(len(m) for m in members) - 1
    width = -(-n // chunk)
    padded = np.zeros(-(-(width * chunk + warm + 8) // 8) * 8, np.uint8)
    padded[warm : warm + n] = text
    if before is not None and warm:
        b = before[-warm:]
        padded[warm - b.shape[0] : warm] = b
    span = warm + chunk  # bytes each chunk reads: its warm-up, then its own
    # chunk c reads padded[c * chunk : c * chunk + span], as 8-byte words
    words = np.lib.stride_tricks.as_strided(
        padded.view(np.uint64), shape=(width, -(-span // 8)),
        strides=(chunk, 8), writeable=False)
    idx = np.empty(width, np.int32)
    entry = np.zeros(width, np.int32)     # the root's entry: row 0, no accept
    flag = np.zeros(width, np.int32)      # bit 0: the open line holds a match
    seen = np.zeros(width, bool)
    head = np.zeros(width, bool)
    inner = 0
    block = 16                            # words per transposed block
    for w0 in range(0, words.shape[1], block):
        # word-major copy of a block (each chunk's bytes read once a block),
        # then each word's 8 byte columns made contiguous
        wblk = np.ascontiguousarray(words[:, w0 : w0 + block].T).view(np.uint8)
        for w in range(wblk.shape[0]):
            cols = np.ascontiguousarray(wblk[w].reshape(width, 8).T)
            for b in range(8):
                j = 8 * (w0 + w) + b
                if j >= span:
                    break
                col = cols[b]
                np.right_shift(entry, 1, out=idx)
                np.add(idx, col, out=idx)
                np.take(table, idx, out=entry, mode="clip")
                if j < warm:
                    continue
                np.bitwise_or(flag, entry, out=flag)
                at = np.flatnonzero(col == NL)
                if at.shape[0]:
                    closed = (flag[at] & 1).astype(bool)
                    first = ~seen[at]
                    head[at[first]] = closed[first]
                    inner += int(np.count_nonzero(closed[~first]))
                    seen[at] = True
                    flag[at] = 0
    return Pieces(inner, seen, head, (flag & 1).astype(bool))


def count_lines(text: np.ndarray, members: list[bytes], edge: int | None = None,
                width: int = 1 << 16) -> int:
    """Lines of `text` (uint8) that hold an occurrence of some member. A
    line is a run of bytes ended by '\\n' or by the end of the text."""
    if text.shape[0] == 0:
        return 0
    return fold([line_pieces(text, members, width=width, edge=edge)])


def find_all(text: np.ndarray, literal: bytes, edge: int | None = None,
             base: int = 0) -> np.ndarray:
    """Sorted start offsets (int64, plus `base`) of every occurrence of
    `literal`, overlapping ones included; with `edge`, those that cross a
    multiple of `edge` (counted from `base`) are left out."""
    m = len(literal)
    n = int(text.shape[0])
    if m == 0:
        raise NotImplementedError("an empty literal")
    if n < m:
        return np.zeros(0, np.int64)
    lit = np.frombuffer(literal, np.uint8)
    cand = np.flatnonzero(text[: n - m + 1] == lit[0])
    for j in range(1, m):
        cand = cand[text[cand + j] == lit[j]]
    cand = cand.astype(np.int64) + base
    if edge is not None:
        cand = cand[cand // edge == (cand + m - 1) // edge]
    return cand


def border_free(literal: bytes) -> bool:
    """No proper prefix of `literal` is also its suffix: two occurrences
    never overlap, so -o prints every occurrence."""
    return not any(literal[:k] == literal[-k:] for k in range(1, len(literal)))


def records(lines: np.ndarray, literal: bytes, filename: bytes | None) -> bytes:
    """`[FILE:]LINENO:MATCH\\n` for matches of `literal` ('\\n' shown as ' ')
    on these lines; line numbers must not fall."""
    head = filename + b":" if filename is not None else b""
    body = b":" + literal.replace(b"\n", b" ") + b"\n"
    p = len(head)
    digits = np.searchsorted(_POW10, lines, side="right") + 1
    out = []
    # line numbers rise, so records of one digit count lie together
    cuts = np.flatnonzero(np.diff(digits)) + 1
    for a, b in zip(np.r_[0, cuts], np.r_[cuts, lines.shape[0]]):
        if a == b:
            continue
        d = int(digits[a])
        rec = np.empty((b - a, p + d + len(body)), np.uint8)
        rec[:] = np.frombuffer(head + b"0" * d + body, np.uint8)
        rec[:, p : p + d] = lines[a:b, None] // 10 ** np.arange(d - 1, -1, -1) % 10 + 48
        out.append(rec.tobytes())
    return b"".join(out)


def line_numbers(text: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """1-based line number of each start, with the C binary's quirk: above
    10 matches, a match past the last newline keeps the line number of the
    match before it (1 if none), krep.c:621-653."""
    nl = np.flatnonzero(text == NL)
    lines = np.searchsorted(nl, starts, side="left").astype(np.int64) + 1
    if starts.shape[0] > 10 and nl.shape[0]:
        beyond = starts > nl[-1]
        if beyond.any():
            first = int(np.argmax(beyond))
            lines[first:] = lines[first - 1] if first else 1
    return lines


def only_matching(text: np.ndarray, literal: bytes, filename: bytes | None,
                  edge: int | None = None) -> tuple[bytes, int]:
    """The -o output of one literal over `text`, and its match count."""
    if not border_free(literal):
        raise NotImplementedError("-o of a literal whose occurrences can overlap")
    starts = find_all(text, literal, edge)
    return records(line_numbers(text, starts), literal, filename), starts.shape[0]


# ---- files, split over worker processes --------------------------------


def _workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def _parts(n: int, unit: int, k: int) -> list[tuple[int, int]]:
    """k or fewer ranges that cover [0, n) and start at multiples of `unit`."""
    step = max(unit, -(-n // k // unit) * unit)
    return [(a, min(n, a + step)) for a in range(0, n, step)]


_WORKER = ("import pickle, sys\n"
           "sys.path.insert(0, sys.argv[1])\n"
           "from reference import scan\n"
           "name, args = pickle.load(sys.stdin.buffer)\n"
           "pickle.dump(getattr(scan, name)(*args), sys.stdout.buffer, protocol=5)\n")


def _in_workers(name: str, calls: list[tuple]):
    """Yields scan.<name>(*args) for each args in calls, in order, each
    computed in a Python process of its own, all started at once (plain
    subprocesses: each is waited for, and nothing outlives the call)."""
    bench = str(Path(__file__).resolve().parents[1])
    procs = []
    try:
        for args in calls:
            p = subprocess.Popen([sys.executable, "-c", _WORKER, bench], stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            procs.append(p)
            p.stdin.write(pickle.dumps((name, args)))
            p.stdin.close()
        for p in procs:
            out, err = p.stdout.read(), p.stderr.read()
            if p.wait() != 0:
                raise RuntimeError(f"a reference worker failed: {err.decode()[-2000:]}")
            yield pickle.loads(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            for f in (p.stdout, p.stderr):
                f.close()


def _pieces_part(path: str, a: int, b: int, members: list[bytes], edge: int | None) -> Pieces:
    mm = np.memmap(path, np.uint8, "r")
    warm = max(len(m) for m in members) - 1
    return line_pieces(np.array(mm[a:b]), members, before=np.array(mm[max(0, a - warm) : a]),
                       edge=edge)


def count_lines_file(path: str, members: list[bytes], edge: int | None = None,
                     workers: int | None = None) -> int:
    """count_lines over the bytes of the file at `path`."""
    n = os.path.getsize(path)
    if n == 0:
        return 0
    parts = _parts(n, edge or 8, workers or _workers())
    if len(parts) == 1:
        return fold([_pieces_part(path, 0, n, members, edge)])
    return fold(list(_in_workers("_pieces_part", [(path, a, b, members, edge) for a, b in parts])))


def _newlines_part(path: str, a: int, b: int) -> tuple[int, int]:
    """Newlines in [a, b) and the offset of the last one (-1 if none)."""
    nl = np.flatnonzero(np.memmap(path, np.uint8, "r")[a:b] == NL)
    return nl.shape[0], int(nl[-1]) + a if nl.shape[0] else -1


def _records_part(path: str, a: int, b: int, literal: bytes, filename: bytes | None,
                  edge: int | None, lines_before: int, upto: int, block: int = 1 << 24):
    """Records of the matches that start in [a, b) and at or before `upto`,
    their count and the last one's line number (0 if none); `block` bytes
    at a time."""
    mm = np.memmap(path, np.uint8, "r")
    m = len(literal)
    out, total, last = [], 0, 0
    for lo in range(a, b, block):
        hi = min(b, lo + block)
        text = np.array(mm[lo : min(mm.shape[0], hi + m - 1)])
        starts = find_all(text, literal, edge, base=lo)
        starts = starts[(starts < hi) & (starts <= upto)] - lo
        nl = np.flatnonzero(text[: hi - lo] == NL)
        lines = np.searchsorted(nl, starts, side="left").astype(np.int64) + 1 + lines_before
        lines_before += nl.shape[0]
        if lines.shape[0]:
            out.append(records(lines, literal, filename))
            total += lines.shape[0]
            last = int(lines[-1])
    return b"".join(out), total, last


def only_matching_file(path: str, literal: bytes, filename: bytes | None, sink,
                       edge: int | None = None, workers: int | None = None) -> int:
    """Write the -o output of `literal` over the file at `path` to
    sink.write, in order; returns the number of records."""
    if not border_free(literal):
        raise NotImplementedError("-o of a literal whose occurrences can overlap")
    n = os.path.getsize(path)
    m = len(literal)
    parts = _parts(n, 1 << 16, workers or _workers())
    total, last_line = 0, 0
    counts = list(_in_workers("_newlines_part", [(path, a, b) for a, b in parts]))
    last_nl = max([c[1] for c in counts], default=-1)
    before = np.cumsum([0] + [c[0] for c in counts])
    # matches past the last newline come last, below: the quirk gives them
    # a line number that depends on the number of matches
    upto = last_nl if last_nl >= 0 else n
    for data, k, last in _in_workers("_records_part", [
            (path, a, b, literal, filename, edge, int(before[i]), upto)
            for i, (a, b) in enumerate(parts)]):
        sink.write(data)
        total += k
        last_line = last or last_line
    if last_nl < 0:
        return total
    tail = np.array(np.memmap(path, np.uint8, "r")[last_nl + 1 :])
    starts = find_all(tail, literal, edge, base=last_nl + 1) - (last_nl + 1)
    if starts.shape[0] == 0:
        return total
    line = (last_line or 1) if total + starts.shape[0] > 10 else int(before[-1]) + 1
    sink.write(records(np.full(starts.shape[0], line, np.int64), literal, filename))
    return total + starts.shape[0]
