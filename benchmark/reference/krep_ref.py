"""The reference: what `krep` prints for the queries the benchmark sends.

A plain implementation of the C binary's documented behaviour (krep
v2.2.0, krep.c) for literal searches, independent of the program under
test; it imports nothing of it.

    answer(argv) -> Answer(stdout_sha256, stdout_bytes, stdout_lines, stderr, rc,
                           searched_files, searched_bytes)

Supported: `[-c] [-o] [-F] (PATTERN | -e P ... | -f FILE) FILE`, literals
without a newline. `-c` prints `FILE:N`, N the lines that hold a match of
any pattern; `-o` prints `FILE:LINENO:MATCH` per non-overlapping match of
one literal. With `-r [--gitignore] -c` the operand is a directory, walked
as tree.py sets out: `PATH:N` for every file searched. Anything else
raises NotImplementedError. searched_files and searched_bytes: the files
the query searched and their bytes.

`control` breaks one guarantee, to show that the comparison sees it:
"block_edges" loses each match that crosses a 64 KiB edge of the file;
"gitignore_negation" drops every '!' line of the .gitignore files.
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple

from . import scan, tree

EDGE = 1 << 16
CONTROLS = ("block_edges", "gitignore_negation")


class Answer(NamedTuple):
    stdout_sha256: str
    stdout_bytes: int
    stdout_lines: int
    stderr: str
    rc: int
    searched_files: int
    searched_bytes: int


class _Digest:
    """A sink that keeps the digest, length and newline count of what is
    written to it."""

    def __init__(self):
        self.sha = hashlib.sha256()
        self.bytes = 0
        self.lines = 0

    def write(self, data: bytes) -> None:
        self.sha.update(data)
        self.bytes += len(data)
        self.lines += data.count(b"\n")


def parse(argv: list[str]) -> dict:
    """The options of `argv` that the reference supports."""
    q = {"count": False, "only": False, "recursive": False, "gitignore": False,
         "patterns": [], "target": None}
    args = list(argv)
    rest = []
    while args:
        a = args.pop(0)
        if a == "-c":
            q["count"] = True
        elif a == "-o":
            q["only"] = True
        elif a == "-F":
            pass
        elif a == "-r":
            q["recursive"] = True
        elif a == "--gitignore":
            q["gitignore"] = True
        elif a == "-e":
            q["patterns"].append(args.pop(0).encode())
        elif a == "-f":
            with open(args.pop(0), "rb") as f:
                lines = f.read().split(b"\n")
            if any(len(p) > 1023 or b"\0" in p for p in lines):
                raise NotImplementedError("-f lines over 1023 bytes or with a NUL")
            q["patterns"] += [p for p in lines if p]
        elif a.startswith("-") and a != "-":
            raise NotImplementedError(f"option {a}")
        else:
            rest.append(a)
    if not q["patterns"]:
        q["patterns"].append(rest.pop(0).encode())
    if len(rest) != 1 or rest[0] == "-":
        raise NotImplementedError("one FILE operand")
    q["target"] = rest[0]
    if any(not p or b"\n" in p for p in q["patterns"]):
        raise NotImplementedError("empty patterns or patterns with a newline")
    if q["only"] and (q["count"] or len(q["patterns"]) != 1):
        raise NotImplementedError("-o is supported for one literal, without -c")
    if not (q["count"] or q["only"]):
        raise NotImplementedError("line output (neither -c nor -o)")
    if q["gitignore"] and not q["recursive"]:
        raise NotImplementedError("--gitignore without -r")
    if q["recursive"]:
        if not q["count"]:
            raise NotImplementedError("-r without -c")
        if not os.path.isdir(q["target"]) or os.path.islink(q["target"]):
            raise NotImplementedError("-r with an operand that is not a directory")
    elif not os.path.isfile(q["target"]):
        raise NotImplementedError("a FILE that is not a regular file")
    return q


def answer(argv: list[str], control: str | None = None) -> Answer:
    """What `krep argv` prints and returns, or, under `control`, what a
    krep that breaks that guarantee would."""
    if control not in (None, *CONTROLS):
        raise ValueError(f"unknown control {control!r}")
    q = parse(argv)
    out = _Digest()
    target = q["target"]
    if q["recursive"]:
        if control == "block_edges":
            raise NotImplementedError("block_edges on a tree")
        matched, files, searched = tree.count_tree(
            target, q["patterns"], q["gitignore"], out,
            drop_negations=control == "gitignore_negation")
        return Answer(out.sha.hexdigest(), out.bytes, out.lines, "", 0 if matched else 1,
                      files, searched)
    if control == "gitignore_negation":
        raise NotImplementedError("gitignore_negation on one file")
    edge = EDGE if control == "block_edges" else None
    if q["count"]:
        n = scan.count_lines_file(target, q["patterns"], edge=edge)
        out.write(f"{target}:{n}\n".encode())
        matched = n > 0
    else:
        matched = scan.only_matching_file(target, q["patterns"][0], target.encode(), out,
                                          edge=edge) > 0
    return Answer(out.sha.hexdigest(), out.bytes, out.lines, "", 0 if matched else 1,
                  1, os.path.getsize(target))
