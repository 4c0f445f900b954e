"""The linux_tree recipe: deterministic in the seed, the same layout for
every seed, and every kind of file its configuration lists, at a small
size."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bench_helpers import SMALL  # noqa: E402
from recipes import linux_tree  # noqa: E402
from reference import tree  # noqa: E402

PARAMS = dict(linux_tree.PARAMS, **SMALL["linux_tree"])


def _snapshot(root) -> dict:
    """Every entry under root: a link's target, or a file's bytes, or None
    for a directory; in the order of the walk."""
    out = {}
    for d, dirs, names in os.walk(root):
        for n in sorted(dirs + names):
            p = os.path.join(d, n)
            rel = os.path.relpath(p, root)
            if os.path.islink(p):
                out[rel] = ("link", os.readlink(p))
            elif os.path.isdir(p):
                out[rel] = None
            else:
                out[rel] = open(p, "rb").read()
    return out


def test_same_seed_same_tree_other_seed_same_layout(tmp_path):
    snaps = []
    for k, seed in enumerate((2**62 + 3, 2**62 + 3, 11)):
        linux_tree.make(str(tmp_path / str(k)), PARAMS, seed)
        snaps.append(_snapshot(tmp_path / str(k)))
    assert snaps[0] == snaps[1]
    assert snaps[0].keys() == snaps[2].keys()
    size = lambda v: v if v is None or isinstance(v, tuple) else len(v)
    assert {k: size(v) for k, v in snaps[0].items()} == {k: size(v) for k, v in snaps[2].items()}
    assert snaps[0] != snaps[2]


def test_small_tree_holds_every_kind(tmp_path):
    linux_tree.make(str(tmp_path), PARAMS, 5)
    root = tmp_path / "linux"
    files, dirs, links = {}, set(), set()
    for d, ds, names in os.walk(root):
        for n in ds + names:
            p = os.path.join(d, n)
            rel = os.path.relpath(p, root)
            if os.path.islink(p):
                links.add(rel)
            elif os.path.isdir(p):
                dirs.add(rel)
            else:
                files[rel] = open(p, "rb").read()
    base = lambda r: os.path.basename(r)
    names = {base(r) for r in files}
    text = b"".join(files.values())
    depth = {r.count(os.sep) + 1 for r in files}
    assert min(depth) == 1 and max(depth) >= 5
    # sources, build output, module files, tools built in the tree
    assert any(n.endswith(".c") for n in names) and any(n.endswith(".h") for n in names)
    objects = [r for r in files if r.endswith(".o")]
    assert objects and all(os.path.join(os.path.dirname(r), "." + base(r) + ".cmd") in files
                           for r in objects)
    assert {"modules.order", "Module.symvers", "vmlinux", ".mailmap"} <= names
    assert any(n.endswith(".mod.c") for n in names)
    assert any(n.endswith(".tab.c") for n in names) and any(n.startswith("keep_") for n in names)
    tools = [r for r in files if base(r) in linux_tree.TOOLS]
    assert tools and all(b"\0" in files[r][:1024] and len(files[r]) < 1 << 20 for r in tools)
    # large headers: one sniffed out, one with a NUL past the sniff, the others clean
    big = {r: v for r, v in files.items() if len(v) > 1 << 20 and r.endswith(".h")}
    assert len(big) >= 3
    assert sum(b"\0" in v[:1024] for v in big.values()) == 1
    assert sum(b"\0" in v[1024:] for v in big.values()) == 1
    # .gitignore files: the root's, nested ones with plain, glob, dir-only, negated lines
    root_gi = files[".gitignore"].decode().split("\n")
    assert {".*", "!.gitignore", "*.mod.c", "modules.order"} <= set(root_gi)
    nested = [files[r].decode().split("\n") for r in files
              if base(r) == ".gitignore" and r != ".gitignore"]
    lines = {ln for ls in nested for ln in ls}
    assert len(nested) >= PARAMS["nested_gitignores"]
    assert "generated/" in lines and "!keep_*.tab.c" in lines and "!*.tab.h" in lines
    assert any(ln.lstrip("/") in linux_tree.TOOLS for ln in lines)
    assert any(base(d) == "generated" for d in dirs)
    assert any(base(r) == "generated" for r in files)   # a file a dir-only line leaves
    # hidden and skip-listed directories, skipped extensions, .min., links, empty files
    assert {".git", ".tmp_versions"} <= {base(d) for d in dirs}
    assert "build" in {base(d) for d in dirs}
    assert {"jquery.min.js", "logo.GIF", "screen.png"} <= names
    assert {"linked.h", "up"} == {base(r) for r in links}
    assert any(len(v) == 0 for v in files.values())
    assert any(v and v[-1:] != b"\n" for v in files.values())
    assert b"\0" not in b"".join(v for r, v in files.items()
                                 if r.endswith((".c", ".h")) and len(v) <= 1 << 20)
    # the literal: planted where the query searches, and where it does not
    here = os.getcwd()
    os.chdir(tmp_path)
    try:
        searched = {os.path.relpath(p, "linux") for p, _ in tree.walk("linux", True)}
    finally:
        os.chdir(here)
    hits = {r for r, v in files.items() if PARAMS["planted"].encode() in v}
    assert len(hits & searched) >= PARAMS["planted_files"]
    assert hits - searched   # in files --gitignore or the sniff passes over
    lines_hit = sum(sum(PARAMS["planted"].encode() in ln for ln in files[r].split(b"\n"))
                    for r in hits & searched)
    assert lines_hit >= PARAMS["planted_lines"]
