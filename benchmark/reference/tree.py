"""The reference's recursive search: `krep -r [--gitignore] -c PATTERN DIR`.

A plain walk written from the description of krep v2.2.0's walker in
SURVEY.md (its layer table, lines 35 and 139-141, and its call tree of
`search_directory_recursive_impl`, section 3.2, lines 230-243), which
cites krep.c:3068-3445 and krep.h:236-266. It is independent of the
program under test and imports nothing of it. Each rule names its source:

- entries in readdir order (os.scandir), a directory searched where it is
  listed, depth first (SURVEY.md:233-239: "per entry (readdir) ... dir:
  ... RECURSE");
- no symbolic link is followed: an entry is judged by lstat, and a link is
  neither a directory nor a regular file (the C tests' tree holds a
  symbolic link, SURVEY.md:314-317);
- a directory is pruned when its name starts with '.' (SURVEY.md:139,
  krep.c:3073-3077) or is on the skip list (krep.h:236-266), before its
  .gitignore verdict (SURVEY.md:237);
- a file is passed over when its name holds ".min." (SURVEY.md:139,
  krep.c:3103-3107: "`.min.*` assets skipped", whatever comes after the
  second dot), or when the text from its last dot, a dot that is not the
  name's first character, is on the extension list, compared without
  case (SURVEY.md:139, krep.h:247-266); then the .gitignore verdict; then,
  for a file over 1 MiB only, a NUL in its first 1 KiB passes it over
  (SURVEY.md:140, krep.c:3122-3141 and 3415-3419). Hidden files are
  searched (SURVEY.md:139 prunes hidden directories only);
- --gitignore (SURVEY.md:141, krep.c:3146-3294): each directory's
  .gitignore, read as a text file line by line (a line ends at '\\n' and
  nowhere else), gives (pattern, negated, dir_only) entries: leading blanks
  skipped, a '#' line a comment, a leading '!' negation, the line end and
  trailing blanks cut, a trailing '/' dir-only, a leading '/' cut. The
  levels chain from the root down; every entry that matches the basename
  (fnmatch) sets the verdict to "not negated", so a child overrides its
  parent and the last match wins; a dir-only entry never matches a file;
- every searched file prints `path:N`, N its lines that hold a match,
  N = 0 included; the exit code is 0 when some file matched, else 1
  (SURVEY.md:242-243, krep.c:3840-3850).

krep.c itself is not in this repository. Two readings above are this
module's where the sources are silent and the program reads otherwise:
a name that ends in ".min." is passed over here, and a '\\r' inside a
.gitignore line is part of its pattern here. Neither occurs in the
trees of recipes/linux_tree.py.

A walk error (a directory or file that cannot be read) is outside what the
reference models and raises NotImplementedError.

`drop_negations` is the control "gitignore_negation": every '!' line is
dropped, as a walker that did not know negation would drop it.
"""

from __future__ import annotations

import fnmatch
import os
import stat

import numpy as np

from . import scan

# krep.h:236-266, the skip lists as SURVEY.md:139 counts them
SKIP_DIRECTORIES = frozenset((
    ".git", "node_modules", ".svn", ".hg", "build", "dist",
    "__pycache__", ".pytest_cache", ".mypy_cache", ".venv", ".env",
    "venv", "env", "target", "bin", "obj",
))

SKIP_EXTENSIONS = frozenset((
    ".o", ".so", ".a", ".dll", ".exe", ".lib", ".dylib", ".class", ".pyc",
    ".pyo", ".obj", ".elf", ".wasm",
    ".zip", ".tar", ".gz", ".bz2", ".xz", ".rar", ".7z", ".jar", ".war",
    ".ear", ".iso", ".img", ".pkg", ".deb", ".rpm",
    ".jpg", ".jpeg", ".png", ".gif", ".bmp", ".tiff", ".webp", ".svg",
    ".ico", ".psd", ".ai",
    ".mp3", ".wav", ".ogg", ".flac", ".aac", ".m4a", ".mp4", ".avi", ".mkv",
    ".mov", ".wmv", ".flv",
    ".pdf", ".doc", ".docx", ".xls", ".xlsx", ".ppt", ".pptx", ".odt",
    ".ods", ".odp",
    ".dat", ".bin", ".bak", ".log", ".tmp", ".temp",
    ".swp", ".swo", ".ds_store",
    ".db", ".sqlite", ".mdb",
    ".ttf", ".otf", ".woff", ".woff2", ".eot",
))

SNIFF_BYTES = 1024        # the binary sniff reads this much ...
SNIFF_OVER = 1 << 20      # ... of files larger than this


def pruned_directory(name: str) -> bool:
    return name[:1] == "." or name in SKIP_DIRECTORIES


def passed_over_by_name(name: str) -> bool:
    """A ".min." asset, or a skipped extension (the text from the last dot,
    where that dot is not the name's first character)."""
    if ".min." in name:
        return True
    _, dot, ext = name[1:].rpartition(".")
    return bool(dot) and "." + ext.lower() in SKIP_EXTENSIONS


def binary(path: str, size: int) -> bool:
    if size <= SNIFF_OVER:
        return False
    with open(path, "rb") as f:
        return b"\0" in f.read(SNIFF_BYTES)


def gitignore_entries(directory: str, drop_negations: bool = False) -> list | None:
    """The (pattern, negated, dir_only) entries of directory/.gitignore, or
    None when it has none."""
    try:
        with open(os.path.join(directory, ".gitignore"), "rb") as f:
            lines = f.read().split(b"\n")
    except FileNotFoundError:
        return None
    entries = []
    for raw in lines:
        text = raw.decode("utf-8", "replace").lstrip(" \t")
        if text[:1] in ("", "#"):
            continue
        negated = text[0] == "!"
        if negated and drop_negations:
            continue
        pattern = text[negated:].rstrip(" \t\r")
        dir_only = pattern[-1:] == "/"
        pattern = pattern[:len(pattern) - dir_only]
        pattern = pattern[pattern[:1] == "/":]
        if pattern:
            entries.append((pattern, negated, dir_only))
    return entries


def ignored(chain: list[list], name: str, is_dir: bool) -> bool:
    """The chain's verdict on a basename: levels from the root down, each
    level's entries in file order, the last match wins."""
    verdict = False
    for entries in chain:
        for pattern, negated, dir_only in entries:
            if (is_dir or not dir_only) and fnmatch.fnmatchcase(name, pattern):
                verdict = not negated
    return verdict


def walk(root: str, use_gitignore: bool, drop_negations: bool = False):
    """(path, size) of every file that `krep -r` searches, in its order."""

    def listing(path: str) -> list:
        try:
            with os.scandir(path) as it:
                return list(it)
        except OSError as e:
            raise NotImplementedError(f"a walk error: {path}: {e}") from e

    def level(path: str, chain: list):
        entries = listing(path)
        if use_gitignore:
            own = gitignore_entries(path, drop_negations)
            chain = chain if own is None else chain + [own]
        for entry in entries:
            st = entry.stat(follow_symlinks=False)
            if stat.S_ISDIR(st.st_mode):
                if not pruned_directory(entry.name) and not ignored(chain, entry.name, True):
                    yield from level(entry.path, chain)
            elif stat.S_ISREG(st.st_mode):
                if (not passed_over_by_name(entry.name)
                        and not ignored(chain, entry.name, False)
                        and not binary(entry.path, st.st_size)):
                    yield entry.path, st.st_size

    yield from level(root, [])


def count_lines(data: bytes, patterns: list[bytes]) -> int:
    """Lines of `data` that hold a match of any pattern (a line ends at a
    newline or at the end). One pattern: find it, count its line, go on
    from the next line: fast where matches are rare. Several: the
    automaton of scan.count_lines."""
    if len(patterns) > 1:
        return scan.count_lines(np.frombuffer(data, np.uint8), patterns)
    (p,) = patterns
    n = 0
    at = data.find(p)
    while at >= 0:
        n += 1
        nl = data.find(b"\n", at + len(p))
        if nl < 0:
            break
        at = data.find(p, nl + 1)
    return n


def count_tree(root: str, patterns: list[bytes], use_gitignore: bool, out,
               drop_negations: bool = False) -> tuple[bool, int, int]:
    """`path:N` for every searched file into `out`; returns (some file
    matched, files searched, bytes searched)."""
    matched, files, searched = False, 0, 0
    for path, _ in walk(root, use_gitignore, drop_negations):
        with open(path, "rb") as f:
            data = f.read()
        n = count_lines(data, patterns)
        out.write(f"{path}:{n}\n".encode())
        matched |= n > 0
        files += 1
        searched += len(data)
    return matched, files, searched
