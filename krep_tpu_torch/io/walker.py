"""Recursive directory walker + filters (mirror of krep.c:3068-3445).

Port of krep_tpu/io/walker.py: the same walk, filters and ordered emit
queue; batches and solo files run on the explicit `device`.

Behavior pinned to the reference:
  - hidden directories and the skip list are pruned (krep.c:3071-3090);
    hidden *files* are not skipped
  - ~70 binary/asset extensions skipped case-insensitively, plus any file
    with ".min." in its name (krep.c:3092-3117, krep.h:247-266)
  - binary sniff (NUL in first 1KB) only for files > 1MB (krep.c:3415-3419)
  - symlinks are never followed (lstat semantics)
  - --gitignore: per-directory .gitignore parsed into (pattern, negated,
    dir_only), matched against the basename with fnmatch, child overrides
    parent (krep.c:3146-3294)
  - traversal is serial; -r -c prints file:N for every searched file,
    including N=0 (observed reference behavior)
  - errors: EACCES/ENOENT tolerated; other errors count toward exit code 2
"""

from __future__ import annotations

import fnmatch
import os
import stat as stat_mod
import sys

from ..params import SearchParams

SKIP_DIRECTORIES = {
    ".git", "node_modules", ".svn", ".hg", "build", "dist",
    "__pycache__", ".pytest_cache", ".mypy_cache", ".venv", ".env",
    "venv", "env", "target", "bin", "obj",
}

SKIP_EXTENSIONS = {
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
}

BINARY_CHECK_SIZE = 1024
BINARY_CHECK_THRESHOLD = 1024 * 1024


def should_skip_directory(name: str) -> bool:
    if name.startswith(".") and name not in (".", ".."):
        return True
    return name in SKIP_DIRECTORIES


def should_skip_extension(name: str) -> bool:
    dot = name.rfind(".")
    if dot <= 0 or dot == len(name) - 1:
        return False
    if ".min." in name:
        return True
    return name[dot:].lower() in SKIP_EXTENSIONS


def is_binary_file(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(BINARY_CHECK_SIZE)
    except OSError:
        return False
    return b"\0" in head


class Gitignore:
    """One directory level of .gitignore patterns, chained to the parent."""

    def __init__(self, parent: "Gitignore | None"):
        self.parent = parent
        self.entries: list[tuple[str, bool, bool]] = []  # (pattern, negated, dir_only)

    def add_line(self, line: str):
        line = line.lstrip(" \t")
        if not line or line.startswith("#"):
            return
        negated = line.startswith("!")
        if negated:
            line = line[1:]
        line = line.rstrip(" \t\r\n")
        if not line:
            return
        dir_only = line.endswith("/")
        if dir_only:
            line = line[:-1]
            if not line:
                return
        if line.startswith("/"):
            line = line[1:]
        self.entries.append((line, negated, dir_only))

    @classmethod
    def load(cls, directory: str, parent: "Gitignore | None"):
        path = os.path.join(directory, ".gitignore")
        try:
            with open(path, "r", errors="replace") as f:
                gi = cls(parent)
                for line in f:
                    gi.add_line(line)
                return gi
        except OSError:
            return None

    def is_ignored(self, name: str, is_dir: bool) -> bool:
        ignored = self.parent.is_ignored(name, is_dir) if self.parent else False
        for pattern, negated, dir_only in self.entries:
            if dir_only and not is_dir:
                continue
            if fnmatch.fnmatchcase(name, pattern):
                ignored = not negated
        return ignored


def iter_files(
    base_dir: str, use_gitignore: bool = False, _parent_gi: Gitignore | None = None
):
    """Yield (path, size) of files to search, and accumulate errors via the
    returned generator's .errors after exhaustion (use walk() for that)."""
    yield from _walk(base_dir, use_gitignore, _parent_gi, [0])


def _stderr_warn(err_acc):
    """The walk's default report: write the line now, count it if asked."""

    def warn(line: str, counted: bool) -> None:
        sys.stderr.write(line)
        err_acc[0] += counted

    return warn


def _open_dir(path, use_gitignore, parent_gi, warn):
    """One directory level: list entries + resolve the gitignore chain.
    Returns (entry_iterator, gitignore) or None when the level is skipped
    (reference error policy at krep.c:3317-3327)."""
    try:
        entries = list(os.scandir(path))
    except PermissionError:
        warn(f"krep: {path}: Permission denied\n", False)
        return None
    except FileNotFoundError:
        return None
    except OSError as e:
        warn(f"krep: {path}: {e.strerror}\n", True)
        return None
    gi = parent_gi
    if use_gitignore:
        local = Gitignore.load(path, parent_gi)
        if local is not None:
            gi = local
    return iter(entries), gi


def _walk(base_dir, use_gitignore, parent_gi, err_acc, warn=None):
    """Depth-first walk with an EXPLICIT frame stack (not Python recursion):
    the reference's C recursion (krep.c:3310-3445) survives kernel-deep
    trees, and a recursive generator here would die at the interpreter
    recursion limit (~1000 frames) long before PATH_MAX does. Each error
    line goes to warn(line, counted), by default written at once and
    counted in err_acc."""
    warn = warn or _stderr_warn(err_acc)
    frame = _open_dir(base_dir, use_gitignore, parent_gi, warn)
    if frame is None:
        return
    stack = [frame]
    while stack:
        it, gi = stack[-1]
        entry = next(it, None)
        if entry is None:
            stack.pop()
            continue
        name = entry.name
        try:
            st = entry.stat(follow_symlinks=False)
        except FileNotFoundError:
            continue
        except OSError as e:
            warn(f"krep: {entry.path}: {e.strerror}\n", True)
            continue
        if stat_mod.S_ISDIR(st.st_mode):
            if should_skip_directory(name):
                continue
            if gi is not None and gi.is_ignored(name, True):
                continue
            sub = _open_dir(entry.path, use_gitignore, gi, warn)
            if sub is not None:
                stack.append(sub)
        elif stat_mod.S_ISREG(st.st_mode):
            if should_skip_extension(name):
                continue
            if gi is not None and gi.is_ignored(name, False):
                continue
            if st.st_size > BINARY_CHECK_THRESHOLD and is_binary_file(entry.path):
                continue
            yield entry.path, st.st_size


def search_directory(
    params: SearchParams, base_dir: str, out, color: bool, threads=None, device=None
) -> int:
    """Search all eligible files under base_dir on `device` (see
    ops/dispatch.resolve_device); returns the process exit code (0 match /
    1 no match / 2 error), printing per-file results."""
    from ..engine.search import (
        PatternValidationError,
        search_string,
        validate_patterns,
    )
    from ..ops.dispatch import resolve_device
    from ..output import printer
    from . import batch as batch_mod
    from . import files

    device = resolve_device(device)

    use_gi = getattr(params, "use_gitignore", False)
    err_acc = [0]
    any_match = False
    state = {"any_match": False}

    # A bad pattern set fails identically for every file: the reference's
    # per-file validation inside search_file prints one error line per
    # walked file and counts it (krep.c:2298-2322 + 3423-3428)
    try:
        validate_patterns(params)
        invalid_core = None
    except PatternValidationError as e:
        invalid_core = e.core
    if invalid_core is not None:
        for path, _size in _walk(base_dir, use_gi, None, err_acc):
            sys.stderr.write(f"krep: {path}: {invalid_core}\n")
            err_acc[0] += 1
        if err_acc[0]:
            sys.stderr.write(
                f"krep: Encountered {err_acc[0]} errors during recursive search.\n"
            )
            return 2
        return 1

    def emit(path, data, result):
        state["any_match"] = state["any_match"] or result.matched
        if params.count_mode:
            printer.print_count(out, result.count, path)
        elif params.only_matching:
            printer.print_only_matching(
                out, data, result.positions, path, color, params.max_count
            )
        else:
            printer.print_matching_lines(out, data, result.positions, path, color)

    # Pipelined batches with an ORDERED EMIT QUEUE: work items (submitted
    # batches and solo-file results) queue in walk order and emit strictly
    # head-first, so output order stays byte-identical to walk order — but
    # a solo (non-batchable) file does not force a drain of the in-flight
    # batches. A solo's result simply waits in the queue behind the batches
    # submitted before it; batches drain lazily as the window advances. The
    # reference has per-file launches and no such interaction at all
    # (krep.c:3402-3430).
    WINDOW = 2
    SOLO_HELD_MAX = 256 << 20  # bound bytes parked behind pending batches
    building = batch_mod.Batch()
    # FIFO of ("batch", PendingBatch) | ("solo", path, data, future) |
    # ("error", line, counted)
    queue: list = []
    held_bytes = [0]
    # solo scans run on ONE worker thread so a large file's staging+scan
    # overlaps the walk of subsequent files (the reference's per-file model
    # stalls there, krep.c:3402-3430). One worker keeps device dispatch
    # ordered; results await at emit time so output and stderr stay in
    # exact walk order.
    solo_pool = [None]

    def solo_scan(data):
        try:
            return ("ok", search_string(params, data, threads, device=device))
        except NotImplementedError as e:
            return ("raise", e)
        except Exception as e:  # per-file errors don't abort -r
            return ("err", e)

    def warn(line: str, counted: bool) -> None:
        """A walk or read error's line. Behind queued work it waits for its
        turn, so stderr keeps walk order (the C binary's, krep.c:3402-3430)
        however long the scans queued before it take."""
        queue.append(("error", line, counted))
        emit_ready_solos()

    def emit_ready_solos(block=False):
        while queue and queue[0][0] != "batch":
            if queue[0][0] == "error":
                _, line, counted = queue.pop(0)
                sys.stderr.write(line)
                err_acc[0] += counted
                continue
            if not block and not queue[0][3].done():
                return  # keep walking; the scan is still in flight
            _, path, data, fut = queue.pop(0)
            held_bytes[0] -= len(data)
            kind, val = fut.result()
            if kind == "raise":
                raise val
            if kind == "err":
                sys.stderr.write(f"krep: {path}: {val}\n")
                err_acc[0] += 1
                continue
            emit(path, data, val)

    def drain_head_batch():
        if queue[0][0] != "batch":
            # an in-flight solo gates the window: its output must precede
            # the batches behind it, so block on the scan
            emit_ready_solos(block=True)
            if not queue or queue[0][0] != "batch":
                return
        _, p = queue.pop(0)
        for path, fdata, result in batch_mod.drain_batch(params, p):
            emit(path, fdata, result)
        emit_ready_solos()

    def pending_batches() -> int:
        return sum(1 for item in queue if item[0] == "batch")

    def submit_building():
        nonlocal building
        if not building.entries:
            return
        queue.append(("batch", batch_mod.submit_batch(params, building, device)))
        building = batch_mod.Batch()
        while pending_batches() > WINDOW:
            drain_head_batch()

    def drain_all():
        submit_building()
        while queue:
            if queue[0][0] != "batch":
                emit_ready_solos(block=True)
            else:
                drain_head_batch()

    # size-independent eligibility once per run, size check per file
    params_eligible = batch_mod.eligible_params(params)
    for path, size in _walk(base_dir, use_gi, None, err_acc, warn):
        if params_eligible and size <= batch_mod.BATCH_FILE_MAX:
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError as e:
                warn(f"krep: {path}: {e}\n", True)
                continue
            building.add(path, data)
            if building.full:
                submit_building()
            continue
        # solo file: the partially-built batch holds files walked BEFORE
        # this one, so submit it (order marker) — but don't drain anything
        submit_building()
        try:
            data = files.read_bytes(path)
        except OSError as e:
            warn(f"krep: {path}: {e}\n", True)
            continue
        if solo_pool[0] is None:
            import concurrent.futures as _cf

            solo_pool[0] = _cf.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="krep-solo"
            )
        queue.append(("solo", path, data, solo_pool[0].submit(solo_scan, data)))
        held_bytes[0] += len(data)
        emit_ready_solos()
        while held_bytes[0] > SOLO_HELD_MAX and queue and queue[0][0] == "batch":
            drain_head_batch()  # cap memory parked behind pending batches
    try:
        drain_all()
    finally:
        if solo_pool[0] is not None:
            solo_pool[0].shutdown(wait=False)
    out.flush()
    any_match = state["any_match"]
    if err_acc[0]:
        # summary line printed by the reference's main (krep.c:3841-3846)
        sys.stderr.write(
            f"krep: Encountered {err_acc[0]} errors during recursive search.\n"
        )
        return 2
    return 0 if any_match else 1
