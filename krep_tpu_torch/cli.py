"""krep-compatible CLI on the PyTorch port (twin of krep_tpu/cli.py:110-407).

Option parsing, usage text, -f reading and output formatting are shared
with krep_tpu.cli; only the engine differs. Differences from the original:
`-v` reports torch and the device instead of the jax backend, and paths
not ported yet (-r, -E) exit 2 with a message.

    python -m krep_tpu_torch [OPTIONS] PATTERN [FILE]
    python -m krep_tpu_torch [OPTIONS] -e P1 -e P2 ... [FILE]
    python -m krep_tpu_torch [OPTIONS] -f PATTERN_FILE [FILE]

The device is $KREP_TORCH_DEVICE, else "cuda".
Exit codes: 0 match / 1 no match / 2 error (krep.c:1181-1184).
"""

from __future__ import annotations

import os
import re
import sys

from krep_tpu import getoptlong
from krep_tpu.cli import (
    LONG_OPTS,
    MAX_PATTERNS,
    SHORT_OPTS,
    USAGE,
    _emit,
    _err,
    _fgets_patterns,
)
from krep_tpu.params import SearchParams

from . import __version__
from .ops.dispatch import resolve_device


def main(argv: list[str] | None = None, out=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out = out if out is not None else sys.stdout.buffer
    try:
        opts, args = getoptlong.getopt_long(argv, SHORT_OPTS, LONG_OPTS)
    except getoptlong.OptError as e:
        # getopt's error to stderr, the usage block to STDOUT, exit 2
        # (krep.c:3695-3698)
        sys.stderr.write(f"krep: {e}\n")
        out.write(USAGE.encode())
        out.flush()
        return 2

    patterns: list[bytes] = []
    case_sensitive = True
    use_regex = False
    whole_word = False
    count_mode = False
    only_matching = False
    max_count = None
    recursive = False
    string_mode = False
    algo = None
    no_simd = False
    color_mode = "auto"
    threads = None
    use_gitignore = False

    for o, a in opts:
        if o == "-i":
            case_sensitive = False
        elif o in ("-e", "--regexp"):
            if len(patterns) >= MAX_PATTERNS:  # krep.c:3652-3657
                sys.stderr.write(
                    f"krep: Error: Too many patterns specified (max {MAX_PATTERNS})\n"
                )
                return 2
            patterns.append(a.encode())
        elif o == "-f":
            if a == "-":
                _fgets_patterns(sys.stdin.buffer.read(), patterns)
            else:
                try:
                    with open(a, "rb") as f:
                        data = f.read()
                except OSError:
                    sys.stderr.write(
                        f"krep: Error: Cannot open pattern file: {a}\n"
                    )
                    return 2
                _fgets_patterns(data, patterns)
            if not patterns:
                # checked when -f is PROCESSED (krep.c:3619-3625)
                sys.stderr.write(
                    "krep: Error: No patterns found in "
                    f"{'stdin' if a == '-' else a}\n"
                )
                return 2
        elif o == "-c":
            count_mode = True
        elif o in ("-m", "--max-count"):
            # strtol semantics (krep.c:3511-3520): garbage values WARN and
            # are ignored
            ok = re.fullmatch(r"[ \t\n\r\f\v]*[+-]?[0-9]+", a)
            v = int(a) if ok else None
            if v is None or not (0 <= v <= (1 << 63) - 1):
                print(
                    f"krep: Warning: Invalid number for max-count '{a}'",
                    file=sys.stderr,
                )
            else:
                max_count = v
        elif o == "-o":
            only_matching = True
        elif o == "-E":
            use_regex = True
        elif o in ("-F", "--fixed-strings"):
            use_regex = False
        elif o == "-r":
            recursive = True
        elif o == "-t":
            try:
                threads = int(a)
                if threads <= 0:
                    raise ValueError
            except ValueError:
                # the reference warns and uses the default (krep.c:3522-3529)
                sys.stderr.write(
                    f"krep: Warning: Invalid thread count '{a}', using default.\n"
                )
                threads = None
        elif o == "-s":
            if len(patterns) >= MAX_PATTERNS:
                sys.stderr.write("krep: Error: Too many patterns specified.\n")
                return 2
            patterns.append(a.encode())
            string_mode = True
        elif o == "-w":
            whole_word = True
        elif o in ("-v", "--version"):
            import torch

            try:
                dev = resolve_device(device)
            except (RuntimeError, ValueError) as e:
                return _err(str(e))
            name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
            out.write(
                f"krep-tpu v{__version__}\n"
                f"backend: torch {torch.__version__} on {dev} ({name})\n".encode()
            )
            out.flush()
            return 0
        elif o in ("-h", "--help"):
            out.write(USAGE.encode())
            out.flush()
            return 0
        elif o == "--color":
            # bare --color means AUTO (krep.c:3661-3663)
            color_mode = a if a is not None else "auto"
            if color_mode not in ("auto", "always", "never"):
                sys.stderr.write(
                    f"krep: Error: Invalid argument for --color: {color_mode}\n"
                )
                out.write(USAGE.encode())
                out.flush()
                return 2
        elif o == "--no-simd":
            no_simd = True
        elif o == "--gitignore":
            use_gitignore = True
        elif o == "--algo":
            if a not in ("auto", "bm", "kmp"):  # krep.c:3685-3697
                sys.stderr.write(
                    f"krep: Error: Unknown algorithm '{a}'. "
                    "Valid options: auto, bm, kmp\n"
                )
                return 2
            algo = a

    # --- pattern / target resolution (krep.c:3700-3810) ---
    if not patterns:
        if not args:
            sys.stderr.write("krep: Error: PATTERN argument missing.\n")
            out.write(USAGE.encode())
            out.flush()
            return 2
        patterns.append(args.pop(0).encode())

    if string_mode:
        if recursive:
            sys.stderr.write(
                "krep: Error: Options -s (search string) and -r (recursive) "
                "cannot be used together.\n"
            )
            out.write(USAGE.encode())
            out.flush()
            return 2
        if not args:
            sys.stderr.write(
                "krep: Error: STRING_TO_SEARCH argument missing for -s.\n"
            )
            out.write(USAGE.encode())
            out.flush()
            return 2
        haystack = args[0].encode()
        extra = args[1:]
        target = None
    else:
        target = args[0] if args else None
        extra = args[1:]
    if extra:
        sys.stderr.write(f"krep: Error: Extra arguments provided ('{extra[0]}'...). \n")
        out.write(USAGE.encode())
        out.flush()
        return 2

    color = color_mode == "always" or (
        color_mode == "auto" and sys.stdout.isatty()
    )

    try:
        params = SearchParams(
            patterns=tuple(patterns),
            case_sensitive=case_sensitive,
            use_regex=use_regex,
            whole_word=whole_word,
            only_matching=only_matching,
            count_mode=count_mode,
            max_count=max_count,
            algo_override=algo,
            no_simd=no_simd,
            use_gitignore=use_gitignore,
        )
    except ValueError as e:  # too many patterns / pattern too long
        return _err(str(e))

    from krep_tpu.engine.search import (
        PatternValidationError,
        SearchResult,
        validate_patterns,
    )

    from .engine.search import search_string

    try:
        device = resolve_device(device)
    except (RuntimeError, ValueError) as e:  # no such device: exit 2, no fallback
        return _err(str(e))

    try:
        if string_mode:
            # search_string prints positions in AC emission order, unsorted
            result = search_string(
                params.with_(sorted_positions=False), haystack, threads,
                device=device,
            )
            _emit(out, result, haystack, None, params, color)
        elif recursive and target is not None:
            if not os.path.isdir(target):
                return _err(f"{target}: Is not a directory (required for -r)")
            raise NotImplementedError(
                "recursive search (-r) not ported to krep_tpu_torch yet"
            )
        elif target is not None and target != "-":
            if os.path.isdir(target):
                return _err(
                    f"{target}: Is a directory (use -r to search directories)"
                )
            # validation precedes any I/O (krep.c:2298-2322)
            validate_patterns(params, target)
            from krep_tpu.io import files

            try:
                data = files.read_bytes(target)
            except OSError as e:
                return _err(f"{target}: {e.strerror or e}")
            result = search_string(
                params,
                bytes(data) if not hasattr(data, "shape") else data,
                threads,
                target=target,
                device=device,
            )
            if len(data) == 0 and not use_regex and len(patterns) == 1 and len(patterns[0]) == 0:
                # empty pattern matches an empty FILE once (krep.c:2419-2513)
                import numpy as _np

                result = SearchResult(1, _np.array([[0, 0]], dtype=_np.int64), 0)
            if len(data) == 0 and result.count == 1 and params.only_matching and not params.count_mode:
                # the reference prints "file::" here, not "file:1:"
                out.write(f"{target}::\n".encode())
            else:
                _emit(out, result, data, target, params, color)
        else:
            # stdin is target "-": validate before consuming the pipe
            validate_patterns(params, "-")
            data = sys.stdin.buffer.read()
            # stdin text_len is strlen(text) (krep.c:2025): truncate at NUL
            nul = data.find(b"\0")
            if nul != -1:
                data = data[:nul]
            result = search_string(
                params.with_(sorted_positions=False), data, threads,
                target="-", device=device,
            )
            _emit(out, result, data, None, params, color)
    except PatternValidationError as e:
        sys.stderr.write(e.message + "\n")
        return 2
    except NotImplementedError as e:
        return _err(str(e))
    except BrokenPipeError:
        # downstream closed (e.g. `| head`): 128 + SIGPIPE, like the reference
        return 141

    out.flush()
    return 0 if result.matched else 1


if __name__ == "__main__":
    sys.exit(main())
