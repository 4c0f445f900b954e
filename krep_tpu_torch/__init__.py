"""krep_tpu_torch: krep-tpu on PyTorch and CUDA (NVIDIA Hopper).

The port of the `krep_tpu` JAX package, slice by slice; `krep_tpu` stays
the reference it is held against. It runs the single-literal path
(`krep -c PAT FILE`, `krep -o PAT FILE`, `krep PAT FILE`), multi-pattern
search (`-e P1 -e P2 ...`, `-f FILE`; the dense DFA under KREP_TPU_DFA=1),
recursive search (`-r`, `--gitignore`) and POSIX ERE (`-E`, glibc behind
a literal-factor prefilter) through hand-written CUDA kernels (csrc/). It imports
nothing of `krep_tpu`: the host modules it needs (params, getoptlong,
select, resolve, hostscan's host half, printer, files, the native runtime,
profiling) are its own copies, under the same relative paths.

Public API (mirrors krep_tpu/__init__.py):
    search_string(params, text, device=...) -> SearchResult
    search_file(params, path, device=...)   -> SearchResult
`device` defaults to $KREP_TORCH_DEVICE, else "cuda".

The names load on first use, so that `python -m krep_tpu_torch.daemon`
imports torch only in the daemon, after it has forked.
"""

import importlib

__version__ = "0.1.0"

_LAZY = {
    "SearchParams": ".params",
    "search_string": ".engine.search",
    "search_file": ".engine.search",
    "SearchResult": ".engine.search",
}


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "SearchParams",
    "search_string",
    "search_file",
    "SearchResult",
    "__version__",
]
