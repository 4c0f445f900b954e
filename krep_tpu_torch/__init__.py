"""krep_tpu_torch: krep-tpu on PyTorch and CUDA (NVIDIA Hopper).

The port of the `krep_tpu` JAX package, slice by slice; `krep_tpu` stays
the reference it is held against. It runs the single-literal path
(`krep -c PAT FILE`, `krep -o PAT FILE`, `krep PAT FILE`) and multi-pattern
search (`-e P1 -e P2 ...`, `-f FILE`) through hand-written CUDA kernels
(csrc/). Host modules that never import jax (params, select, resolve,
printer, native runtime) are shared with `krep_tpu`.

Public API (mirrors krep_tpu/__init__.py):
    search_string(params, text, device=...) -> SearchResult
    search_file(params, path, device=...)   -> SearchResult
`device` defaults to $KREP_TORCH_DEVICE, else "cuda".
"""

from krep_tpu.engine.search import SearchResult
from krep_tpu.params import SearchParams

from .engine.search import search_file, search_string

__version__ = "0.1.0"

__all__ = [
    "SearchParams",
    "search_string",
    "search_file",
    "SearchResult",
    "__version__",
]
