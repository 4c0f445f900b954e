"""Build and load the port's CUDA kernels.

The sources in `krep_tpu_torch/csrc/` compile with `nvcc`, one process per
`.cu` file, all started together, and link into one shared library with a
plain C interface, loaded with `ctypes`. The build happens at first use
(never at import), into `build/krep_tpu_torch/` beside the package (or
`$KREP_TORCH_BUILD_DIR`), keyed by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads at once. A `-r` walk
calls `library()` from its solo thread and its main thread at once: one
lock serialises the build and the load, and temporary files carry the
process and thread ids.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, to the build log
)

_lib: ctypes.CDLL | None = None
_LOCK = threading.RLock()


def build_dir() -> Path:
    env = os.environ.get("KREP_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parents[1] / "build" / "krep_tpu_torch"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile the kernels unless a library for these exact sources exists;
    returns its path. The ptxas report lands beside it as `.log`."""
    with _LOCK:
        return _build()


def _build() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = build_dir() / f"libkrep_tpu_torch_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}.{threading.get_ident()}"
    nvcc = _nvcc()
    procs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = out.with_name(f"{tag}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for obj, proc in procs:
        text, _ = proc.communicate()
        logs.append(text)
        if proc.returncode != 0:
            failed.append(f"{obj.name}: nvcc exit code {proc.returncode}\n{text}")
    if failed:
        for obj, _ in procs:
            obj.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_name(f"{tag}.so.tmp")
    objs = [str(obj) for obj, _ in procs]
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                          capture_output=True, text=True)
    for obj in objs:
        os.unlink(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed with exit code {proc.returncode}:\n{proc.stderr}")
    out.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    with _LOCK:
        if _lib is None:
            _lib = _load(build())
    return _lib


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.krep_scan_blocks.restype = i
    lib.krep_scan_blocks.argtypes = [
        vp, i, ctypes.c_char_p, i, i, i, i, i, i, i, vp, vp, vp, vp, vp,
    ]
    lib.krep_tail_words.restype = i
    lib.krep_tail_words.argtypes = []
    lib.krep_combine_blocks.restype = i
    lib.krep_combine_blocks.argtypes = [vp, i, vp, vp]
    lib.krep_scan_blocks_multi.restype = i
    lib.krep_scan_blocks_multi.argtypes = [vp, i, vp, i, i, i, i, i, i, vp, vp, vp, vp, vp]
    lib.krep_lines_blocks.restype = i
    lib.krep_lines_blocks.argtypes = [vp, vp, i, vp, vp, vp, vp]
    lib.krep_hamming_scan.restype = i
    ll = ctypes.c_longlong
    lib.krep_hamming_scan.argtypes = [
        vp, i, vp, vp, vp, i, i, ctypes.c_char_p, i, ll, i, ll, i, vp, vp, vp,
    ]
    lib.krep_byte_scan.restype = i
    lib.krep_byte_scan.argtypes = [vp, i, vp, i, i, i, i, i, vp, vp, vp, vp, vp]
    lib.krep_dfa_scan.restype = i
    lib.krep_dfa_scan.argtypes = [vp, ll, ll, i, i, i, vp, ll, vp, ctypes.c_uint, vp, vp, vp]
    lib.krep_dfa_resident_threads.restype = ll
    lib.krep_dfa_resident_threads.argtypes = [i, i, ll]
    return lib
