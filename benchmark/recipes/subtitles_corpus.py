"""One file of English-word lines: the bench twin's corpus recipe, frozen.

A copy of krep_tpu_torch/tools/bench.py's `_recipe` (its `gen_corpus`,
after bench.py:38-60) with corpus.c beside it: lines of 3 to 8 words drawn
from WORDS, joined by spaces, each ended by a newline, whole lines until
at least `bytes`, cut at `bytes`. The twin draws with seed 12345; here the
seed is the run's. corpus.c replays numpy's PCG64 draws from the raw
outputs, so the bytes are numpy's own at about 6 s a GiB.

    make(dest, {"bytes": N}, seed) -> {"corpus": path}
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

WORDS = (
    b"the quick brown fox jumps over a lazy dog and then some more words "
    b"it was time for Sherlock to breathe deeply in the theatre"
).split()
SOURCE = Path(__file__).resolve().with_name("corpus.c")
BUILD = Path(__file__).resolve().parents[1] / "data" / "build"

_lib = None


def _library() -> ctypes.CDLL:
    """corpus.c, built with the system compiler into data/build (named by
    a hash of the source) at first use."""
    global _lib
    if _lib is None:
        tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        path = BUILD / f"corpus_{tag}.so"
        if not path.exists():
            cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
            if cc is None:
                raise RuntimeError("no C compiler (cc) to build corpus.c")
            BUILD.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD) as td:
                tmp = os.path.join(td, "corpus.so")
                subprocess.run([cc, "-O2", "-shared", "-fPIC", str(SOURCE), "-o", tmp],
                               check=True, capture_output=True)
                os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.krep_corpus_lines.restype = ctypes.c_int64
        lib.krep_corpus_lines.argtypes = [
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"), ctypes.c_int64, i64p,
            u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, u8p, ctypes.c_int64]
        _lib = lib
    return _lib


def _lines(raw: np.ndarray, state: np.ndarray, cap: int) -> np.ndarray:
    """corpus.c's lines from the raw PCG64 outputs `raw` and the draw state
    `state` = [next output, output whose high word waits or -1] (updated):
    whole lines until at least `cap` bytes, or fewer when `raw` runs out."""
    lens = np.array([len(w) for w in WORDS], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    out = np.empty(cap + 256, np.uint8)  # room for the line that crosses cap
    n = _library().krep_corpus_lines(
        np.ascontiguousarray(raw, np.uint64), raw.shape[0], state,
        np.frombuffer(b"".join(WORDS), np.uint8), offs, lens, len(WORDS), 0, out, cap)
    return out[:n]


def corpus(size: int, seed: int) -> np.ndarray:
    """The recipe's first `size` bytes for `seed`."""
    bitgen = np.random.default_rng(seed).bit_generator
    out = np.empty(size, np.uint8)
    raw = np.zeros(0, np.uint64)
    state = np.array([0, -1], np.int64)
    written = 0
    while written < size:
        keep = int(state[0] if state[1] < 0 else state[1])  # the first output still unread
        raw = np.concatenate([raw[keep:], bitgen.random_raw(1 << 22)])
        state -= np.where(state >= 0, keep, 0)
        part = _lines(raw, state, size - written)
        take = min(part.shape[0], size - written)
        out[written : written + take] = part[:take]
        written += take
    return out


def make(dest: str, params: dict, seed: int) -> dict:
    path = os.path.join(dest, "corpus.txt")
    data = corpus(int(params["bytes"]), seed)
    with open(path, "wb") as f:
        data.tofile(f)
        f.flush()
        os.fsync(f.fileno())  # written back now, not during the window
    return {"corpus": path}
