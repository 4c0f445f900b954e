"""Build the port's native client (client.c) for its resident engine.

`build_client()` compiles client.c with the system compiler into
`ops/_build.build_dir()` (`build/krep_tpu_torch/` beside the package, or
$KREP_TORCH_BUILD_DIR), content-addressed by a hash of the source and of
what it bakes in: the repository root (the PYTHONPATH of a spawned daemon
and of the fallback CLI) and the Python that runs them (`sys.executable`),
so an edit or another interpreter builds a new binary and an unchanged one
is reused at once. The binary is the port's own: never `bin/krep-tpu`,
never built from the JAX package's client.c.

    python -c "from krep_tpu_torch.native import client; print(client.build_client())"
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from ..ops._build import build_dir

SRC = Path(__file__).resolve().parent / "client.c"
ROOT = SRC.parents[2]


def build_client() -> Path:
    """The client binary for this source, root and Python (built on the
    first call); raises when there is no C compiler or the build fails."""
    root, python = str(ROOT), sys.executable
    h = hashlib.sha256(SRC.read_bytes())
    h.update(f"\0{root}\0{python}".encode())
    out = build_dir() / f"krep-tpu-torch-client-{h.hexdigest()[:16]}"
    if out.exists():
        return out
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("no C compiler (cc) to build the client")
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as td:
        tmp = os.path.join(td, "client")
        proc = subprocess.run(
            [cc, "-O2", "-Wall", f"-DKREP_TPU_ROOT={_c_string(root)}",
             f"-DKREP_TPU_PYTHON_DEFAULT={_c_string(python)}", "-o", tmp, str(SRC)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"building the client failed:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def _c_string(s: str) -> str:
    """`s` as a C string literal for a -D definition."""
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


if __name__ == "__main__":
    print(build_client())
