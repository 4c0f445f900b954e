"""tools/soak_fuzz_torch.py on the CPU: every batch clean at a fixed seed
(the port's plain versions against krep_tpu), a planted mismatch caught
with a repro, each side's knobs restored, and the reference stopped (exit
2, no mismatch) when it leaves its native route for jax.

On a card the soak runs the CUDA kernels: tests/test_torch_cuda.py
(`test_soak_on_the_card`) and chip_smoke.py's phase 6s.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("soak_fuzz_torch", REPO / "tools" / "soak_fuzz_torch.py")
soak = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(soak)

BATCHES = {fn.__name__: fn for fn, _ in soak.ROUND}


@pytest.mark.parametrize("name", list(BATCHES))
def test_batch_clean_on_cpu(name):
    env = dict(os.environ)
    kw = {"lo": 200_000, "hi": 300_000} if name == "large_batch" else {}
    with soak.Soak("cpu") as s:
        BATCHES[name](s, 20_000 + len(name), 1 if name == "large_batch" else 3, **kw)
    assert sum(s.cases.values()) >= 3
    assert dict(os.environ) == env  # each side's knobs restored


def test_planted_mismatch_gives_a_repro(monkeypatch, capsys):
    real = soak.tcli.main

    def flipped(argv, out, device=None):
        rc = real(argv, out=out, device=device)
        data = bytearray(out.getvalue())
        if data:
            data[0] ^= 1
            out.seek(0)
            out.truncate()
            out.write(bytes(data))
        return rc

    monkeypatch.setattr(soak.tcli, "main", flipped)
    monkeypatch.setattr(soak, "ROUND", [(soak.literal_batch, 20)])
    assert soak.main(["--seconds", "5", "--seed-base", "7", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "MISMATCH batch=literal seed=7" in out
    assert "args:" in out and "port: device=cpu KREP_TPU_HOST_BREAKEVEN=0" in out
    assert "stdout differs at byte 0" in out
    kept = out.split("kept: ")[1].split()[0]
    assert (Path(kept) / "text").exists()


def test_a_cli_that_raises_is_a_mismatch(monkeypatch):
    def broken(argv, out, device=None):
        raise RuntimeError("planted launch failure")

    monkeypatch.setattr(soak.tcli, "main", broken)
    with soak.Soak("cpu") as s, pytest.raises(soak.Mismatch, match="planted launch failure"):
        soak.literal_batch(s, 3, 1)


LEAVE = r"""
import sys
sys.argv = ["soak"]
import importlib.util
spec = importlib.util.spec_from_file_location("s", "tools/soak_fuzz_torch.py")
s = importlib.util.module_from_spec(spec)
spec.loader.exec_module(s)
assert "jax" not in sys.modules
sys.meta_path.insert(0, s._GUARD)
s.REFERENCE_KNOBS = {"KREP_TPU_HOST_BREAKEVEN": "0"}  # krep_tpu's device route: jax
s.ROUND = [(s.manypat_batch, 1)]
sys.exit(s.main(["--seconds", "1", "--seed-base", "3", "--device", "cpu"]))
"""


def test_reference_leaving_its_native_route_stops_the_soak():
    env = {k: v for k, v in os.environ.items() if not k.startswith("KREP_TPU_")}
    proc = subprocess.run([sys.executable, "-c", LEAVE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "the reference left its native host route" in proc.stdout
    assert "MISMATCH" not in proc.stdout
