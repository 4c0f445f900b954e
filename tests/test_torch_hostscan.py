"""krep_tpu_torch.ops.hostscan's break-even calibration against
krep_tpu.ops.hostscan, on the CPU.

The calibration corpus is the reference's byte for byte; `calibrate()` on
the CPU writes the port's own record (breakeven-torch.json) and never the
JAX package's breakeven.json, which `threshold()` never reads either; the
env override and the clamp to BREAKEVEN_CAP; no card raises, with no move
to the CPU; and the daemon reads the record afresh for every request.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from krep_tpu.ops import hostscan as jhostscan
from krep_tpu_torch.ops import hostscan
from test_torch_daemon import request, start_daemon, stop_daemon

SMALL = dict(big_bytes=1 << 18, small_bytes=1 << 16)


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    """An empty KREP_TPU_CACHE_DIR, no env override, no cached threshold."""
    monkeypatch.setenv("KREP_TPU_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("KREP_TPU_HOST_BREAKEVEN", raising=False)
    monkeypatch.setattr(hostscan, "_threshold_cache", None)
    return tmp_path


def write_record(path, breakeven: int) -> None:
    path.write_text(json.dumps({"breakeven_bytes": breakeven}))


@pytest.mark.parametrize("size", [0, 1, 12_345, 1 << 16, 1 << 20])
def test_calib_corpus_matches_reference(size):
    got = hostscan._calib_corpus(size)
    assert got.dtype == np.uint8 and got.shape == (size,)
    assert got.tobytes() == jhostscan._calib_corpus(size).tobytes()


def test_calibrate_on_cpu_writes_its_own_record(cache_dir):
    rec = hostscan.calibrate(force=True, device="cpu", **SMALL)
    assert sorted(p.name for p in cache_dir.iterdir()) == ["breakeven-torch.json"]
    assert json.loads((cache_dir / "breakeven-torch.json").read_text()) == rec
    assert rec["platform"] == rec["device"] == "cpu"
    assert 1 << 20 <= rec["breakeven_bytes"] <= hostscan.BREAKEVEN_CAP
    assert rec["host_gbps"] > 0 and rec["device_gbps"] > 0 and rec["device_overhead_s"] >= 0
    t = hostscan.threshold()
    assert t == rec["breakeven_bytes"]
    assert hostscan.route_small(t) and not hostscan.route_small(t + 1)


def test_calibrate_reads_its_record_unless_forced(cache_dir, monkeypatch):
    write_record(cache_dir / "breakeven-torch.json", 5 << 20)

    def no_scan(*a, **k):
        raise AssertionError("a cached record must not be measured again")

    monkeypatch.setattr(hostscan, "scan_count", no_scan)
    assert hostscan.calibrate(device="cpu") == {"breakeven_bytes": 5 << 20}
    with pytest.raises(AssertionError, match="measured again"):
        hostscan.calibrate(force=True, device="cpu", **SMALL)


def test_calibrate_needs_the_card_it_asks_for(cache_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("KREP_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        hostscan.calibrate(force=True, **SMALL)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        hostscan.calibrate(force=True, device="cuda", **SMALL)
    assert list(cache_dir.iterdir()) == []


def test_jax_record_is_never_read(cache_dir):
    """The JAX package's breakeven.json in the same directory measures
    another device: the port keeps its default, then reads its own."""
    write_record(cache_dir / "breakeven.json", 12_345)
    assert jhostscan._cache_path() == str(cache_dir / "breakeven.json")
    assert hostscan._cache_path() == str(cache_dir / "breakeven-torch.json")
    assert hostscan.threshold() == hostscan.DEFAULT_BREAKEVEN
    write_record(cache_dir / "breakeven-torch.json", 3 << 20)
    hostscan._threshold_cache = None
    assert hostscan.threshold() == 3 << 20


@pytest.mark.parametrize("env,want", [
    ("777", 777), ("0", 0), ("-5", 0), ("junk", hostscan.DEFAULT_BREAKEVEN),
    (str(1 << 40), 1 << 40),
])
def test_env_overrides_the_record(cache_dir, monkeypatch, env, want):
    write_record(cache_dir / "breakeven-torch.json", 3 << 20)
    monkeypatch.setenv("KREP_TPU_HOST_BREAKEVEN", env)
    assert hostscan.threshold() == want


@pytest.mark.parametrize("value,want", [
    (1 << 40, hostscan.BREAKEVEN_CAP), (-1, 0), (2 << 20, 2 << 20),
])
def test_record_is_clamped(cache_dir, value, want):
    write_record(cache_dir / "breakeven-torch.json", value)
    assert hostscan.threshold() == want
    assert hostscan.threshold() == want  # cached


def test_daemon_rereads_the_record_per_request(cache_dir, tmp_path_factory):
    """The daemon resets the cached threshold for each request: a record
    rewritten between two requests moves the second to the device."""
    text = tmp_path_factory.mktemp("t") / "t.txt"
    text.write_bytes(b"the cat\nthe dog\n" * 64)
    sock = str(tmp_path_factory.mktemp("d") / "h.sock")
    env = {"KREP_TORCH_DEVICE": "cpu", "KREP_TPU_CACHE_DIR": str(cache_dir),
           "KREP_TPU_PROFILE": "1"}
    argv = ["-c", "the", str(text)]
    proc = start_daemon(sock)
    try:
        write_record(cache_dir / "breakeven-torch.json", 1 << 20)
        out1, err1, rc1 = request(sock, argv, env=env)
        write_record(cache_dir / "breakeven-torch.json", 0)
        out2, err2, rc2 = request(sock, argv, env=env)
    finally:
        stop_daemon(sock, proc)
    assert (out1, rc1) == (out2, rc2) == (f"{text}:128\n".encode(), 0)
    assert b"host route" in err1 and b"break-even 1048576" in err1
    assert b"host route" not in err2 and b"scan[host]" not in err2
