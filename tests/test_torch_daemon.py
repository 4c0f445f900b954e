"""krep_tpu_torch's resident engine (daemon.py, native/client.c) against
krep_tpu.cli, on the CPU.

tests/test_daemon.py's six cases run against the port's daemon, started
with KREP_TORCH_DEVICE=cpu (its plain PyTorch versions): in-process parity,
stdin and cwd, error paths, per-request env, stop, and the native client
end to end. Each request's stdout, stderr and exit code are held byte for
byte to krep_tpu.cli run in this process under the same KREP_TPU_* env
(the daemon applies a request's env in place of its own). Also: the two
packages' default sockets differ, a CUDA fault ends the daemon, and the
daemon module imports no torch before it forks.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import shutil
import socket
import struct
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest

import naive
from krep_tpu import cli as jcli
from krep_tpu import daemon as jd
from krep_tpu_torch import daemon as td
from krep_tpu_torch.native import client as tclient

REPO = Path(__file__).resolve().parents[1]
CPU = {"KREP_TORCH_DEVICE": "cpu"}
HOST_ON = {**CPU, "KREP_TPU_HOST_BREAKEVEN": str(32 << 20)}
# the device route: the port's plain versions, krep_tpu's XLA scan
DEVICE = {**CPU, "KREP_TPU_HOST_BREAKEVEN": "0", "KREP_TPU_BACKEND": "xla"}
ENGINE_ENV = ("KREP_TPU_", "KREP_TORCH_")

pytestmark = pytest.mark.skipif(
    not hasattr(socket, "send_fds"), reason="needs socket.send_fds (3.9+)"
)


def start_daemon(sock: str) -> subprocess.Popen:
    """`python -m krep_tpu_torch.daemon --foreground` on the CPU, up and
    listening at `sock`."""
    env = dict(os.environ, **CPU)
    proc = subprocess.Popen(
        [sys.executable, "-m", "krep_tpu_torch.daemon", "--foreground",
         "--sock", sock, "--idle", "120"],
        cwd=REPO, env=env, stderr=subprocess.PIPE,
    )
    deadline = time.time() + 60
    while not os.path.exists(sock):
        if proc.poll() is not None:
            raise RuntimeError(proc.stderr.read().decode())
        if time.time() > deadline:
            proc.kill()
            raise TimeoutError("daemon did not come up")
        time.sleep(0.05)
    return proc


def stop_daemon(sock: str, proc: subprocess.Popen) -> None:
    td.stop(sock)
    try:
        proc.wait(timeout=15)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=15)


@pytest.fixture(scope="module")
def live_daemon(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("tdaemon") / "d.sock")
    proc = start_daemon(sock)
    yield sock
    stop_daemon(sock, proc)


def request(sock_path, argv, cwd=None, stdin=b"", env=None):
    """Python twin of native/client.c: send argv+cwd+env with the three
    fds over SCM_RIGHTS, return (stdout, stderr, rc)."""
    r_in, w_in = os.pipe()
    r_out, w_out = os.pipe()
    r_err, w_err = os.pipe()
    os.write(w_in, stdin)
    os.close(w_in)

    payload = struct.pack("<I", len(argv))
    payload += (cwd or os.getcwd()).encode() + b"\x00"
    for a in argv:
        payload += a.encode() + b"\x00"
    items = sorted((CPU if env is None else env).items())
    payload += struct.pack("<I", len(items))
    for k, v in items:
        payload += f"{k}={v}".encode() + b"\x00"
    hdr = td.MAGIC_REQ + struct.pack("<IQ", td.VERSION, len(payload))

    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(sock_path)
    socket.send_fds(s, [hdr], [r_in, w_out, w_err])
    os.close(r_in), os.close(w_out), os.close(w_err)
    s.sendall(payload)

    # daemon holds the only write ends now; read to EOF then collect rc
    with os.fdopen(r_out, "rb") as f:
        out = f.read()
    with os.fdopen(r_err, "rb") as f:
        err = f.read()
    resp = b""
    while len(resp) < 8:
        b = s.recv(8 - len(resp))
        if not b:
            break
        resp += b
    s.close()
    assert resp[:4] == td.MAGIC_RESP, resp
    (rc,) = struct.unpack("<i", resp[4:8])
    return out, err, rc


def reference(argv, env, monkeypatch, stdin=None, cwd=None):
    """krep_tpu.cli in this process with exactly `env`'s engine knobs, as
    the daemon runs a request: (stdout, stderr, rc)."""
    with monkeypatch.context() as m:
        for k in [k for k in os.environ if k.startswith(ENGINE_ENV)]:
            m.delenv(k)
        for k, v in env.items():
            m.setenv(k, v)
        if cwd is not None:
            m.chdir(cwd)
        if stdin is not None:
            m.setattr(sys, "stdin", types.SimpleNamespace(buffer=io.BytesIO(stdin)))
        out, err = io.BytesIO(), io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = jcli.main(list(argv), out=out)
    return out.getvalue(), err.getvalue().encode(), rc


@pytest.fixture(scope="module")
def english(tmp_path_factory):
    p = tmp_path_factory.mktemp("ttext") / "t.txt"
    p.write_bytes(naive.gen_english(17, 20_000))
    return p


PARITY = [
    ("host", ["-c", "the"]),
    ("host", ["the"]),
    ("host", ["-o", "-i", "THE"]),
    ("host", ["-w", "-c", "the"]),
    ("host", ["-e", "the", "-e", "fox", "-c"]),
    ("host", ["--color=always", "the"]),
    ("host", ["-c", "zzzz"]),
    ("host", ["-r", "-c", "the"]),
    ("device", ["-c", "the"]),
    ("device", ["-o", "-i", "THE"]),
    ("device", ["-e", "the", "-e", "fox", "-c"]),
]


@pytest.mark.parametrize("route,args", PARITY, ids=lambda v: v if isinstance(v, str) else " ".join(v))
def test_daemon_matches_krep_tpu(live_daemon, english, route, args, monkeypatch):
    """"host": the native host route in both; "device": the port's plain
    versions in its daemon against krep_tpu's XLA scan."""
    env = HOST_ON if route == "host" else DEVICE
    target = str(english.parent if "-r" in args else english)
    argv = [*args, target]
    got = request(live_daemon, argv, env=env)
    assert got == reference(argv, env, monkeypatch)
    assert got[2] in (0, 1)


def test_daemon_stdin_and_cwd(live_daemon, tmp_path, monkeypatch):
    text = b"the cat\nthe dog\nno match here\n"
    want = reference(["-c", "the"], HOST_ON, monkeypatch, stdin=text)
    assert request(live_daemon, ["-c", "the"], stdin=text, env=HOST_ON) == want
    assert want[0] == b"2\n"
    # relative path resolves against the CLIENT's cwd
    (tmp_path / "rel.txt").write_bytes(text)
    argv = ["-c", "the", "rel.txt"]
    got = request(live_daemon, argv, cwd=str(tmp_path), env=HOST_ON)
    assert got == reference(argv, HOST_ON, monkeypatch, cwd=tmp_path)
    assert got == (b"rel.txt:2\n", b"", 0)


def test_daemon_error_paths(live_daemon, tmp_path, monkeypatch):
    # bad option: stderr + usage on stdout + rc 2, same as in-process
    argv = ["--frobnicate", "x", "f"]
    got = request(live_daemon, argv)
    assert got == reference(argv, CPU, monkeypatch)
    assert got[2] == 2 and b"unrecognized option" in got[1]
    # missing file
    argv = ["-c", "x", str(tmp_path / "nope.txt")]
    got = request(live_daemon, argv, env=HOST_ON)
    assert got == reference(argv, HOST_ON, monkeypatch)
    assert got[2] == 2
    # a compile error of -E
    argv = ["-E", "-c", "[bad", str(tmp_path / "nope.txt")]
    assert request(live_daemon, argv, env=HOST_ON) == reference(argv, HOST_ON, monkeypatch)


def _no_wall_times(err: bytes) -> bytes:
    """KREP_TPU_PROFILE's spans with their measured times taken out."""
    return re.sub(rb"in [0-9.]+ ms \([0-9.]+ GB/s wall\)", b"in T", err)


def test_daemon_env_is_per_request(live_daemon, tmp_path, monkeypatch):
    p = tmp_path / "t.txt"
    p.write_bytes(b"aaa bbb aaa\n")
    argv = ["-c", "aaa", str(p)]
    # PROFILE=1 logs the routing decision to the client's stderr only for
    # the request that asked for it
    env1 = {**HOST_ON, "KREP_TPU_PROFILE": "1"}
    out1, err1, rc1 = request(live_daemon, argv, env=env1)
    rout, rerr, rrc = reference(argv, env1, monkeypatch)
    assert (out1, _no_wall_times(err1), rc1) == (rout, _no_wall_times(rerr), rrc)
    assert b"host route" in err1
    got2 = request(live_daemon, argv, env=HOST_ON)
    assert got2 == reference(argv, HOST_ON, monkeypatch)
    assert b"host route" not in got2[1]
    # the device comes from the request: one without KREP_TORCH_DEVICE asks
    # for the card, which this machine lacks (exit 2, no move to the CPU)
    env3 = {"KREP_TPU_HOST_BREAKEVEN": str(32 << 20)}
    out3, err3, rc3 = request(live_daemon, argv, env=env3)
    assert (out3, rc3) == (b"", 2) and b"CUDA device requested" in err3


def test_daemon_stop(tmp_path):
    sock = str(tmp_path / "s.sock")
    proc = start_daemon(sock)
    assert td.stop(sock) == 0
    proc.wait(timeout=15)
    assert proc.returncode == 0
    assert not os.path.exists(sock)


def test_native_client_end_to_end(live_daemon, english, monkeypatch):
    """Through the port's C client, built by build_client(). With
    autospawn off and KREP_TPU_PYTHON=/bin/false, a call that missed the
    daemon would exec /bin/false and fail."""
    if shutil.which("cc") is None and not os.environ.get("CC"):
        pytest.skip("no C compiler to build the client")
    client = str(tclient.build_client())
    env = {k: v for k, v in os.environ.items() if not k.startswith(ENGINE_ENV)}
    env.update(HOST_ON, KREP_TPU_DAEMON_SOCK=live_daemon, KREP_TPU_DAEMON_AUTOSPAWN="0",
               KREP_TPU_PYTHON="/bin/false")
    knobs = {k: v for k, v in env.items() if k.startswith(ENGINE_ENV)}
    for argv in (["-c", "the"], ["-o", "the"], ["-i", "-w", "THE"], ["-c", "zzzz"]):
        argv = [*argv, str(english)]
        r = subprocess.run([client, *argv], env=env, capture_output=True, timeout=120)
        assert (r.stdout, r.stderr, r.returncode) == reference(argv, knobs, monkeypatch), argv


def test_default_sockets_differ(tmp_path, monkeypatch):
    """Under one KREP_TPU_CACHE_DIR the port's daemon and the JAX
    package's listen on different sockets, and the port's client finds the
    port's daemon there with no KREP_TPU_DAEMON_SOCK."""
    monkeypatch.delenv("KREP_TPU_DAEMON_SOCK", raising=False)
    monkeypatch.setenv("KREP_TPU_CACHE_DIR", str(tmp_path))
    ours, theirs = td.default_sock_path(), jd.default_sock_path()
    assert ours != theirs
    assert os.path.dirname(ours) == os.path.dirname(theirs) == str(tmp_path)
    assert os.path.basename(ours) == f"torch-daemon-{os.getuid()}.sock"
    if shutil.which("cc") is None and not os.environ.get("CC"):
        return
    proc = start_daemon(ours)
    try:
        env = {k: v for k, v in os.environ.items() if not k.startswith(ENGINE_ENV)}
        env.update(CPU, KREP_TPU_CACHE_DIR=str(tmp_path), KREP_TPU_DAEMON_AUTOSPAWN="0",
                   KREP_TPU_PYTHON="/bin/false")
        r = subprocess.run([str(tclient.build_client()), "-c", "-s", "a", "banana"],
                           env=env, capture_output=True, timeout=120)
        assert (r.stdout, r.returncode) == (b"1\n", 0), r.stderr
    finally:
        stop_daemon(ours, proc)


def test_cuda_fault_ends_the_daemon(tmp_path, monkeypatch):
    """A request after which the CUDA context reports an error is answered
    rc 2 with the error on the client's stderr; the daemon then leaves its
    accept loop and removes its socket. An ordinary failure before it
    (rc 2) leaves the daemon serving."""
    sock = str(tmp_path / "f.sock")
    faults = []
    monkeypatch.setattr(td, "_cuda_fault", lambda: faults.pop() if faults else None)
    result = {}
    server = threading.Thread(target=lambda: result.update(rc=td.serve(sock, 60)))
    server.start()
    try:
        deadline = time.time() + 30
        while not os.path.exists(sock):
            assert time.time() < deadline and server.is_alive()
            time.sleep(0.02)
        out, err, rc = request(sock, ["--frobnicate"], cwd=str(tmp_path))
        assert rc == 2 and b"unrecognized option" in err
        faults.append("CUDA error: an illegal memory access was encountered")
        out, err, rc = request(sock, ["-c", "-s", "a", "banana"], cwd=str(tmp_path))
        assert out == b"1\n" and rc == 2
        assert err == (b"krep-tpu daemon: the CUDA context is broken (CUDA error: an "
                       b"illegal memory access was encountered); the daemon exits\n")
        server.join(timeout=30)
        assert not server.is_alive() and result["rc"] == 0
        assert not os.path.exists(sock)
    finally:
        if server.is_alive():
            td.stop(sock)
            server.join(timeout=30)


def test_daemon_module_imports_no_torch():
    """torch loads in the daemon after its double fork, not before."""
    code = "import sys, krep_tpu_torch.daemon; print(sorted(m for m in sys.modules if m == 'torch'))"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
