"""Resident engine daemon: the port's answer to C-binary startup cost.

Port of krep_tpu/daemon.py. The reference is a C binary whose small-file
regime costs one open+read+scan with zero startup (krep.c:3402-3430). A
Python+PyTorch process pays for the interpreter, the torch import, the
CUDA context, the kernel library's load and its first pinned buffer
before the first byte is scanned. The fix is the standard one for
accelerator-backed serving (bazel/watchman/gradle): a resident engine
holding the warm interpreter, torch, the CUDA context and the loaded
kernels, fronted by a native client (native/client.c, built by
native/client.py).

Protocol (AF_UNIX SOCK_STREAM, one request per connection):

  client -> server, first sendmsg carries SCM_RIGHTS [stdin, stdout,
  stderr] plus a 16-byte header:  magic b"KRPD" | u32 version | u64
  payload_len, then payload bytes (possibly across further sends):

      u32 argc
      cwd  NUL-terminated
      argc args, each NUL-terminated
      u32 nenv
      nenv "KEY=VALUE" entries, each NUL-terminated

  server -> client after the request completes: b"KRPR" | i32 rc.

Passing the real fds (not buffered pipes) makes output streaming,
`isatty` (and so --color=auto), stdin consumption, and SIGPIPE behavior
identical to running the CLI directly — the daemon writes to the
client's own terminal/pipe.

Requests are served sequentially: cwd and env are process-global, and a
single request already fans out across devices/threads internally.
Import-time knobs (KREP_TPU_STRICT) are fixed at daemon start; routing
knobs (KREP_TPU_HOST_BREAKEVEN, KREP_TPU_PROFILE, KREP_TORCH_DEVICE, ...)
are applied per-request from the client's environment.

A request that breaks the CUDA context (an illegal address, a launch
failure: errors that stay with the context) is answered rc 2 with the
error on the client's stderr; the daemon then leaves its accept loop and
removes its socket, so the client's next call starts a fresh one. It never
serves on a broken context and never moves a request to the CPU.

The default socket, torch-daemon-{uid}.sock under $KREP_TPU_CACHE_DIR,
differs from the JAX package's daemon-{uid}.sock, so neither daemon
answers the other's client.

Run: python -m krep_tpu_torch.daemon [--sock PATH] [--idle SECS] [--foreground]
Stop: python -m krep_tpu_torch.daemon --stop   (or just let it idle out)
"""

from __future__ import annotations

import argparse
import io
import os
import socket
import struct
import sys
import threading

MAGIC_REQ = b"KRPD"
MAGIC_STOP = b"KRPX"
MAGIC_RESP = b"KRPR"
VERSION = 1
MAX_PAYLOAD = 16 << 20  # argv+env; far beyond any real command line
DEFAULT_IDLE_S = 900.0


def default_sock_path() -> str:
    env = os.environ.get("KREP_TPU_DAEMON_SOCK")
    if env:
        return env
    cache = os.environ.get(
        "KREP_TPU_CACHE_DIR", os.path.expanduser("~/.cache/krep_tpu")
    )
    return os.path.join(cache, f"torch-daemon-{os.getuid()}.sock")


class _OutShim(io.RawIOBase):
    """sys.stdout stand-in over the client's fd: cli.main only needs
    .isatty() (--color=auto) and .buffer (default out target)."""

    def __init__(self, fd: int):
        super().__init__()
        self._fd = fd
        self.buffer = io.BufferedWriter(io.FileIO(fd, "wb", closefd=False))

    def isatty(self) -> bool:
        try:
            return os.isatty(self._fd)
        except OSError:
            return False

    def write(self, s):
        data = s.encode() if isinstance(s, str) else s
        self.buffer.write(data)
        return len(s)

    def flush(self):
        self.buffer.flush()


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = conn.recv(min(n, 1 << 16))
        if not b:
            raise ConnectionError("client hung up mid-request")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _parse_payload(payload: bytes):
    off = 0

    def u32():
        nonlocal off
        (v,) = struct.unpack_from("<I", payload, off)
        off += 4
        return v

    def cstr():
        nonlocal off
        end = payload.index(b"\x00", off)
        s = payload[off:end]
        off = end + 1
        return s

    argc = u32()
    if argc > 4096:
        raise ValueError("argc too large")
    cwd = cstr()
    args = [cstr().decode("utf-8", "surrogateescape") for _ in range(argc)]
    nenv = u32()
    if nenv > 4096:
        raise ValueError("nenv too large")
    env = {}
    for _ in range(nenv):
        k, _, v = cstr().decode("utf-8", "surrogateescape").partition("=")
        env[k] = v
    return cwd, args, env


# env keys the daemon honors per-request (routing/profiling knobs and the
# device; cheap, read at call time). Import-time knobs are fixed at daemon
# start.
_REQUEST_ENV_PREFIXES = ("KREP_TPU_", "KREP_TORCH_")


def _cuda_fault() -> str | None:
    """The error of a CUDA context that a request left broken, else None.
    Errors that stay with a context (an illegal address, a launch failure)
    raise again at every synchronize; the CLI has already reported the
    request's own failure, so this asks the context itself."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    current = torch.cuda.current_device()
    try:
        for i in range(torch.cuda.device_count()):
            if i == current or torch.cuda.memory_reserved(i):
                torch.cuda.synchronize(i)
    except RuntimeError as e:
        return str(e).strip() or type(e).__name__
    return None


def serve_request(conn: socket.socket) -> bool:
    """Handle one request; returns True when the daemon must leave its
    accept loop: the client asked it to shut down (magic KRPX), or the
    request broke the CUDA context."""
    # header + fds arrive together on the first recvmsg
    hdr, fds, _, _ = socket.recv_fds(conn, 16, 3)
    fault = None
    try:
        if len(hdr) < 16:
            hdr += _recv_exact(conn, 16 - len(hdr))
        magic, ver, plen = struct.unpack("<4sIQ", hdr)
        if magic == MAGIC_STOP:
            try:
                conn.sendall(MAGIC_RESP + struct.pack("<i", 0))
            except OSError:
                pass  # the stopper stopped waiting: stop all the same
            return True
        if magic != MAGIC_REQ or ver != VERSION:
            raise ValueError(f"bad request header {magic!r} v{ver}")
        if plen > MAX_PAYLOAD:
            raise ValueError("payload too large")
        if len(fds) != 3:
            raise ValueError(f"expected 3 fds, got {len(fds)}")
        cwd, args, env = _parse_payload(_recv_exact(conn, plen))

        saved_env = {
            k: os.environ.get(k)
            for k in set(env) | {
                k for k in os.environ if k.startswith(_REQUEST_ENV_PREFIXES)
            }
        }
        old_stdin, old_stdout, old_stderr = sys.stdin, sys.stdout, sys.stderr
        rc = 2
        try:
            os.chdir(cwd)
            for k in saved_env:
                os.environ.pop(k, None)
            os.environ.update(env)
            # imported here, not before a stop request: the first import
            # of cli loads torch, which can outlast the stopper's wait
            from . import cli

            # hostscan caches the calibrated threshold; per-request env
            # overrides must see a fresh read
            from .ops import hostscan

            hostscan._threshold_cache = None

            sys.stdin = io.TextIOWrapper(
                io.BufferedReader(io.FileIO(fds[0], "rb", closefd=False))
            )
            out = _OutShim(fds[1])
            sys.stdout = out
            sys.stderr = io.TextIOWrapper(
                io.FileIO(fds[2], "wb", closefd=False), write_through=True
            )
            try:
                rc = cli.main(args, out=out.buffer)
                out.flush()
            except BrokenPipeError:
                rc = 141  # downstream closed (e.g. `| head`) == SIGPIPE death
            except SystemExit as e:
                rc = int(e.code or 0)
            except Exception:
                import traceback

                try:
                    traceback.print_exc(file=sys.stderr)
                except OSError:
                    pass
                rc = 2
            fault = _cuda_fault()
            if fault is not None:
                rc = 2
                try:
                    sys.stderr.write(
                        f"krep-tpu daemon: the CUDA context is broken ({fault}); "
                        "the daemon exits\n"
                    )
                except OSError:
                    pass
        finally:
            sys.stdin, sys.stdout, sys.stderr = old_stdin, old_stdout, old_stderr
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        try:
            conn.sendall(MAGIC_RESP + struct.pack("<i", rc))
        except OSError:
            pass
    finally:
        for fd in fds:
            try:
                os.close(fd)
            except OSError:
                pass
    return fault is not None


def warm() -> None:
    """What the port's first device query would otherwise pay for: the
    native runtime, torch, and on a card the CUDA context, the kernel
    library (an nvcc build on a fresh tree) and one small staged `-c` scan
    (the smallest pinned bucket, the scan's module). On the CPU
    (KREP_TORCH_DEVICE=cpu) only the runtime and torch. Failures are left
    for the request that meets them to report."""
    try:
        from .native import runtime  # noqa: F401  (builds the .so)
    except Exception:
        pass
    try:
        import torch  # noqa: F401

        from .ops import dispatch

        dev = dispatch.resolve_device()
        if dev.type != "cuda":
            return
        from .ops import _build

        _build.library()
        st = dispatch.stage(b"the daemon warms the scan\n", dev)
        totals, _, _ = dispatch.scan_literal_staged(
            st, pattern=b"the", case_sensitive=True, whole_word=False,
            want_mask=False,
        )
        int(totals[1])
    except Exception:
        pass


def _warm_background() -> None:
    """warm() off the accept loop, in a thread named krep-warm."""
    threading.Thread(target=warm, name="krep-warm", daemon=True).start()


def _try_connect(path: str) -> socket.socket | None:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        s.settimeout(2.0)
        s.connect(path)
        return s
    except OSError:
        s.close()
        return None


def serve(sock_path: str, idle_s: float = DEFAULT_IDLE_S) -> int:
    os.makedirs(os.path.dirname(sock_path) or ".", exist_ok=True)
    if os.path.exists(sock_path):
        if _try_connect(sock_path) is not None:
            sys.stderr.write(f"krep-tpu daemon: already running at {sock_path}\n")
            return 0
        os.unlink(sock_path)  # stale socket from a dead daemon

    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        srv.bind(sock_path)
        os.chmod(sock_path, 0o600)
        srv.listen(16)
        srv.settimeout(idle_s)
        _warm_background()
        while True:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                break  # idle out
            except OSError:
                break
            leave = False
            with conn:
                try:
                    leave = serve_request(conn)
                except Exception as e:
                    sys.stderr.write(f"krep-tpu daemon: request failed: {e}\n")
            if leave:
                break
        return 0
    finally:
        srv.close()
        try:
            os.unlink(sock_path)
        except OSError:
            pass


def stop(sock_path: str) -> int:
    """Ask a running daemon to exit (magic KRPX; the daemon acks with rc 0,
    closes its socket, and leaves the accept loop)."""
    s = _try_connect(sock_path)
    if s is None:
        sys.stderr.write("krep-tpu daemon: not running\n")
        return 0
    with s:
        s.sendall(MAGIC_STOP + struct.pack("<IQ", VERSION, 0))
        try:
            s.recv(8)
        except OSError:
            pass
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="krep-tpu-torch-daemon", description=__doc__)
    ap.add_argument("--sock", default=default_sock_path())
    ap.add_argument("--idle", type=float, default=DEFAULT_IDLE_S,
                    help="exit after this many idle seconds")
    ap.add_argument("--foreground", action="store_true",
                    help="serve in this process (default: double-fork)")
    ap.add_argument("--stop", action="store_true")
    ns = ap.parse_args(argv)

    if ns.stop:
        return stop(ns.sock)
    if ns.foreground:
        return serve(ns.sock, ns.idle)

    # daemonize: double-fork + setsid, then serve (torch is first imported
    # in the grandchild, by warm() or the first request)
    if os.fork():
        return 0
    os.setsid()
    if os.fork():
        os._exit(0)
    devnull = os.open(os.devnull, os.O_RDWR)
    os.dup2(devnull, 0)
    os.dup2(devnull, 1)
    os.dup2(devnull, 2)
    os._exit(serve(ns.sock, ns.idle))


if __name__ == "__main__":
    sys.exit(main())
