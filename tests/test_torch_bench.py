"""The port's bench (krep_tpu_torch/tools/bench.py) against bench.py and
krep_tpu, on the CPU.

Its corpora are bench.py's bytes (its gen_corpus and gen_corpus_ing, and
the tree that bench.py's config 5 writes, run from bench.py itself); its
draws replay numpy's, rejections included (a scalar model of numpy's
PCG64 and Lemire draws, itself held to numpy's Generator); each config's
count at --device cpu on a 1 MiB corpus equals krep_tpu's on the same
file; its metric strings are bench.py's; it refuses to run without a card
unless asked for the CPU, and exits non-zero after a failed config or a
false parity.
"""

import ast
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jbench
from krep_tpu import cli as jcli
from krep_tpu_torch.tools import bench

REPO = Path(__file__).resolve().parents[1]
MIB = 1 << 20


@pytest.mark.parametrize("size", [1, 4096, 256 << 10])
@pytest.mark.parametrize("ing", [False, True], ids=["config1", "config4"])
def test_corpus_is_bench_py_byte_for_byte(tmp_path, size, ing):
    path = str(tmp_path / "c.txt")
    (jbench.gen_corpus_ing if ing else jbench.gen_corpus)(path, size)
    want = np.fromfile(path, np.uint8)
    got = (bench.corpus_ing_bytes if ing else bench.corpus_bytes)(size)
    assert got.shape == (size,) and np.array_equal(got, want)


def bench_py_config5_tree(root: Path) -> None:
    """bench.py's own tree-writing block of config5 (bench.py:648-666), run
    from bench.py's source."""
    fn = next(n for n in ast.parse((REPO / "bench.py").read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == "config5")
    block = next(n for n in fn.body if isinstance(n, ast.If))
    module = ast.Module(body=block.body, type_ignores=[])
    exec(compile(module, "bench.py", "exec"), {"os": os, "np": np, "tree": str(root)})


def test_config5_tree_is_bench_py(tmp_path):
    bench_py_config5_tree(tmp_path / "bench_py")
    mine = tmp_path / "twin"
    bench.gen_config5_tree(str(mine))
    want = bench.config5_files()
    for root in (tmp_path / "bench_py", mine):
        files = {str(p.relative_to(root)): p.read_bytes() for p in root.rglob("*") if p.is_file()}
        assert files == want
    assert len(files) == 1001 and files[".gitignore"] == b"pkg19/\n"


def test_corpus_reused_only_when_its_bytes_are_the_recipe(tmp_path):
    path = str(tmp_path / "bench_4096.txt")
    want = bench.corpus_bytes(4096)
    bad = want.copy()
    bad[100] ^= 1
    bad.tofile(path)  # the right size, the wrong bytes
    bench.gen_corpus(path, 4096)
    assert np.array_equal(np.fromfile(path, np.uint8), want)
    inode = os.stat(path).st_ino
    bench.gen_corpus(path, 4096)  # the recipe's bytes: kept, not rewritten
    assert os.stat(path).st_ino == inode


class ScalarDraws:
    """numpy's Generator draws over raw PCG64 outputs, one at a time: a
    32-bit draw takes the low word of the next output and buffers its high
    word; a double takes a whole output and leaves the buffer; integers(0,
    n) is Lemire's method with its rejection."""

    def __init__(self, raw):
        self.raw, self.j, self.buf = [int(x) for x in raw], 0, None

    def u32(self):
        if self.buf is not None:
            v, self.buf = self.buf, None
            return v
        x = self.raw[self.j]
        self.j += 1
        self.buf = x >> 32
        return x & 0xFFFFFFFF

    def integers(self, n):
        while True:
            m = self.u32() * n
            if m & 0xFFFFFFFF >= (1 << 32) % n:
                return m >> 32

    def random(self):
        x = self.raw[self.j]
        self.j += 1
        return (x >> 11) * 2.0 ** -53


def scalar_lines(raw, n_lines, ing):
    """bench.py's line loop (bench.py:50-53, :536-543) on ScalarDraws."""
    d, out, vocab = ScalarDraws(raw), [], bench.WORDS
    for _ in range(n_lines):
        k = 3 + d.integers(6)
        ws = [vocab[d.integers(len(vocab))] for _ in range(k)]
        if ing and d.random() < 0.03:
            word = bench.ING_WORDS[d.integers(len(bench.ING_WORDS))]
            ws[d.integers(k)] = word
        out.append(b" ".join(ws) + b"\n")
    return b"".join(out)


@pytest.mark.parametrize("ing", [False, True], ids=["config1", "config4"])
def test_scalar_model_is_numpy(ing):
    raw = np.random.default_rng(12345).bit_generator.random_raw(4096)
    rng = np.random.default_rng(12345)
    want = []
    for _ in range(300):
        k = int(rng.integers(3, 9))
        ws = [bench.WORDS[i] for i in rng.integers(0, len(bench.WORDS), k)]
        if ing and rng.random() < 0.03:
            ws[int(rng.integers(0, k))] = bench.ING_WORDS[int(rng.integers(0, 7))]
        want.append(b" ".join(ws) + b"\n")
    assert scalar_lines(raw, 300, ing) == b"".join(want)


@pytest.mark.parametrize("ing", [False, True], ids=["config1", "config4"])
def test_rejected_draws_are_replayed(ing):
    """Raw outputs whose halves are often 0 (x * n mod 2^32 = 0 is under
    2^32 mod n for n = 6, 25, 7, 3, 5: a rejection) or tiny: corpus.c's
    lines equal the scalar model's."""
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 1 << 63, 20_000, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    halves = raw.view(np.uint32).copy()
    halves[rng.random(halves.shape[0]) < 0.05] = 0
    halves[rng.random(halves.shape[0]) < 0.02] = 1
    raw = halves.view(np.uint64)
    state = np.array([0, -1], np.int64)
    got = bench.recipe_lines(raw, state, 100_000, ing).tobytes()
    assert len(got) >= 100_000
    n_lines = got.count(b"\n")
    assert got == scalar_lines(raw, n_lines, ing)
    assert state[0] < raw.shape[0]


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    os.environ["KREP_TPU_CACHE_DIR"] = str(root / "cache")
    try:
        run = bench.Run(torch.device("cpu"), 1, MIB, str(root / "corpus"))
        records = {}
        for key, fn in bench.CONFIGS.items():
            records[key] = fn(run)
        yield run, records
    finally:
        os.environ.pop("KREP_TPU_CACHE_DIR", None)


def krep_tpu_stdout(args, monkeypatch):
    out = io.BytesIO()
    with monkeypatch.context() as m:
        m.setenv("KREP_TPU_HOST_BREAKEVEN", str(1 << 40))
        rc = jcli.main(list(args), out=out)
    assert rc in (0, 1)
    return out.getvalue()


@pytest.mark.parametrize("key", list(bench.METRICS))
def test_config_count_equals_krep_tpu(cpu_run, key, monkeypatch):
    _, records = cpu_run
    rec = records[key]
    args, _, ours = rec["_reference"]
    assert rec["metric"] == bench.METRICS[key] and rec["value"] > 0
    want = krep_tpu_stdout(args, monkeypatch)
    if key == "5":  # the -r -c lines, in the walker's order on both sides
        assert sorted(ours.splitlines()) == sorted(want.splitlines())
        assert rec["files"] == rec["match_count"] == 951
    else:
        assert rec["match_count"] == int(want.rsplit(b":", 1)[-1])
        assert rec["match_count"] > 0 or key == "2"  # config 2: no word 'e' in the corpus


def test_metric_names_are_bench_py():
    names = set()
    for node in ast.walk(ast.parse((REPO / "bench.py").read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "emit"
                and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value)
    assert names == set(bench.METRICS.values())


def test_no_card_without_device_cpu_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "-m", "krep_tpu_torch.tools.bench"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["error"].startswith("no CUDA")
    assert bench.main(["--device", "cuda", "--all"]) == 2


def test_main_holds_every_config_to_its_reference(tmp_path, monkeypatch):
    """--only=1,2 on the CPU: both lines carry a true parity from the
    reference process and the artifact; a false parity, or a config that
    raises, gives exit 1 while the other configs still run."""
    monkeypatch.setenv("KREP_BENCH_CORPUS_DIR", str(tmp_path))
    monkeypatch.setenv("KREP_BENCH_BYTES", str(256 << 10))
    out = tmp_path / "run.json"
    argv = ["--only=1,2", "--device", "cpu", "--reps", "2", "--out", str(out)]
    assert bench.main(argv) == 0
    doc = json.loads(out.read_text())
    assert [r["config"] for r in doc["configs"]] == ["1", "2"]
    for r in doc["configs"]:
        assert r["count_parity_vs_reference"] is True and r["device"] == "cpu"
        assert r["reference_count"] == r["match_count"] and len(r["reps"]["ms"]) == 2
    real = bench.reference
    monkeypatch.setattr(bench, "reference",
                        lambda args, env: (b"7\n", 0, "") if "e" in args else real(args, env))
    assert bench.main(argv) == 1
    monkeypatch.setattr(bench, "reference", real)

    def broken(run):
        raise RuntimeError("planted")

    monkeypatch.setitem(bench.CONFIGS, "1", broken)
    assert bench.main(argv) == 1
    doc = json.loads(out.read_text())
    assert "planted" in doc["configs"][0]["failed"]
    assert doc["configs"][1]["count_parity_vs_reference"] is True
