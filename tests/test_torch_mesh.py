"""krep_tpu_torch's sharded route (parallel/mesh.py) against the JAX package,
on the CPU.

The kernels' shard modes, in their plain versions, are held to the Pallas
kernels they replace in interpret mode: the K-pattern scan's start_limit and
prev_word (literal.block_stats_multi, pallas_swar.scan_shard_multi) and the
Hamming kernel's start_limit and prev_flag (mxu.scan_count, which runs
mxu.hamming_scan_plain on the CPU, against mxu_multi.scan_count). The port's
mesh runs over `(cpu,) * D` against krep_tpu's on a D-device virtual CPU
mesh; its engine, on a machine faked to have four CUDA devices whose mesh is
four CPU shards, against krep_tpu.search_string, which shards over the
virtual devices.
Inputs come from fixed seeds; every comparison is exact equality.

The Pallas kernels' -w drops matches after "_^" (ROADMAP queue 3), so the
texts held to them hold no "^", and the "_^" case is held to tests/naive.py.
"""

import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import krep_tpu
import naive
from krep_tpu.ops import mxu_multi, pallas_swar
from krep_tpu.parallel import mesh as jmesh
from krep_tpu_torch import SearchParams, graft_entry, search_string
from krep_tpu_torch.engine import search as search_mod
from krep_tpu_torch.ops import literal, mxu, swar
from krep_tpu_torch.parallel import lines, mesh
from test_torch_multi import variants
from test_torch_search import jax_params, same

CPU = torch.device("cpu")
BLOCK = literal.BLOCK_BYTES
ALPHABET = b"abcdeAB_9 \n\nthe quick"


def jax_mesh(d: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:d]), ("data",))


def u32_of(row: np.ndarray):
    """The staged u32 view the Pallas kernels take: (rows, 128) words."""
    return jnp.asarray(row.view(np.uint32).reshape(-1, 128))


# ------------------------------------------------------------ shard layout

@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("n", [1, 65535, 65536, 65537, 200_000])
def test_stage_shards_matches_krep_tpu_layout(n, d):
    """The rows the route stages, their S and prev_word, against
    krep_tpu's build_shards_staged; owned and left clip n - base."""
    data = np.frombuffer(naive.gen_corpus(n, n, b"ab_ 9\n."), np.uint8)
    shards = list(mesh.stage_shards(data, (CPU,) * d))
    jslab, jprev, jS = jmesh.build_shards_staged(data, d)
    assert len(shards) == d and {sh.n_blocks * BLOCK for sh in shards} == {jS}
    assert np.array_equal(np.stack([sh.u8.numpy() for sh in shards]), jslab)
    assert [sh.prev_word for sh in shards] == jprev[:, 0].tolist()
    for i, sh in enumerate(shards):
        assert (sh.base, sh.left, sh.owned) == (i * jS, max(n - i * jS, 0), min(max(n - i * jS, 0), jS))


# ------------------------------------------------- kernel 1, shard mode

def shard_row(seed: int, blocks: int, limit: int, plant: bytes) -> np.ndarray:
    """`blocks` 64 KiB blocks and the 4 KiB halo of random bytes of
    ALPHABET, with `plant` straddling the start limit and at position 0."""
    row = bytearray(naive.gen_corpus(seed, blocks * BLOCK + mesh.HALO_BYTES, ALPHABET))
    row[limit - 2 : limit - 2 + len(plant)] = plant
    row[: len(plant)] = plant
    return np.frombuffer(bytes(row), np.uint8)


SHARD_CASES = [  # (patterns, case_sensitive, whole_word, prev_word, blocks, limit)
    ((b"the", b"he"), True, False, 0, 2, 2 * BLOCK - 3),
    ((b"a", b"quick", b"e a"), False, False, 1, 3, 2 * BLOCK + 1),
    ((b"the", b"he"), True, True, 1, 2, BLOCK + 7),
    ((b"a", b"quick", b"e a"), False, True, 0, 3, 3 * BLOCK - 1),
    ((b"the", b"he"), True, True, 0, 2, 0),
]


@pytest.mark.parametrize("patterns,cs,ww,prev,blocks,limit", SHARD_CASES)
def test_block_stats_multi_shard_matches_scan_shard_multi(patterns, cs, ww, prev, blocks, limit):
    """The K-pattern scan's shard mode: starts and newlines below the
    limit, matches ending by true_len in the halo, -w with prev_word."""
    m_max = max(map(len, patterns))
    row = shard_row(blocks, blocks, max(limit, 2), b"the quick")
    tl = limit + m_max - 1
    c, f, trail, lead, has_nl, mk = pallas_swar.scan_shard_multi(
        u32_of(row), jnp.int32(tl), jnp.int32(prev), jnp.int32(limit), patterns=patterns,
        case_sensitive=cs, whole_word=ww, want_mask=True, interpret=True,
    )
    t = torch.from_numpy(row.copy())
    stats, mask, totals = swar.scan_blocks_multi(
        t, tl, blocks, patterns=patterns, case_sensitive=cs, whole_word=ww,
        prev_word=prev, start_limit=limit, want_mask=True,
    )
    assert torch.equal(totals, swar.combine_blocks(stats))
    got = totals[:5].tolist()
    assert got == [int(c), int(f), int(trail), int(lead), int(has_nl)]
    assert np.array_equal(mask.numpy(), np.asarray(mk).view(np.uint8)[: mask.shape[0]])
    text = row.tobytes()  # the -w after-byte may lie past true_len
    want = sorted({s for p in patterns for s in naive.all_starts(text, p, cs, ww)
                   if s < limit and s + len(p) <= tl and not (s == 0 and ww and prev)})
    assert torch.nonzero(mask).squeeze(1).tolist() == want


def test_block_stats_multi_shard_after_underscore_caret():
    """-w after "_^" in the shard mode: held to naive."""
    patterns = (b"ab", b"cd", b"^ab")
    row = np.frombuffer((b"_^ab cd\n" * 9000)[: BLOCK + mesh.HALO_BYTES], np.uint8)
    limit = BLOCK - 5
    stats, mask, totals = swar.scan_blocks_multi(
        torch.from_numpy(row.copy()), limit + 2, 1, patterns=patterns, whole_word=True,
        prev_word=1, start_limit=limit, want_mask=True,
    )
    text = row[: limit + 2].tobytes()
    per = [[s for s in naive.all_starts(text, p, True, True) if s < limit] for p in patterns]
    want = sorted({s for ss in per for s in ss})
    assert torch.nonzero(mask).squeeze(1).tolist() == want
    assert totals[0] == sum(map(len, per))
    assert torch.equal(totals, swar.combine_blocks(stats))


# ------------------------------------------------- kernel 3, shard mode

ENGLISH = naive.gen_english(41, 3 * BLOCK)[: BLOCK + mesh.HALO_BYTES]
HAMMING_SETS = {
    "one-window": variants(32),
    "two-window": variants(30) + (b"ab cd", b"the quick brown fox jump"),
}


@pytest.mark.parametrize("name,ww", [("one-window", False), ("two-window", True)])
def test_hamming_plain_shard_matches_mxu_scan_count(name, ww):
    """start_limit drops the starts at and past it, though the bytes there
    are real text (a shard's halo); prev_flag is the -w flag before the
    text. One segment group: a 64 KiB shard and its halo. One interpret
    call per window set (each takes seconds); the -w boundary rows of both
    windows also meet naive in test_sharded_count_matches_krep_tpu."""
    patterns = HAMMING_SETS[name]
    row = bytearray(ENGLISH)
    owned = BLOCK - 1000
    row[owned - 4 : owned + 20] = b" the quick brown fox jump"[:24]  # straddles the limit
    row[: len(patterns[0])] = patterns[0]
    row = np.frombuffer(bytes(row), np.uint8)
    prev = 1
    c, mk = mxu_multi.scan_count(
        u32_of(row), jnp.int32(owned), jnp.int32(owned), jnp.int32(prev), patterns=patterns,
        whole_word=ww, want_mask=True, interpret=True,
    )
    total, mask, _ = mxu.scan_count(  # on the CPU: hamming_scan_plain
        SimpleNamespace(u8=torch.from_numpy(row.copy()), n_blocks=1), patterns=patterns,
        whole_word=ww, want_mask=True, start_limit=owned, prev_flag=prev,
    )
    assert int(total) == int(c)
    assert np.array_equal(mask.numpy(), np.asarray(mk).view(np.uint8)[: mask.shape[0]])
    text = row.tobytes()
    want = [s for p in patterns for s in naive.all_starts(text, p, True, ww)
            if s < owned and not (s == 0 and ww and prev)]
    assert int(c) == len(want) and int(c) > 0


# ---------------------------------------------- the mesh against krep_tpu

SCAN_TEXT = naive.gen_english(5, 150_000)
SCAN_SETS = [  # (patterns, whole_word)
    ((b"the",), False), ((b"e",), True), ((b"the", b"quick"), True),
    ((b"the", b"e", b"brown fox jumps over"), False), ((b"a", b"aa", b"aaa"), False),
]


@pytest.mark.parametrize("d", [1, 3, 8])
def test_sharded_scan_matches_krep_tpu(d):
    """Totals, union line counts and union starts of one and of several
    patterns (mixed lengths, nested overlaps) on a D-shard CPU mesh, each
    against krep_tpu's D-device mesh, with and without -w."""
    data = np.frombuffer(SCAN_TEXT, np.uint8)
    for pats, ww in SCAN_SETS:
        got = mesh.sharded_scan(data, pats, whole_word=ww, want_mask=True, mesh=(CPU,) * d)
        want = jmesh.sharded_scan(data, pats, whole_word=ww, want_mask=True, mesh=jax_mesh(d))
        assert got[:2] == want[:2] and got[2].tolist() == want[2].tolist(), (pats, ww)


def edge_planted(n: int, S: int, plants) -> bytes:
    """Filler text with `plants` ((offset from a shard edge, bytes)) at
    every multiple of S."""
    body = bytearray(b" x" * (n // 2))
    for edge in range(S, n - 8, S):
        for off, b in plants:
            body[edge + off : edge + off + len(b)] = b
    return bytes(body)


@pytest.mark.parametrize("d", [3, 8])
def test_word_and_line_straddles_at_shard_edges(d):
    """A -w word right after a word byte at each shard start (prev_word),
    a match ending at a shard's last byte with a word byte after it (read
    from the halo), a clean match across the edge, and one line with
    matches on both sides of every edge: counted once."""
    n = 700_000
    S = mesh.shard_bytes(n, d)
    text = edge_planted(n, S, [(-1, b"xcat"), (-40, b"cats"), (-60, b" cat "), (-2, b"cat")])
    data = np.frombuffer(text, np.uint8)
    for pats in [(b"cat",), (b"cat", b"dog")]:
        got = mesh.sharded_scan(data, pats, whole_word=True, want_mask=True, mesh=(CPU,) * d)
        want = jmesh.sharded_scan(data, pats, whole_word=True, want_mask=True, mesh=jax_mesh(d))
        assert got[:2] == want[:2] and got[2].tolist() == want[2].tolist()
        union = sorted({s for p in pats for s in naive.all_starts(text, p, True, True)})
        assert got[2].tolist() == union and got[1] == 1  # no newline: one line
    nonl = np.frombuffer(b"the " * 100_000, np.uint8)
    assert mesh.sharded_counts(nonl, b"the", mesh=(CPU,) * d) == (100_000, 1)
    lined = np.frombuffer(edge_planted(n, S, [(-3, b"ab\nab"), (-1, b"ab")]), np.uint8)
    want = naive.all_starts(lined.tobytes(), b"ab")
    assert mesh.sharded_counts(lined, b"ab", mesh=(CPU,) * d) == (
        len(want), naive.matched_lines(lined.tobytes(), want))


def n_starts(text: bytes, pattern: bytes, whole_word=False) -> int:
    """len(naive.all_starts(text, pattern, True, whole_word)), by a regex
    lookahead (the Python loop takes seconds at 40 patterns)."""
    word = rb"[0-9A-Za-z_]"
    find = rb"(?=" + re.escape(pattern) + (rb"(?!" + word + rb")" if whole_word else b"") + rb")"
    return len(re.findall((rb"(?<!" + word + rb")" if whole_word else b"") + find, text))


def test_sharded_count_matches_krep_tpu():
    """The 40-pattern Hamming step per shard (mesh.py:746-752, Pallas in
    interpret mode as there) on 3 shards; -w with a word planted at every
    shard edge, and 14-29 byte members (two windows) across the edges,
    held to naive."""
    text = naive.gen_english(37, 140_000)  # 3 shards of 64 KiB, the last part-filled
    data = np.frombuffer(text, np.uint8)
    pats = tuple(text[i : i + 3 + (i % 5)] for i in range(0, 3 * 40, 3))
    got = mesh.sharded_count(data, pats, mesh=(CPU,) * 3)
    assert got == jmesh.sharded_count(data, pats, mesh=jax_mesh(3), interpret=True)
    assert got == sum(n_starts(text, p) for p in pats)
    S = mesh.shard_bytes(150_000, 4)
    body = bytearray(naive.gen_english(51, 150_000).replace(b"^", b" "))
    long_pat = b"ABCDEFGHIJKLMNOPQRSTUVWXY"  # 25 bytes
    for edge in range(S, len(body) - 400, S):
        body[edge - 1 : edge + 3] = b"xcat"
        body[edge + 100 - 3 : edge + 100 + 1] = b"cats"
        body[edge - 300 : edge - 300 + 25] = long_pat
        body[edge - 12 : edge + 13] = long_pat
    text = bytes(body)
    data = np.frombuffer(text, np.uint8)
    for extra, ww in (((b"cat",), True), ((long_pat,), False)):
        pats = extra + tuple(text[13 * i : 13 * i + 3 + (i % 26)] for i in range(32))
        want = sum(n_starts(text, p, ww) for p in pats)
        assert mesh.sharded_count(data, pats, whole_word=ww, mesh=(CPU,) * 4) == want, ww


def test_shard_over_staging_limit_raises(monkeypatch):
    monkeypatch.setattr(mesh, "SHARD_MAX", BLOCK)
    data = np.frombuffer(SCAN_TEXT, np.uint8)
    with pytest.raises(NotImplementedError, match="2 GiB staging limit"):
        mesh.sharded_scan(data, b"the", mesh=(CPU,) * 2)


def test_dryrun_and_graft_entry():
    mesh.dryrun(4, "cpu")
    graft_entry.dryrun_multichip(3, "cpu")
    fn, args = graft_entry.entry("cpu")
    totals, mask, _ = fn(*args)
    text = args[0].u8[: args[0].n]
    assert totals[:2].tolist() == list(literal.scan_literal(text, args[0].n, pattern=b"the")[:2])
    assert mask.sum() == totals[0]


# ------------------------------------------- the engine through the mesh

@pytest.fixture
def four_gpus(monkeypatch):
    """A machine that looks like it has four CUDA devices, whose mesh is
    four CPU shards: the engine takes its sharded route, and the shards
    run the kernels' plain versions. Returns the sizes of the meshes staged."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mesh, "devices", lambda device: (CPU,) * 4)
    staged = []
    real = mesh.stage_shards
    monkeypatch.setattr(mesh, "stage_shards",
                        lambda data, m: staged.append(len(m)) or real(data, m))
    return staged


GPU = torch.device("cuda", 0)
ENGINE_TEXT = naive.gen_english(8, 200_000)
ENGINE_MODES = {
    "c": dict(count_mode=True),
    "c-o": dict(count_mode=True, only_matching=True),
    "o": dict(only_matching=True),
    "lines": dict(),
    "bm": dict(algo_override="bm"),
    "kmp-m-o": dict(algo_override="kmp", only_matching=True, max_count=7),
    "m-c": dict(max_count=5, count_mode=True),
    "i-w-c-o": dict(case_sensitive=False, whole_word=True, count_mode=True, only_matching=True),
}


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_engine_sharded_matches_krep_tpu(four_gpus, mode):
    """One literal, one with nested overlaps under the policies, and three
    patterns, through search_string on the fake four-GPU machine, against
    krep_tpu.search_string on its 8-device virtual mesh."""
    for pats in [(b"the",), (b"aa",), (b"the", b"quick", b"fox")]:
        p = SearchParams(patterns=pats, **ENGINE_MODES[mode])
        same(search_string(p, ENGINE_TEXT, device=GPU),
             krep_tpu.search_string(jax_params(p), ENGINE_TEXT))
    assert four_gpus and set(four_gpus) == {4}


def test_engine_sharded_threads_shape_the_mesh(four_gpus):
    """-t caps the shard count (None: every device); -t 1 takes the
    single-device route."""
    p = SearchParams(patterns=(b"the",), count_mode=True)
    want = krep_tpu.search_string(jax_params(p), ENGINE_TEXT, threads=1)
    for t, d in [(None, 4), (2, 2), (3, 3), (99, 4)]:
        four_gpus.clear()
        same(search_string(p, ENGINE_TEXT, threads=t, device=GPU), want)
        assert four_gpus == [d], t
    assert not search_mod._shards(GPU, len(ENGINE_TEXT), 1)
    assert not search_mod._shards(GPU, (1 << 16) - 1, None)


def test_mesh_for_threads(monkeypatch):
    """-t over the CUDA devices; a CPU device is one device."""
    assert search_mod._mesh_for_threads(None, CPU) == (CPU,)
    assert search_mod._mesh_for_threads(3, CPU) == (CPU,)
    assert not search_mod._shards(CPU, len(ENGINE_TEXT), None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = [torch.device("cuda", i) for i in range(4)]
    for t, want in [(None, cuda), (1, cuda[:1]), (2, cuda[:2]), (9, cuda)]:
        assert search_mod._mesh_for_threads(t, GPU) == tuple(want)
    assert mesh.mesh_of(3, GPU) == tuple(cuda[:3]) and mesh.mesh_of(5, GPU) == (GPU,) * 5


@pytest.mark.parametrize("name,modes", [
    ("K40-hamming", ("c-o",)), ("K70-grouped", ("o",)),
    ("long-member", ("c", "o")), ("longpat", ("c", "o", "kmp-m-o")),
])
def test_engine_sharded_multi_and_long_matches_krep_tpu(four_gpus, name, modes, monkeypatch):
    """The Hamming count per shard, the grouped K > 64 route, a member
    over 64 bytes and a single pattern over 64 bytes (the sharded prefix
    filter), in the modes that take different branches."""
    longpat = bytes(range(33, 123))  # 90 bytes
    body = bytearray(ENGINE_TEXT)
    S = mesh.shard_bytes(len(body), 4)
    for at in (10_000, S - 45, 2 * S - 1):
        body[at : at + 90] = longpat
    text = bytes(body)
    pats = {
        "K40-hamming": variants(40),
        "K70-grouped": variants(69) + (b"x" * 40,),
        "long-member": (longpat, b"the", b"fox"),
        "longpat": (longpat,),
    }[name]
    calls = []
    for fn in ("sharded_scan", "sharded_count"):
        real = getattr(mesh, fn)
        monkeypatch.setattr(mesh, fn, lambda *a, _f=real, _n=fn, **k: calls.append(_n) or _f(*a, **k))
    for mode in modes:
        p = SearchParams(patterns=pats, **ENGINE_MODES[mode])
        same(search_string(p, text, device=GPU), krep_tpu.search_string(jax_params(p), text))
    assert set(calls) == ({"sharded_count"} if name == "K40-hamming" else {"sharded_scan"})


def test_engine_sharded_failure_raises(four_gpus, monkeypatch):
    """No fallback: a failure on the sharded route reaches the caller."""
    def broken(*a, **k):
        raise RuntimeError("scan_blocks kernel launch failed: CUDA error 1")

    monkeypatch.setattr(mesh, "sharded_scan", broken)
    for pats in [(b"the",), (b"the", b"fox")]:
        with pytest.raises(RuntimeError, match="launch failed"):
            search_string(SearchParams(patterns=pats, count_mode=True), ENGINE_TEXT, device=GPU)


def test_combine_line_counts_matches_krep_tpu():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 3, (50, 5))
    assert mesh.combine_line_counts(*rows.T) == jmesh.combine_line_counts(*rows.T)
    assert lines.LineCountCombiner is mesh.LineCountCombiner
