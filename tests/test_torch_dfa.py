"""krep_tpu_torch's dense-DFA route (KREP_TPU_DFA=1) against krep_tpu, on
the CPU.

The automaton's tables (build_dense_ac, copied) and lanes (make_lanes, on
tensors) are held to krep_tpu/ops/ac.py's, `dfa_scan_plain` (the CUDA
kernel's plain version) to its jax.lax.scan `dfa_scan` on the same lanes,
exactly, and the CLI to krep_tpu.cli under KREP_TPU_DFA=1 on the cases
of tests/test_dfa.py, with sets of more than 64 patterns (the route's
domain). tests/conftest.py sets KREP_TPU_HOST_BREAKEVEN=0, so both
packages take their device routes.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naive
from krep_tpu import cli as jcli
from krep_tpu.ops import ac as jac
from krep_tpu_torch import SearchParams, cli, search_string
from krep_tpu_torch.ops import ac, dispatch, multi
from test_dfa import make_patterns

CPU = torch.device("cpu")


def run(main, argv, **kw):
    out = io.BytesIO()
    rc = main(list(argv), out=out, **kw)
    return out.getvalue(), rc


@pytest.mark.parametrize("k,cs", [(4, True), (80, True), (100, False)])
def test_build_dense_ac_matches_reference(k, cs):
    pats = [b"he", b"she", b"his", b"hers"] if k == 4 else make_patterns(k)
    table, emit = ac.build_dense_ac(pats, cs)
    jtable, jemit = jac.build_dense_ac(pats, cs)
    assert np.array_equal(table, jtable) and np.array_equal(emit, jemit)
    if k == 4:  # the classic "ushers": he, she, hers
        state = total = 0
        for c in b"ushers":
            state = int(table[state, c])
            total += int(emit[state])
        assert total == 3


@pytest.mark.parametrize("n,maxlen,lanes", [(1, 1, 16), (100, 20, 16), (9_999, 7, 64),
                                            (20_000, 9, 16)])
def test_make_lanes_matches_reference(n, maxlen, lanes):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    chunks, (lo, hi), chunk = ac.make_lanes(torch.from_numpy(data), maxlen, lanes)
    jchunks, (jlo, jhi), jchunk = jac.make_lanes(data, maxlen, lanes)
    assert chunk == jchunk
    assert np.array_equal(chunks.numpy(), jchunks)
    assert np.array_equal(lo.numpy(), jlo) and np.array_equal(hi.numpy(), jhi)


@pytest.mark.parametrize("k,cs,n", [(80, True, 15_000), (100, False, 12_000),
                                    (70, True, 3_001)])
def test_dfa_scan_plain_matches_reference(k, cs, n):
    """dfa_scan_plain and krep_tpu's dfa_scan on the same lanes: equal
    totals and equal (L, T) masks."""
    pats = make_patterns(k)
    text = np.frombuffer(naive.gen_english(k + n, n), np.uint8)
    if not cs:
        text = jac.fold_np(text)
    table, emit = jac.build_dense_ac(pats, cs)
    maxlen = max(map(len, pats))
    lanes = int(np.clip(1 << max(0, (n // 4096)).bit_length(), 16, 8192))
    chunks, (lo, hi), _ = jac.make_lanes(text, maxlen, lanes)
    jtotal, jmask = jac.dfa_scan(jnp.asarray(chunks), jnp.asarray(table), jnp.asarray(emit),
                                 (jnp.asarray(lo), jnp.asarray(hi)), want_mask=True)
    owned = (torch.from_numpy(lo), torch.from_numpy(hi))
    total, mask = ac.dfa_scan_plain(torch.from_numpy(chunks), torch.from_numpy(table),
                                    torch.from_numpy(emit), owned, want_mask=True)
    assert int(total) == int(jtotal) > 0
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    count_only, none = ac.dfa_scan_plain(torch.from_numpy(chunks), torch.from_numpy(table),
                                         torch.from_numpy(emit), owned, want_mask=False)
    assert int(count_only) == int(jtotal) and none is None


@pytest.mark.parametrize("cs,want", [(True, True), (False, True), (True, False)])
def test_search_dense_dfa_matches_reference(cs, want):
    """The route's scan (dfa_walk on a CPU staging: the plain version over
    krep_tpu's lanes, its mask read back at the match ends) against
    krep_tpu's search_dense_dfa."""
    pats = make_patterns(90)
    text = naive.gen_english(31, 25_000)
    staged = dispatch.stage(text, CPU)
    total, ends = ac.search_dense_dfa(pats, staged, cs, want, CPU)
    jtotal, jends = jac.search_dense_dfa(pats, text, cs, want)
    assert total == jtotal > 0
    assert (ends is None and jends is None) or np.array_equal(ends, jends)


def test_lane_span():
    """About `target` threads (the card's resident threads of the instance;
    2**18 by default), at least four halos; a power of two up to 128 bytes,
    past it a multiple of 128."""
    mib = 1 << 20
    assert [ac.lane_span(n) for n in (64 << 10, 16 * mib, 64 * mib, 256 * mib, 1 << 30,
                                      4 << 30)] == [16, 64, 256, 1024, 4096, 16384]
    assert [ac.lane_span(16 * mib, h) for h in (0, 7, 16, 17, 63, 2000)] == [
        64, 64, 64, 128, 256, 8064]
    assert ac.lane_span(1 << 30, 7, 132 * 1536) == 5376  # 1 GiB / 5,376 B: 199,729 threads
    assert ac.lane_span(1 << 40) == ac.MAX_SPAN


DFA_ARGS = [["-c", "-o"], ["-c"], ["-o", "-m", "25"], ["-o"], ["-w", "-c", "-o"],
            ["-w", "-o"], ["-i", "-c", "-o"], ["-i", "-o"], ["-c", "-w"], ["-m", "3"]]


@pytest.fixture(scope="module")
def dfa_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dfa")
    files = {}
    for k in (80, 100):
        files[k] = d / f"patterns{k}.txt"
        files[k].write_bytes(b"\n".join(make_patterns(k)) + b"\n")
    files["text"] = d / "corpus.txt"
    files["text"].write_bytes(naive.gen_english(17, 15_000))
    return files


@pytest.mark.parametrize("k", [80, 100])
@pytest.mark.parametrize("args", DFA_ARGS, ids=lambda a: " ".join(a))
def test_dfa_cli_parity(dfa_files, monkeypatch, args, k):
    """KREP_TPU_DFA=1 through both CLIs; the port's route ran its walk."""
    monkeypatch.setenv("KREP_TPU_DFA", "1")
    walks = []
    real = ac.dfa_walk
    monkeypatch.setattr(ac, "dfa_walk", lambda *a, **kw: walks.append(1) or real(*a, **kw))
    argv = [*args, "-f", str(dfa_files[k]), str(dfa_files["text"])]
    got = run(cli.main, argv, device="cpu")
    assert got == run(jcli.main, argv)
    assert got[1] == 0 and walks == [1]


def test_dfa_over_the_state_cap_takes_the_grouped_route(dfa_files, monkeypatch):
    """An automaton over MAX_DENSE_STATES (the cap patched down to 50 in
    both packages) takes the grouped route, with the same output."""
    monkeypatch.setenv("KREP_TPU_DFA", "1")
    monkeypatch.setattr(ac, "MAX_DENSE_STATES", 50)
    monkeypatch.setattr(jac, "MAX_DENSE_STATES", 50)
    assert ac.build_dense_ac(make_patterns(100), True) is None
    grouped = []
    real = multi.fused_count_device
    monkeypatch.setattr(multi, "fused_count_device",
                        lambda *a, **kw: grouped.append(1) or real(*a, **kw))
    monkeypatch.setattr(ac, "dfa_walk", None)  # never reached
    for args in (["-c", "-o"], ["-o", "-m", "25"], ["-c"]):
        argv = [*args, "-f", str(dfa_files[100]), str(dfa_files["text"])]
        assert run(cli.main, argv, device="cpu") == run(jcli.main, argv)
    assert grouped == [1]


def test_dfa_search_string_matches_default_route(monkeypatch):
    """The dense route and the grouped route agree (positions, -i, -w)."""
    pats = tuple(make_patterns(120))
    text = naive.gen_english(44, 30_000)
    for kw in (dict(only_matching=True), dict(count_mode=True), dict(case_sensitive=False,
               whole_word=True, only_matching=True), dict(max_count=9, only_matching=True)):
        p = SearchParams(patterns=pats, **kw)
        monkeypatch.delenv("KREP_TPU_DFA", raising=False)
        want = search_string(p, text, device="cpu")
        monkeypatch.setenv("KREP_TPU_DFA", "1")
        got = search_string(p, text, device="cpu")
        assert got.count == want.count and np.array_equal(got.positions, want.positions), kw
