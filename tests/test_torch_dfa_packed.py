"""The dense-DFA kernel's design (csrc/dfa_scan.cu) on the CPU: a numpy
model of its steps held to krep_tpu and to the port's plain version.

The model takes `ac.pack_dense_table`'s entries as the kernel does: one
gather per byte (the shared kind's `e = table[e + b]` with its flag bit and
pad-slot count, the global kind's state | count << 16, the wide kind's
count from emit[]), -i in the columns (raw bytes walked), each thread's
span with its (maxlen - 1)-byte halo (zeros before the text), and the mask
written the kernel's way: 16 flag bits a 16-byte step staged per thread,
then each warp's 32 runs of min(span, 128) flags stored as 0/1 bytes, 32
lanes x 4 bytes a store, every store one whole 128-byte line. Totals and
masks must equal krep_tpu.ops.ac.search_dense_dfa (its dfa_scan on its own
make_lanes) and ac.dfa_walk_plain exactly, over spans of 16 to 4096 bytes,
for NUL-led members, -i, every table kind that holds a set, and a
duplicate-heavy -f list whose emission count passes 16 bits.
"""

import numpy as np
import pytest
import torch

import naive
from krep_tpu.ops import ac as jac
from krep_tpu_torch.ops import ac, dispatch
from krep_tpu_torch.tools.bench_hamming import variant_set
from test_dfa import make_patterns

CPU = torch.device("cpu")
SPANS = [16, 32, 64, 128, 256, 384, 1024, 4096, 5376]  # lane_span's kinds of span
CHUNK = 128  # csrc/dfa_scan.cu kChunk


def model_step(kind, tab, emit, e, b):
    """One step of every thread: (next entries, counts, flags)."""
    if kind == "shared":
        e = tab[e + b]
        flag = (e & 1) == 1
        return e, np.where(flag, tab[np.maximum(e - 1, 0)], 0), flag
    e = tab[((e & 0xFFFF) << 8) | b]
    hi = e >> 16
    count = hi if kind == "global" else np.where(hi > 0, emit[e & 0xFFFF], 0)
    return e, count, hi > 0


def spread(nib):
    """The kernel's spread4: a nibble's 4 bits as 4 0/1 bytes."""
    return ((nib[..., None] >> np.arange(4)) & 1).astype(np.uint8)


def model_walk(body: np.ndarray, n: int, packed: ac.PackedTable, span: int, halo: int):
    """csrc/dfa_scan.cu's walk of body[:n] in numpy: (total, 0/1 mask over
    the body)."""
    tab = packed.entries.numpy().view(np.uint16 if packed.kind == "shared" else np.uint32)
    tab = tab.astype(np.int64)
    emit = packed.emit.numpy().astype(np.int64)
    size = body.shape[0]
    lanes = -(-size // span)  # the last span may pass the body
    body = np.concatenate([body, np.zeros(lanes * span - size, np.uint8)])
    start = np.arange(lanes, dtype=np.int64) * span
    own = np.clip(n - start, 0, span)
    e = np.full(lanes, packed.entry0, np.int64)
    for p in range(-halo, 0):  # the halo: state only, zeros before the text
        pos = start + p
        b = np.where(pos >= 0, body[np.maximum(pos, 0)], 0).astype(np.int64)
        e = np.where(own > 0, model_step(packed.kind, tab, emit, e, b)[0], e)
    total = 0
    bits = np.zeros((lanes, span), bool)
    for p in range(span):
        live = p < own
        nxt, count, flag = model_step(packed.kind, tab, emit, e, body[start + p].astype(np.int64))
        e = np.where(live, nxt, e)
        total += int(count[live].sum())
        bits[:, p] = live & flag
    # the staging: per thread a row of 8 uint16 (16 flag bits a step), read
    # as 4 uint32; then warp w's store i, lane l: word g = 32 i + l of its
    # 32 runs, run j = g / (chunk / 4), word q = g % (chunk / 4), nibble q
    chunk = min(span, CHUNK)
    qlog = (chunk // 4).bit_length() - 1
    warps = -(-lanes // 32)
    padded = np.zeros((warps * 32, span), bool)
    padded[:lanes] = bits
    mask = np.full(lanes * span, 2, np.uint8)  # 2: never written
    lane = np.arange(32)
    for c0 in range(0, span, chunk):
        steps = padded[:, c0 : c0 + chunk].reshape(warps * 32, chunk // 16, 16)
        row16 = (steps * (1 << np.arange(16))).sum(-1).astype(np.uint16)
        rows = np.zeros((warps * 32, CHUNK // 16), np.uint16)
        rows[:, : chunk // 16] = row16
        rows32 = rows.view(np.uint32).reshape(warps, 32, CHUNK // 32).astype(np.int64)
        for i in range(chunk // 4):
            g = 32 * i + lane
            j, q = g >> qlog, g & ((1 << qlog) - 1)
            word = rows32[:, j, q >> 3]  # (warps, 32)
            nib = (word >> (4 * (q & 7))) & 15
            run = np.arange(warps)[:, None] * 32 + j
            addr = run * span + c0 + 4 * q
            ok = (run < lanes) & (addr < size)  # no line past the body is stored
            full = ok.all(1)  # a store whose 32 words all lie in the body
            assert (addr[full, 0] % 128 == 0).all() and (np.diff(addr[full], axis=1) == 4).all()
            at = addr[ok][:, None] + np.arange(4)
            assert (mask[at] == 2).all()  # each byte written once
            mask[at] = spread(nib[ok])
    assert (mask[:size] != 2).all() and (mask[size:] == 2).all()
    return total, mask[:size]


def staged_text(seed: int, size: int, lead: bytes = b"") -> tuple[bytes, object]:
    text = lead + naive.gen_english(seed, size - len(lead))
    rng = np.random.default_rng(seed)
    arr = np.frombuffer(text, np.uint8).copy()
    upper = rng.random(arr.shape[0]) < 0.1
    arr[upper & (arr >= 0x61) & (arr <= 0x7A)] -= 32  # some upper case for -i
    text = arr.tobytes()
    return text, dispatch.stage(text, CPU)


def reference(pats, text: bytes, cs: bool):
    """krep_tpu's dense-DFA walk: (total, sorted match ends - 1)."""
    total, ends = jac.search_dense_dfa(list(pats), text, cs, True)
    return total, ends - 1


NUL_LED = (b"\x00\x00t", b"\x00T", b"the", b"he", b"e", b"her", b"\x00")
CASES = {  # name: (patterns, text seed, leading bytes)
    "variants": (variant_set(100), 3, b""),
    "nul-led": (NUL_LED + tuple(make_patterns(20)), 5, b"the"),
    "400 members": (tuple(make_patterns(400)), 7, b""),
    "duplicates": ((b"the",) * 65_600 + tuple(make_patterns(70)), 9, b""),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("cs", [True, False])
def test_kernel_model_matches_krep_tpu(name, cs):
    """Every table kind that holds the set, every span, exactly equal to
    krep_tpu's dfa_scan and to dfa_walk_plain (totals and masks)."""
    pats, seed, lead = CASES[name]
    text, st = staged_text(seed, 70_000, lead)
    want_total, want_ends = reference(pats, text, cs)
    table, emit = ac.build_dense_ac(list(pats), cs)
    maxlen = max(map(len, pats))
    ptotal, pmask = ac.dfa_walk_plain(st.u8, st.n, st.n_blocks, torch.from_numpy(table),
                                      torch.from_numpy(emit), maxlen=maxlen, case_sensitive=cs,
                                      want_mask=True)
    assert int(ptotal) == want_total > 0
    assert np.array_equal(np.flatnonzero(pmask.numpy()), want_ends)
    if name == "nul-led":  # "\x00\x00t" and "\x00t" end at byte 0, after the zero prefix
        assert pmask[0] == 1
    body = st.u8.numpy()[: st.n_blocks * 65536]
    kinds = [k for k in ac.TABLE_KINDS if _holds(k, table, emit)]
    assert ac.pack_dense_table(table, emit, cs).kind == kinds[0]
    for kind in kinds:
        packed = ac.pack_dense_table(table, emit, cs, kind)
        for span in SPANS:
            total, mask = model_walk(body, st.n, packed, span, maxlen - 1)
            assert total == want_total, (kind, span)
            assert np.array_equal(mask, pmask.numpy()), (kind, span)


def _holds(kind, table, emit) -> bool:
    try:
        ac.pack_dense_table(table, emit, True, kind)
    except ValueError:
        return False
    return True


def test_pack_dense_table_kinds():
    """The default kind: shared up to SHARED_MAX_STATES states with counts
    under 2**16, global past it, wide for counts past 16 bits; a kind that
    cannot hold the set is refused."""
    small = ac.build_dense_ac(list(variant_set(100)), True)
    large = ac.build_dense_ac(make_patterns(400), True)
    dups = ac.build_dense_ac([b"ab"] * 70_000, True)
    assert small[0].shape[0] <= ac.SHARED_MAX_STATES < large[0].shape[0]
    assert [ac.pack_dense_table(*t, True).kind for t in (small, large, dups)] == [
        "shared", "global", "wide"]
    for t, kind in ((large, "shared"), (dups, "global"), (dups, "shared")):
        with pytest.raises(ValueError, match="cannot hold"):
            ac.pack_dense_table(*t, True, kind)


@pytest.mark.parametrize("cs", [True, False])
def test_packed_entries_walk_like_the_table(cs):
    """One gather per byte reproduces the table walk: for random states and
    bytes, the entry's next state, count and flag equal table[s, b'] and
    emit of it (b' = fold(b) under -i), in every kind; the shared rows sit
    at ROW_STRIDE * s + flag(s) with a flagged state's count before them."""
    pats = NUL_LED + tuple(make_patterns(60))
    table, emit = ac.build_dense_ac(list(pats), cs)
    rng = np.random.default_rng(1)
    s = rng.integers(0, table.shape[0], 5000)
    b = rng.integers(0, 256, 5000)
    col = b if cs else ac.fold_np(b.astype(np.uint8)).astype(np.int64)
    want_next = table[s, col]
    for kind in ac.TABLE_KINDS:
        packed = ac.pack_dense_table(table, emit, cs, kind)
        tab = packed.entries.numpy().view(np.uint16 if kind == "shared" else np.uint32)
        tab = tab.astype(np.int64)
        if kind == "shared":
            base = np.arange(table.shape[0]) * ac.ROW_STRIDE + (emit > 0)
            assert packed.entry0 == base[0]
            nxt, count, flag = model_step(kind, tab, emit, base[s], b)
            assert np.array_equal(nxt, base[want_next])
        else:
            assert packed.entry0 == 0
            nxt, count, flag = model_step(kind, tab, emit, s, b)
            assert np.array_equal(nxt & 0xFFFF, want_next)
        assert np.array_equal(count, emit[want_next]) and np.array_equal(flag, emit[want_next] > 0)
