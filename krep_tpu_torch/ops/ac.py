"""Aho-Corasick -> dense DFA, and its walk over the text (KREP_TPU_DFA=1).

Port of krep_tpu/ops/ac.py. The host side is copied: `build_dense_ac`
flattens the reference's 256-pointer trie (aho_corasick.c:17-24, build at
111-271) into a dense `[S, 256] int32` next-state table with
goto-completion (so the walk never follows failure chains), plus a
per-state emission count aggregated over the output chain.

The device side replaces `dfa_scan`, a jax.lax.scan over a copied (L, T)
lane array, with the CUDA kernel csrc/dfa_scan.cu (`dfa_walk`), which walks
the staged text in place, one thread per span with its (maxlen-1)-byte
halo, one gather per byte from the packed table of `pack_dense_table`
(the next state and its emissions in one entry, -i in the columns; in
shared memory for small automata). `dfa_scan_plain` is the lax.scan's step
loop on tensors, over the lanes of `make_lanes` (`dfa_walk_plain` on a
staged text): the kernel's plain version, which `dfa_walk` runs on a CPU
tensor and the tests and chip_smoke.py hold the kernel to.
Emission *positions* come back as a 0/1 mask at each match's last byte;
the host attributes patterns by direct comparison at those ends.
`LAUNCHES` (`MASK_LAUNCHES` of them with a mask) counts kernel launches,
`KIND_LAUNCHES` them by table kind.
"""

from __future__ import annotations

import functools
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from .literal import BLOCK_BYTES

MAX_DENSE_STATES = 1 << 16
TARGET_LANES = 1 << 18  # about the threads an H100 holds at once (132 SMs x 2048)
MIN_SPAN = 16
LINE_SPAN = 128         # spans past it are multiples of it (csrc/dfa_scan.cu kChunk)
MAX_SPAN = 1 << 16
HALO_SPANS = 4          # a span is at least this many halos (the re-walk at most a quarter)
SHARED_MAX_STATES = 184  # csrc/dfa_scan.cu kSharedMaxStates
ROW_STRIDE = 258         # entries a state in the shared table (csrc/dfa_scan.cu kRowStride)
TABLE_KINDS = ("shared", "global", "wide")  # csrc/dfa_scan.cu TableKind

LAUNCHES = 0
MASK_LAUNCHES = 0
KIND_LAUNCHES = dict.fromkeys(TABLE_KINDS, 0)


def fold_np(b: np.ndarray) -> np.ndarray:
    return np.where((b >= 0x41) & (b <= 0x5A), b + 32, b).astype(np.uint8)


def build_dense_ac(patterns: list[bytes], case_sensitive: bool):
    """Returns (next_table [S,256] int32, emit_count [S] int32) or None if
    the automaton would exceed MAX_DENSE_STATES."""
    pats = [p if case_sensitive else bytes(fold_np(np.frombuffer(p, np.uint8))) for p in patterns]

    # trie as dict-of-children per node
    children: list[dict[int, int]] = [{}]
    out_count = [0]
    for p in pats:
        node = 0
        for c in p:
            nxt = children[node].get(c)
            if nxt is None:
                children.append({})
                out_count.append(0)
                nxt = len(children) - 1
                children[node][c] = nxt
            node = nxt
        out_count[node] += 1  # duplicates emit twice (aho_corasick.c output arrays)
        if len(children) > MAX_DENSE_STATES:
            return None

    S = len(children)
    next_table = np.zeros((S, 256), dtype=np.int32)
    fail = np.zeros(S, dtype=np.int32)
    emit = np.array(out_count, dtype=np.int32)

    # BFS: goto-completion + failure links + emission aggregation
    queue = deque()
    for c in range(256):
        nxt = children[0].get(c)
        if nxt is None:
            next_table[0, c] = 0
        else:
            next_table[0, c] = nxt
            fail[nxt] = 0
            queue.append(nxt)
    while queue:
        u = queue.popleft()
        emit[u] += emit[fail[u]]  # output-chain aggregation
        for c in range(256):
            v = children[u].get(c)
            if v is None:
                next_table[u, c] = next_table[fail[u], c]
            else:
                fail[v] = next_table[fail[u], c]
                next_table[u, c] = v
                queue.append(v)
    return next_table, emit


def make_lanes(data: torch.Tensor, maxlen: int, n_lanes: int):
    """krep_tpu's make_lanes on a flat uint8 tensor: L lanes with
    (maxlen-1)-byte prefix halos (zeros before the text). Returns
    (chunks (L, halo+T) uint8, (owned_from (L,), owned_to (L,)) int32,
    chunk)."""
    n = data.shape[0]
    halo = maxlen - 1
    chunk = -(-n // n_lanes)
    padded = torch.zeros(halo + n_lanes * chunk, dtype=torch.uint8, device=data.device)
    padded[halo : halo + n] = data
    # lane i owns [i*chunk, (i+1)*chunk), sees [i*chunk - halo, (i+1)*chunk)
    chunks = padded.unfold(0, halo + chunk, chunk)[:n_lanes].contiguous()
    owned_from = torch.full((n_lanes,), halo, dtype=torch.int32, device=data.device)
    lane_start = torch.arange(n_lanes, dtype=torch.int64, device=data.device) * chunk
    owned_to = (halo + (n - lane_start).clamp(0, chunk)).to(torch.int32)
    return chunks, (owned_from, owned_to), chunk


def dfa_scan_plain(chunks: torch.Tensor, table: torch.Tensor, emit: torch.Tensor, owned,
                   *, want_mask: bool):
    """krep_tpu's dfa_scan as a loop over T on tensors. chunks: (L, T)
    uint8 lanes (halo-prefixed); owned: (owned_from, owned_to), (L,) int32
    each, the time steps of each lane that emit. Returns (total, a 0-d
    int64 tensor, and the (L, T) uint8 0/1 mask of the steps with an
    emission, or None unless want_mask)."""
    L, T = chunks.shape
    flat = table.reshape(-1).to(torch.int64)
    emit = emit.to(torch.int64)
    owned_from, owned_to = owned
    cols = chunks.t().contiguous()
    states = torch.zeros(L, dtype=torch.int64, device=chunks.device)
    total = torch.zeros((), dtype=torch.int64, device=chunks.device)
    mask = torch.zeros((T, L), dtype=torch.uint8, device=chunks.device) if want_mask else None
    for t in range(T):
        states = flat[states * 256 + cols[t]]
        e = torch.where((t >= owned_from) & (t < owned_to), emit[states], 0)
        total += e.sum()
        if want_mask:
            mask[t] = e > 0
    return total, (mask.t().contiguous() if want_mask else None)


def plain_lanes(n: int) -> int:
    """krep_tpu's lane count for n bytes (ac.py:155): 16 to 8192."""
    return int(np.clip(1 << max(0, (n // 4096)).bit_length(), 16, 8192))


def lane_span(body: int, halo: int = 0, target: int = TARGET_LANES) -> int:
    """The kernel's bytes per thread for a staged body and a halo of
    maxlen - 1 bytes: the least span that gives at most `target` threads
    (the card's resident threads of the instance: one launch, one wave) and
    holds HALO_SPANS halos; a power of two up to LINE_SPAN, past it a
    multiple of LINE_SPAN, at most MAX_SPAN."""
    want = max(MIN_SPAN, -(-body // target), HALO_SPANS * halo)
    if want <= LINE_SPAN:
        return 1 << (want - 1).bit_length()
    return min(MAX_SPAN, -(-want // LINE_SPAN) * LINE_SPAN)


@functools.lru_cache(maxsize=64)
def resident_threads(device_index: int, kind: str, mask: bool, table_bytes: int) -> int:
    """The threads the card holds at once of the kernel's instance
    (csrc/dfa_scan.cu krep_dfa_resident_threads)."""
    from . import _build

    with torch.cuda.device(device_index):
        n = _build.library().krep_dfa_resident_threads(TABLE_KINDS.index(kind), int(mask),
                                                       table_bytes)
    if n <= 0:
        raise RuntimeError(f"dfa_scan: no resident threads for the {kind} instance")
    return n


class PackedTable(NamedTuple):
    """The dense automaton as the kernel walks it (pack_dense_table).

    kind "shared": `entries` int16 (uint16 bits), the row of state s at
    entry R(s) = ROW_STRIDE * s + flag(s) (flag: s emits), entry b of it
    R(next state on byte b), the count of a flagged s at R(s) - 1; the
    kernel copies it to shared memory. "global": `entries` int32 [S * 256],
    next state | its emission count << 16. "wide": the same with counts
    clamped to 0xFFFF; the kernel reads the exact ones from `emit` where
    the entry's count is not 0. -i is in the columns: column b holds the
    entry of fold(b). `entry0` is the start state's entry."""

    kind: str
    entries: torch.Tensor
    emit: torch.Tensor
    entry0: int
    case_sensitive: bool

    @property
    def states(self) -> int:
        return self.emit.shape[0]

    def to(self, device) -> "PackedTable":
        return self._replace(entries=self.entries.to(device), emit=self.emit.to(device))


def pack_dense_table(table, emit, case_sensitive: bool, kind: str | None = None) -> PackedTable:
    """build_dense_ac's (table [S, 256], emit [S]) packed for one gather per
    byte, on the CPU. kind None picks "shared" for at most
    SHARED_MAX_STATES states with counts under 2**16, else "global", or
    "wide" for counts past 16 bits (duplicates in a -f list); a kind given
    must hold the set (the tools force "global" and "wide" on small sets)."""
    table = np.asarray(table, np.int32)
    emit = np.asarray(emit, np.int64)
    n_states = table.shape[0]
    cols = np.arange(256, dtype=np.uint8)
    if not case_sensitive:
        cols = fold_np(cols)  # -i: byte b walks as fold(b)
    nxt = table[:, cols]
    narrow = int(emit.max()) <= 0xFFFF
    holds = {"shared": narrow and n_states <= SHARED_MAX_STATES, "global": narrow, "wide": True}
    kind = kind or next(k for k in TABLE_KINDS if holds[k])
    if not holds.get(kind):
        raise ValueError(f"table kind {kind!r} cannot hold {n_states} states with counts to "
                         f"{int(emit.max())}")
    if kind == "shared":
        flag = emit > 0
        base = np.arange(n_states, dtype=np.int64) * ROW_STRIDE + flag
        out = np.zeros(-(-n_states * ROW_STRIDE // 8) * 8, np.uint16)  # whole 16-byte vectors
        out[base[:, None] + np.arange(256)] = base[nxt]
        out[base[flag] - 1] = emit[flag]
        entries, entry0 = torch.from_numpy(out.view(np.int16)), int(base[0])
    else:
        hi = np.minimum(emit, 0xFFFF).astype(np.uint32)[nxt]
        packed = nxt.astype(np.uint32) | hi << np.uint32(16)
        entries, entry0 = torch.from_numpy(packed.reshape(-1).view(np.int32)), 0
    return PackedTable(kind, entries, torch.from_numpy(emit.astype(np.int32)), entry0,
                       case_sensitive)


def dfa_walk_plain(text: torch.Tensor, true_len: int, n_blocks: int, table: torch.Tensor,
                   emit: torch.Tensor, *, maxlen: int, case_sensitive: bool, want_mask: bool,
                   n_lanes: int | None = None):
    """dfa_walk's plain version, on the text's device: dfa_scan_plain over
    make_lanes of the text (folded for -i; krep_tpu's lane count unless
    n_lanes is given, which changes nothing but the time), its (L, T) mask
    put back at the text positions."""
    body = n_blocks * BLOCK_BYTES
    mask = torch.zeros(body, dtype=torch.uint8, device=text.device) if want_mask else None
    if true_len == 0:
        return torch.zeros(1, dtype=torch.int64, device=text.device), mask
    data = text[:true_len]
    if not case_sensitive:
        data = torch.where((data >= 0x41) & (data <= 0x5A), data + 32, data)
    chunks, owned, chunk = make_lanes(data, maxlen, n_lanes or plain_lanes(true_len))
    total, lmask = dfa_scan_plain(chunks, table, emit, owned, want_mask=want_mask)
    if want_mask:
        li, ti = torch.nonzero(lmask, as_tuple=True)
        mask[li * chunk + ti - (maxlen - 1)] = 1  # owned steps only: positions 0..true_len-1
    return total.reshape(1), mask


def dfa_walk(text: torch.Tensor, true_len: int, n_blocks: int, table: torch.Tensor,
             emit: torch.Tensor, *, maxlen: int, case_sensitive: bool, want_mask: bool,
             packed: PackedTable | None = None, span: int | None = None):
    """The dense-DFA walk of the first true_len bytes of a staged text
    (flat uint8, n_blocks * 64 KiB of body): (total, a (1,) int64 tensor of
    the emissions, and the u8 0/1 mask over the body of the positions where
    one ends, None unless want_mask). `table` ([S, 256] int32) and `emit`
    ([S] int32) come from build_dense_ac, on the text's device; maxlen is
    the longest pattern's length. On a CUDA tensor the kernel runs
    (csrc/dfa_scan.cu) on `packed` (pack_dense_table of the same tables
    and case, on the text's device; packed here when None) with `span`
    bytes a thread (when None, lane_span for the threads the card holds of
    the instance; the result does not depend on it), on a CPU tensor
    dfa_walk_plain."""
    body = n_blocks * BLOCK_BYTES
    if text.dim() != 1 or text.dtype != torch.uint8 or text.shape[0] < body or n_blocks < 1:
        raise ValueError("text must be flat uint8 and cover n_blocks * 64 KiB")
    if not 0 <= true_len <= body or not 1 <= maxlen:
        raise ValueError("true_len must lie in the body and maxlen be positive")
    if table.dim() != 2 or table.shape[1] != 256 or emit.shape != (table.shape[0],):
        raise ValueError("table must be [S, 256] and emit [S]")
    if table.device != text.device or emit.device != text.device:
        raise ValueError("table and emit must lie on the text's device")
    if text.device.type == "cpu":
        return dfa_walk_plain(text, true_len, n_blocks, table, emit, maxlen=maxlen,
                              case_sensitive=case_sensitive, want_mask=want_mask)
    if text.device.type != "cuda":
        raise ValueError(f"unsupported device {text.device}")

    from . import _build

    if text.dtype != torch.uint8 or not text.is_contiguous() or text.data_ptr() % 16:
        raise ValueError("text must be a contiguous, 16-byte aligned uint8 tensor")
    if packed is None:
        packed = pack_dense_table(table.cpu().numpy(), emit.cpu().numpy(),
                                  case_sensitive).to(text.device)
    if packed.states != table.shape[0] or packed.case_sensitive != case_sensitive:
        raise ValueError("packed must be the same automaton, packed for the same case")
    if packed.entries.device != text.device or packed.emit.device != text.device:
        raise ValueError("packed must lie on the text's device")
    entries = packed.entries
    table_bytes = entries.numel() * entries.element_size()
    if span is None:
        span = lane_span(body, maxlen - 1, resident_threads(
            text.device.index, packed.kind, want_mask, table_bytes))
    if not (MIN_SPAN <= span <= LINE_SPAN and not span & (span - 1)
            or LINE_SPAN < span <= MAX_SPAN and not span % LINE_SPAN):
        raise ValueError(f"span {span}: a power of two from {MIN_SPAN} to {LINE_SPAN} or a "
                         f"multiple of {LINE_SPAN} up to {MAX_SPAN}")
    total = torch.zeros(1, dtype=torch.int64, device=text.device)
    mask = torch.empty(body, dtype=torch.uint8, device=text.device) if want_mask else None
    stream = torch.cuda.current_stream(text.device).cuda_stream
    with torch.cuda.device(text.device):
        err = _build.library().krep_dfa_scan(
            text.data_ptr(), int(true_len), body, span, maxlen - 1,
            TABLE_KINDS.index(packed.kind), entries.data_ptr(), table_bytes,
            packed.emit.data_ptr(), packed.entry0,
            None if mask is None else mask.data_ptr(), total.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"dfa_scan kernel launch failed: CUDA error {err}")
    global LAUNCHES, MASK_LAUNCHES
    LAUNCHES += 1
    MASK_LAUNCHES += want_mask
    KIND_LAUNCHES[packed.kind] += 1
    return total, mask


def search_dense_dfa(patterns, staged, case_sensitive: bool, want_positions: bool, device):
    """Full multi-pattern scan of a staged text (dispatch.stage on `device`)
    via the dense DFA. Returns (total_count, ends np.ndarray or None), or
    None when the automaton would exceed MAX_DENSE_STATES. ends are the
    sorted absolute end positions (exclusive) where >= 1 pattern ends."""
    from . import dispatch

    built = build_dense_ac(list(patterns), case_sensitive)
    if built is None:
        return None
    dev = torch.device(device)
    table, emit = (torch.from_numpy(a).to(dev) for a in built)
    packed = pack_dense_table(*built, case_sensitive).to(dev) if dev.type == "cuda" else None
    total, mask = dfa_walk(
        staged.u8, staged.true_len, staged.n_blocks, table, emit,
        maxlen=max(len(p) for p in patterns), case_sensitive=case_sensitive,
        want_mask=want_positions, packed=packed,
    )
    ends = None
    if want_positions:
        ends = dispatch.starts_from_device_mask(mask, staged.true_len) + 1
    return int(total), ends
