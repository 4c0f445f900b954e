#!/usr/bin/env bash
# Head-to-head of krep_tpu_torch against the C krep binary (the port of
# tools/bench_vs_reference.sh): the counts must agree before anything is
# timed. Times the reference, the port's one-shot CLI (a new process each
# run: interpreter, torch import, CUDA context, staging) and the port's
# resident client (krep_tpu_torch/native/client.c; the daemon it starts
# keeps torch, the CUDA context and the kernels warm), each the mean of
# RUNS warm-cache runs; prints the card's name and power limit beside them.
#
# Usage: krep_tpu_torch/tools/bench_vs_reference.sh [CORPUS] [PATTERN] [RUNS]
#   CORPUS  default: $KREP_BENCH_CORPUS_DIR (or krep_bench_corpus in the
#           temporary directory)/bench_1073741824.txt, which
#           `python -m krep_tpu_torch.tools.bench` writes
#   KREP_REF  the reference binary (default /tmp/krep_oracle/krep)
set -euo pipefail

CORPUS="${1:-${KREP_BENCH_CORPUS_DIR:-${TMPDIR:-/tmp}/krep_bench_corpus}/bench_1073741824.txt}"
PATTERN="${2:-the}"
RUNS="${3:-3}"
REF_BIN="${KREP_REF:-/tmp/krep_oracle/krep}"
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"

if [[ ! -f "$CORPUS" ]]; then
  echo "corpus missing — run 'python -m krep_tpu_torch.tools.bench' once to generate it" >&2
  exit 1
fi
if [[ ! -x "$REF_BIN" ]]; then
  echo "reference binary missing at $REF_BIN (set KREP_REF)" >&2
  exit 1
fi

CLIENT=$(python -m krep_tpu_torch.native.client)
count() { "$@" | awk -F: '{print $NF}'; }
ref_count=$(count "$REF_BIN" -c -t 1 "$PATTERN" "$CORPUS")
ours_count=$(count python -m krep_tpu_torch.cli -c "$PATTERN" "$CORPUS")
client_count=$(count "$CLIENT" -c "$PATTERN" "$CORPUS")
if [[ "$ours_count" != "$ref_count" || "$client_count" != "$ref_count" ]]; then
  echo "COUNT MISMATCH: cli=$ours_count client=$client_count reference=$ref_count" >&2
  python -m krep_tpu_torch.daemon --stop >/dev/null 2>&1 || true
  exit 1
fi
echo "count parity OK ($ref_count matching lines)"

avg() {
  local total=0 t0 t1
  for _ in $(seq "$RUNS"); do
    t0=$(date +%s.%N)
    "$@" >/dev/null 2>&1 || true
    t1=$(date +%s.%N)
    total=$(awk -v a="$total" -v s="$t0" -v e="$t1" 'BEGIN{print a+(e-s)}')
  done
  awk -v s="$total" -v r="$RUNS" 'BEGIN{printf "%.3f", s/r}'
}

echo "card: $(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null || echo none)"
echo "reference (all cores, warm cache): $(avg "$REF_BIN" -c "$PATTERN" "$CORPUS")s"
echo "krep_tpu_torch one-shot CLI (new process each run): $(avg python -m krep_tpu_torch.cli -c "$PATTERN" "$CORPUS")s"
echo "krep_tpu_torch resident client (daemon warm): $(avg "$CLIENT" -c "$PATTERN" "$CORPUS")s"
python -m krep_tpu_torch.daemon --stop >/dev/null 2>&1 || true
