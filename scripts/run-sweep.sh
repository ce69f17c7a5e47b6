#!/usr/bin/env bash
# SF sweep of the flagship benchmark (reference scripts/run-upmem-2048.sh
# analog: there NR_DPUS=2048 fixed, SF swept; here the device count is fixed
# by the host and SF sweeps the per-device working set).
set -euo pipefail
cd "$(dirname "$0")/.."

mkdir -p bench_out
OUT=${OUT:-bench_out/sweep_results.jsonl}
: > "$OUT"
for SF in ${SFS:-1 2 4}; do
  echo "--- SF=$SF ---" >&2
  SF=$SF python bench.py | tee -a "$OUT"
done
echo "results in $OUT" >&2
