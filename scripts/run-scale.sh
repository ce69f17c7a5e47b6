#!/usr/bin/env bash
# Device-count scaling sweep (reference scripts/run-upmem-scale.sh analog:
# there NR_DPUS swept 1..2048 per operator; here the device axis sweeps
# virtual or real mesh sizes for the distributed join — FORCE_CPU=1 (the
# default) gives the functional weak-scaling curve on a virtual CPU mesh;
# FORCE_CPU=0 on a multi-GPU host bounds the sweep at the real cards).
set -euo pipefail
cd "$(dirname "$0")/.."
mkdir -p bench_out

DEVICES=${DEVICES:-8}
export SCALING_CURVE=1
if [ "${FORCE_CPU:-1}" = "1" ]; then
  export FORCE_CPU=1
fi
FORCE_CPU=${FORCE_CPU:-1} DEVICES=$DEVICES \
  python scripts/bench_multichip.py | tee bench_out/MULTICHIP_SCALING.json
echo "results in bench_out/MULTICHIP_SCALING.json" >&2
