#!/usr/bin/env bash
# End-to-end launcher: install the package, record a synthetic laser log,
# run SLAM on it, print metrics.  The counterpart of the reference's
# startup.sh:1-26 (which builds a simulator Docker image and mounts a shared
# folder); here the "simulator" is the built-in synthetic world and the
# engine runs on an NVIDIA GPU (or, with CPU=1, on the CPU with the GPU
# kernel in interpret mode).
#
# Usage:
#   deploy/launch.sh                 # install + smoke pipeline (512 ticks)
#   SKIP_INSTALL=1 deploy/launch.sh  # pipeline only (already installed)
#   PARTICLES=100000 TICKS=2000 CHUNK=16 deploy/launch.sh  # scale it up (GPU)
set -euo pipefail
cd "$(dirname "$0")/.."

PARTICLES="${PARTICLES:-1024}"
TICKS="${TICKS:-512}"
CHUNK="${CHUNK:-0}"
OUT="${OUT:-runs/deploy_smoke}"
CPU="${CPU:-}"            # CPU=1 forces the CPU platform (dev boxes)

if [ -z "${SKIP_INSTALL:-}" ]; then
  python -m pip install --quiet .
fi

mkdir -p "$OUT"
python -m fastslam_tpu record --ticks "$TICKS" --seed 3 \
    --out "$OUT/log.npz" ${CPU:+--cpu}

RUN_ARGS=(run --log "$OUT/log.npz" --particles "$PARTICLES" --production)
if [ "$CHUNK" != "0" ]; then
  RUN_ARGS+=(--chunk "$CHUNK")
fi
if [ -n "$CPU" ]; then
  RUN_ARGS+=(--cpu)
fi
python -m fastslam_tpu "${RUN_ARGS[@]}"
