#!/bin/bash
# Every (arch, shape) cell of the port's dry run on one mesh, each in a
# process of its own (its own fake process group), N at a time, each cut
# at a time limit:
#
#   scripts/dryrun_cells.sh [MESH] [OUT] [JOBS] [CELL_TIMEOUT_S]
#
# defaults: pod, artifacts/dryrun_torch/<mesh>, 6, 420.  Writes one artifact
# per cell (python -m repro_torch.launch.dryrun) and OUT/summary.txt, one
# line a cell: its exit code (124: cut at the time limit) and seconds.
# The card stays hidden from the processes: the dry run needs no GPU.
set -u
cd "$(dirname "$0")/.."
MESH=${1:-pod}
OUT=${2:-artifacts/dryrun_torch/$MESH}
JOBS=${3:-6}
export CELL_TIMEOUT=${4:-420} MESH OUT
mkdir -p "$OUT"
PYTHONPATH=src python -c "
from repro_torch.configs import base
from repro_torch.launch.shapes import SHAPES
for a in base.list_archs():
    for s in SHAPES:
        print(a + ':' + s)
" > "$OUT/cells.txt"
run() {
  local cell=$1 start
  start=$(date +%s)
  CUDA_VISIBLE_DEVICES= PYTHONPATH=src timeout "$CELL_TIMEOUT" \
    python -m repro_torch.launch.dryrun --arch "${cell%%:*}" \
    --shape "${cell#*:}" --mesh "$MESH" \
    --out "$OUT" --force > "$OUT/${cell//:/__}.log" 2>&1
  echo "$cell rc=$? $(( $(date +%s) - start ))s"
}
export -f run
xargs -P "$JOBS" -I{} bash -c 'run {}' < "$OUT/cells.txt" \
  | tee "$OUT/summary.txt"
