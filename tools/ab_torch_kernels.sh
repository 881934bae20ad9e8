#!/bin/bash
# A/B of CUDA kernels between two trees on one card, in the order parent,
# change, change, parent, so that both trees meet the same card and tiles.
#
#   git archive <parent> | tar -x -C build/parent     # any directory .gitignore lists
#   cp chip_smoke.py build/parent/                      # both trees read the same tiles
#   bash tools/ab_torch_kernels.sh build/parent LABEL [KERNELS]
#
# Runs `chip_smoke.py --kernels KERNELS` (default: the lane-group kernels K1,
# K6, K7 and K2) once on this tree as a check (it stops there if a case
# fails), then parent, change, change, parent. Writes under chiprun_out/:
# LABEL.<run>.log and LABEL.<run>.jsonl (one line per phase-3 case: kernel,
# plain and bound times), ptxas/LABEL.<library>.log (`nvcc -Xptxas -v` of the
# four scan sources) and LABEL.cuda.log (tests/test_torch_cuda.py on the card).
set -u
cd "$(dirname "$0")/.."
PARENT=$1
LABEL=$2
K=${3:-levenshtein_myers,dp_fused,osa_scan,jaro_scan}
O=chiprun_out
mkdir -p $O/ptxas
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
for f in levenshtein_myers dp_fused osa_scan jaro_scan; do
  /usr/local/cuda/bin/nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
    -Xcompiler -fPIC -Xptxas -v -o "${TMPDIR:-/tmp}/$LABEL.$f.so" strsim_tpu_torch/csrc/$f.cu \
    > $O/ptxas/$LABEL.$f.log 2>&1 &
done
wait
run() {  # tree run-label
  python3 "$1/chip_smoke.py" --kernels $K > $O/$LABEL.$2.log 2>&1
  local rc=$?
  cp "$1/chiprun_out/chip_smoke_kernels.jsonl" $O/$LABEL.$2.jsonl 2>/dev/null
  echo "$2 rc=$rc, $(grep -c exact $O/$LABEL.$2.log) exact cases"
  return $rc
}
run . change0 || { tail -c 4000 $O/$LABEL.change0.log; exit 1; }
grep "ptxas\|phase 2" $O/$LABEL.change0.log
run "$PARENT" parent1
run . change1
run . change2
run "$PARENT" parent2
timeout 900 python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q -p no:cacheprovider \
  > $O/$LABEL.cuda.log 2>&1
echo "cuda tests rc=$?: $(tail -1 $O/$LABEL.cuda.log)"
