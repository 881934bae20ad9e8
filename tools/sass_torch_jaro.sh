#!/bin/bash
# The SASS of the jaro scan K2 (strsim_tpu_torch/csrc/jaro_scan.cu, its kernel
# in csrc/jaro_body.cuh), built as ops/_build.py builds it, with any extra
# nvcc flags given (for example -DSTRSIM_JARO_AHEAD=1):
#
#   bash tools/sass_torch_jaro.sh [NVCC_FLAG ...]
#
# Prints, for each instantiation of jaro_kernel, its instructions, warp
# ballots (VOTE) and divergent-branch regions (BSSY), and writes the SASS of
# the int8 and int32 kernels at 16 lanes a row (no prefix) to
# chiprun_out/sass/ (the whole library's SASS would pass what a chip call
# brings back). Needs the CUDA toolkit.
set -eu
cd "$(dirname "$0")/.."
NVCC=/usr/local/cuda/bin
OUT=chiprun_out/sass
mkdir -p $OUT
LIB="${TMPDIR:-/tmp}/sass_torch_jaro.$$.so"
$NVCC/nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC "$@" \
  -o "$LIB" strsim_tpu_torch/csrc/jaro_scan.cu
$NVCC/cuobjdump -sass "$LIB" > "$LIB.sass"
rm -f "$LIB"
awk '
  /Function :/ { name = $3; sub(/.*jaro_kernel/, "jaro_kernel", name); sub(/EEEv.*/, "E", name) }
  /\/\*[0-9a-f]+\*\// && name != "" { n[name]++ }
  /VOTE/ && name != "" { v[name]++ }
  /BSSY/ && name != "" { b[name]++ }
  END { for (k in n) printf "%s: %d instructions, %d VOTE, %d BSSY\n", k, n[k], v[k], b[k] }
' "$LIB.sass" | sort
for k in IaLi16ELi32ELb1ELi0ELb0E IiLi16ELi32ELb0ELi0ELb0E; do
  awk -v p="jaro_kernel$k" '/Function :/ { on = index($0, p) > 0 } on' "$LIB.sass" > $OUT/jaro_kernel$k.sass
done
rm -f "$LIB.sass"
