#!/bin/bash
# Whether a CUDA source of the port compiles to the same SASS in two trees,
# kernel by kernel, names aside: a kernel keeps its key (its template
# arguments, without the hash that names the anonymous namespace of each
# build) when its parameter list grows, so a redesign that adds a
# template value the old instantiations never take can show that they did
# not change (csrc/jaro_body.cuh's kJaroFlags, built into K2's
# jaro_scan.cu). Built as ops/_build.py builds it:
#
#   bash tools/sass_torch_same.sh TREE_A TREE_B SOURCE     # e.g. build/parent . jaro_scan.cu
#
# Prints each tree's kernel and instruction counts and "same SASS", or the
# kernels whose instructions differ; exits 1 if any does. Needs the CUDA
# toolkit.
set -eu
cd "$(dirname "$0")/.."
NVCC=/usr/local/cuda/bin
TMP="${TMPDIR:-/tmp}/sass_torch_same.$$"
mkdir -p "$TMP"
for side in A B; do
  tree=$([ $side = A ] && echo "$1" || echo "$2")
  $NVCC/nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC \
    -o "$TMP/$side.so" "$tree/strsim_tpu_torch/csrc/$3"
  # one line a instruction: the kernel's key, a tab, the instruction without its address
  $NVCC/cuobjdump -sass "$TMP/$side.so" | awk '
    /Function :/ {  # the anonymous namespace carries a hash of the file: left out
      name = $3; sub(/[0-9]+_GLOBAL__N__[0-9a-f]+_[0-9]+_[A-Za-z0-9_]+_cu_[0-9a-f]+/, "_GLOBAL__N_", name)
      sub(/EEEv.*/, "E", name) }
    /\/\*[0-9a-f]+\*\// && name != "" {
      line = $0; sub(/.*\/\*[0-9a-f]+\*\/ */, "", line); sub(/ *;.*/, "", line); print name "\t" line }
  ' | sort -s -t "$(printf '\t')" -k1,1 > "$TMP/$side.txt"
  echo "$side $tree/$3: $(cut -f1 "$TMP/$side.txt" | uniq | wc -l) kernels, $(wc -l < "$TMP/$side.txt") instructions"
done
if cmp -s "$TMP/A.txt" "$TMP/B.txt"; then
  echo "same SASS"; rc=0
else
  echo "differ:"; diff "$TMP/A.txt" "$TMP/B.txt" | grep '^[<>]' | cut -f1 | sort -u | head -20; rc=1
fi
rm -rf "$TMP"
exit $rc
