#!/bin/sh
# Registers and spills of each kernel in the given CUDA sources, as ptxas
# reports them (-Xptxas -v) with the flags the kernels are built with
# (point_cloud_classifier_tpu_torch/native/__init__.py: NVCC_FLAGS), one
# nvcc per source, side by side.  Run from the repository root on a machine
# with the CUDA toolkit:
#
#     sh scripts/ptxas_report.sh point_cloud_classifier_tpu_torch/csrc/phi_pool_bwd_rows*.cu
nvcc="${CUDA_HOME:-/usr/local/cuda}/bin/nvcc"
out=$(mktemp -d)
trap 'rm -rf "$out"' EXIT
for src in "$@"; do
  "$nvcc" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -Xptxas -v \
    -c -o "$out/$(basename "$src").o" "$src" > "$out/$(basename "$src").log" 2>&1 &
done
wait
for src in "$@"; do
  echo "== $src"
  grep -E "Compiling entry|registers|spill" "$out/$(basename "$src").log" | sed 's/ptxas info    : //' | paste - - -
done
