// Dense Gauss-Jordan solve of a damped symmetric positive definite system by
// one thread block, in shared memory.
//
// Shared by the solvers that the JAX package's Pallas TPU kernels run in
// their own bodies (nclt_slam_tpu/ops/ba_pallas.py:_gauss_jordan, which
// nclt_slam_tpu/ops/pgo_pallas.py imports): n pivot steps without pivoting,
// each one rank-1 update of the augmented matrix.  The TPU version extracts
// the pivot row and column by masked reductions because Mosaic has no
// dynamic slice of a value; here they are indexed reads of shared memory.

#pragma once

#include <cuda_runtime.h>

// Solves S x = rhs in place.  aug is the n x (n + 1) augmented matrix
// [S | rhs] with row stride ld (>= n + 1) in shared memory; on return its
// last column holds x and the rest is overwritten.  col (n floats) and row
// (n + 1 floats) are shared scratch.  Every thread of the block calls it
// with the same arguments; blockDim.x is a multiple of 32.  A pivot of
// magnitude <= 1e-20 (or NaN) is replaced by 1, as the reference does.
//
// The pivot row is normalized by a multiplication with 1 / pivot.  The
// reference folds that into the rank-1 update as row - (1 - 1 / pivot) row,
// which keeps only the digits of 1 / pivot that survive beside 1: with the
// bundle adjustment's pivots of 1e4..1e6 that costs two to three decimal
// digits of the solution in float32.
//
// After pivot step c column c is the unit vector e_c, so the pivot row i
// has zeros left of column i and the update touches columns i..n only.
__device__ inline void gauss_jordan_solve(float* aug, int n, int ld,
                                          float* col, float* row) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int ny = nt >> 5;
  for (int i = 0; i < n; ++i) {
    float piv = aug[i * ld + i];
    if (!(fabsf(piv) > 1e-20f)) piv = 1.0f;
    const float inv_piv = 1.0f / piv;
    for (int c = i + tid; c <= n; c += nt) row[c] = aug[i * ld + c] * inv_piv;
    for (int r = tid; r < n; r += nt) col[r] = aug[r * ld + i];
    __syncthreads();
    for (int r = ty; r < n; r += ny) {
      float* a = aug + r * ld;
      if (r == i) {
        for (int c = i + tx; c <= n; c += 32) a[c] = row[c];
      } else {
        const float f = col[r];
        for (int c = i + tx; c <= n; c += 32) a[c] -= f * row[c];
      }
    }
    __syncthreads();
  }
}
