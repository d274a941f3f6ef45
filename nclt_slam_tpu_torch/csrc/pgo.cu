// Damped Gauss-Newton on a (junction-reduced) 2-D pose graph for Hopper
// (sm_90a): the whole solve of one graph by one thread block, in one launch.
//
// Replaces the JAX package's Pallas TPU kernel
// nclt_slam_tpu/ops/pgo_pallas.py:_pgo_kernel (behind optimize_pgo_pallas).
// For K poses p_k = (x, y, theta), n_iter times:
//
//   chain edge e -> e+1 with weight odo_w[e] and measurement odo[e], loop
//   edge l: loop_i[l] -> loop_j[l] with weight loop_w[l] (lc_w * valid; an
//   edge of weight 0 adds nothing and is skipped), each the SE(2) relative
//   residual
//     r = [ c dx + s dy - m_x,  -s dx + c dy - m_y,  wrap(t_j - t_i - m_t) ]
//     c, s = cos, sin(t_i);  wrap(a) = a - 2pi floor((a + pi) / 2pi)
//   with the analytic Jacobians J_i, J_j;
//   H = sum w J^T J  + prior_w I3 on pose 0 + damping I,
//   g = sum w J^T r  + prior_w (p_0 - p_0 at input),
//   H dp = -g by Gauss-Jordan (pivot guard 1e-20),  p += dp.
//
// The unknowns are ordered pose-major (3k + c); the TPU kernel's component-
// major order, its one-hot loop selectors, its lane padding of K to 128 with
// unit-pinned poses and its iota masks are Mosaic layout choices with no
// counterpart here.  Loop indices are clamped to [0, K-1], as the TPU wrapper
// clips them.
//
// What bounds it on an H100.  The work is the dense solve: ~N^3 / 2 multiply-
// adds a Gauss-Jordan (N = 3K), against ~100 operations an edge for the
// assembly.  At the fused PGO's reduced graph of 130 poses that is
// 30 MFLOP an iteration, microseconds at the card's float32 rate, and the
// inputs are a few KB.  The N pivot steps are sequential, each a rank-1
// update of the trailing matrix between two barriers of one block, so its
// time is latency and one SM's bandwidth to L2, not the card's rates.
//
// What the design does about it.  The augmented matrix [H | -g] of a reduced
// graph does not fit one block's shared memory (N = 390 needs 610 KB; 227 KB
// hold N <= 240), so it lives in a scratch buffer in device memory, which
// stays in the 50 MB L2 for the whole launch; the poses and the solver's
// pivot row and column live in shared memory.  One thread per pose assembles
// the pose's own three rows: it adds, in a fixed order, its chain edges and
// then every loop edge that names it, so blocks shared by several loops sum
// with no float atomics and a run repeats bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "gauss_jordan.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr float kTwoPi = 6.283185307179586f;

__device__ inline float wrap(float a) {
  return a - kTwoPi * floorf((a + 0.5f * kTwoPi) / kTwoPi);
}

// Residual and Jacobians of the edge pi -> pj against measurement m.
struct EdgeTerms {
  float r[3];
  float Ji[3][3];
  float Jj[3][3];
};

__device__ inline void edge_terms(const float* pi, const float* pj,
                                  const float* m, EdgeTerms& e) {
  const float c = cosf(pi[2]), s = sinf(pi[2]);
  const float dx = pj[0] - pi[0], dy = pj[1] - pi[1];
  const float Rx = c * dx + s * dy;
  const float Ry = -s * dx + c * dy;
  e.r[0] = Rx - m[0];
  e.r[1] = Ry - m[1];
  e.r[2] = wrap(pj[2] - pi[2] - m[2]);
  const float Ji[3][3] = {{-c, -s, Ry}, {s, -c, -Rx}, {0.f, 0.f, -1.f}};
  const float Jj[3][3] = {{c, s, 0.f}, {-s, c, 0.f}, {0.f, 0.f, 1.f}};
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      e.Ji[a][b] = Ji[a][b];
      e.Jj[a][b] = Jj[a][b];
    }
}

// rows 3k..3k+2 of H, columns of pose q: += w A^T B
__device__ inline void add_block(float* aug, int ld, int k, int q, float w,
                                 const float (&A)[3][3],
                                 const float (&B)[3][3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float* row = aug + static_cast<size_t>(3 * k + a) * ld + 3 * q;
#pragma unroll
    for (int b = 0; b < 3; ++b)
      row[b] += w * (A[0][a] * B[0][b] + A[1][a] * B[1][b] +
                     A[2][a] * B[2][b]);
  }
}

// rows 3k..3k+2 of the right-hand side -g: -= w A^T r
__device__ inline void add_rhs(float* aug, int ld, int n, int k, float w,
                               const float (&A)[3][3], const float (&r)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    aug[static_cast<size_t>(3 * k + a) * ld + n] -=
        w * (A[0][a] * r[0] + A[1][a] * r[1] + A[2][a] * r[2]);
}

__global__ void __launch_bounds__(kThreads)
    pgo_kernel(const float* __restrict__ poses, const float* __restrict__ odo,
               const float* __restrict__ odo_w,
               const int* __restrict__ loop_i, const int* __restrict__ loop_j,
               const float* __restrict__ loop_meas,
               const float* __restrict__ loop_w, int K, int L, int n_iter,
               float prior_w, float damping, float* __restrict__ aug,
               float* __restrict__ out) {
  extern __shared__ float smem[];
  float* p = smem;               // 3K current poses
  float* col = p + 3 * K;        // N pivot column
  float* row = col + 3 * K;      // N + 1 pivot row
  const int tid = threadIdx.x;
  const int n = 3 * K;
  const int ld = n + 1;

  for (int i = tid; i < n; i += kThreads) p[i] = poses[i];
  __syncthreads();

  for (int it = 0; it < n_iter; ++it) {
    for (size_t i = tid; i < static_cast<size_t>(n) * ld; i += kThreads)
      aug[i] = 0.f;
    __syncthreads();

    for (int k = tid; k < K; k += kThreads) {
      EdgeTerms e;
      if (k >= 1) {                         // edge k-1 -> k: k is its end
        edge_terms(p + 3 * (k - 1), p + 3 * k, odo + 3 * (k - 1), e);
        const float w = odo_w[k - 1];
        add_block(aug, ld, k, k, w, e.Jj, e.Jj);
        add_block(aug, ld, k, k - 1, w, e.Jj, e.Ji);
        add_rhs(aug, ld, n, k, w, e.Jj, e.r);
      }
      if (k + 1 < K) {                      // edge k -> k+1: k is its start
        edge_terms(p + 3 * k, p + 3 * (k + 1), odo + 3 * k, e);
        const float w = odo_w[k];
        add_block(aug, ld, k, k, w, e.Ji, e.Ji);
        add_block(aug, ld, k, k + 1, w, e.Ji, e.Jj);
        add_rhs(aug, ld, n, k, w, e.Ji, e.r);
      }
      for (int l = 0; l < L; ++l) {
        const float w = loop_w[l];
        const int i = min(max(loop_i[l], 0), K - 1);
        const int j = min(max(loop_j[l], 0), K - 1);
        if (w == 0.f || (i != k && j != k)) continue;
        edge_terms(p + 3 * i, p + 3 * j, loop_meas + 3 * l, e);
        if (i == k) {
          add_block(aug, ld, k, i, w, e.Ji, e.Ji);
          add_block(aug, ld, k, j, w, e.Ji, e.Jj);
          add_rhs(aug, ld, n, k, w, e.Ji, e.r);
        }
        if (j == k) {
          add_block(aug, ld, k, j, w, e.Jj, e.Jj);
          add_block(aug, ld, k, i, w, e.Jj, e.Ji);
          add_rhs(aug, ld, n, k, w, e.Jj, e.r);
        }
      }
      const float pr = k == 0 ? prior_w : 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float* d = aug + static_cast<size_t>(3 * k + a) * ld;
        d[3 * k + a] += pr + damping;
        if (k == 0) d[n] -= prior_w * (p[a] - poses[a]);
      }
    }
    __syncthreads();

    gauss_jordan_solve(aug, n, ld, col, row);

    for (int i = tid; i < n; i += kThreads)
      p[i] += aug[static_cast<size_t>(i) * ld + n];
    __syncthreads();
  }

  for (int i = tid; i < n; i += kThreads) out[i] = p[i];
}

}  // namespace

// Dynamic shared memory, in bytes, for a graph of K poses (the wrapper's
// limit of 2048 poses keeps it within a block's 227 KB).
static int pgo_smem_bytes(int K) {
  return (9 * K + 1) * static_cast<int>(sizeof(float));
}

// Plain C entry point, loaded with ctypes.  Contiguous device buffers:
// poses (K, 3), odo (K-1, 3), odo_w (K-1,), loop_meas (L, 3), loop_w (L,)
// float32; loop_i, loop_j (L,) int32; aug: float32 scratch of 3K x (3K + 1);
// out (K, 3).  Returns the CUDA error code of the launch (0 = launched;
// cudaErrorInvalidValue for K < 2, L < 0 or n_iter < 0).
extern "C" int pgo_solve(const void* poses, const void* odo,
                         const void* odo_w, const void* loop_i,
                         const void* loop_j, const void* loop_meas,
                         const void* loop_w, int K, int L, int n_iter,
                         float prior_w, float damping, void* aug, void* out,
                         void* stream) {
  if (K < 2 || L < 0 || n_iter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = pgo_smem_bytes(K);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pgo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto i32 = [](const void* q) { return static_cast<const int*>(q); };
  pgo_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      f(poses), f(odo), f(odo_w), i32(loop_i), i32(loop_j), f(loop_meas),
      f(loop_w), K, L, n_iter, prior_w, damping, static_cast<float*>(aug),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
