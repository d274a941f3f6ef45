// Damped Gauss-Newton on a (junction-reduced) 2-D pose graph for Hopper
// (sm_90a): the whole solve of one graph by one thread block, in one launch,
// each step's linear system by a blocked Cholesky factorisation.
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
//   H = L L^T (a diagonal <= 1e-20 or NaN taken as 1, the TPU kernel's
//   pivot guard),  L y = -g,  L^T dp = y,  p += dp.
//
// The unknowns are ordered pose-major (3k + c); the TPU kernel's component-
// major order, its one-hot loop selectors, its lane padding of K to 128 with
// unit-pinned poses and its iota masks are Mosaic layout choices with no
// counterpart here.  Loop indices are clamped to [0, K-1], as the TPU wrapper
// clips them.  H is symmetric positive definite (J^T W J, the damping and
// the prior), so the factorisation needs no pivoting.
//
// What bounds it on an H100.  The work is the dense solve: N^3 / 6 multiply-
// adds a factorisation (N = 3K), against ~250 operations an edge for the
// assembly.  At the fused PGO's reduced graph of 130 poses that is ~10 M
// multiply-adds an iteration, ~40 us at one SM's float32 rate, and the
// inputs are a few KB; the matrix (N = 390: 0.6 MB) does not fit one block's
// 227 KB of shared memory.  What one block pays for is the chain of
// dependent steps between its barriers and the latency of L2.
//
// What the design does about it.  The matrix lives in a scratch buffer in
// device memory (it stays in the 50 MB L2 for the whole launch), padded to a
// multiple of 32 with an identity block, so every panel is 32 wide.  The
// factorisation is right-looking over 32-column panels, N / 32 steps of two
// barriers each where Gauss-Jordan took N pivot steps over the whole matrix:
//   - one warp factors a 32 x 32 diagonal tile in registers, a row a lane,
//     each finished column broadcast through shared memory, and solves the
//     tile's part of the forward substitution L y = -g by shuffles;
//   - every thread solves one row below it against that tile (held in shared
//     memory, transposed), right-looking so that the 32 columns' updates
//     overlap; the row goes back to the scratch buffer and into a chunk of
//     the panel in shared memory (384 rows: the whole panel of a graph of up
//     to 138 poses; a larger graph runs its panel chunk by chunk, the other
//     chunk brought in with cp.async), and updates the rest of y;
//   - the symmetric rank-32 update of the trailing lower triangle goes tile
//     by tile, one warp a 32 x 32 tile: each lane keeps a 4 x 8 micro-tile in
//     registers (16 independent 8-byte loads from L2, four lanes filling a
//     32-byte sector) and reads the panel's rows as 16-byte shared loads,
//     three for 32 fused multiply-adds, without bank conflicts.  Warp 0
//     first updates the next diagonal tile and factors it (look-ahead), so
//     that the next panel's rows start right after the barrier.
// The back substitution L^T dp = y goes panel by panel from the last, one
// barrier each: warp 0 solves the diagonal tile by shuffles while the other
// warps apply the previous tile's solution to the entries above it.  The
// assembly keeps a pose's own blocks in registers.  Shared memory holds the
// poses, two diagonal tiles and two panel chunks: it does not grow with N
// beyond the poses, so the wrapper's limit of 2048 poses fits.  No tensor
// cores, on purpose: the port computes in full float32, and a TF32 product
// keeps about three decimal digits, which the solution's tolerance of 1e-3
// against a float64 solve would not survive (the float32 solvers already
// land 2.5e-4 to 8e-4 from it on the SLAM tool's graph).
//
// Determinism.  One thread per pose assembles the pose's own three rows (the
// lower triangle only): it adds, in a fixed order, its chain edges and then
// every loop edge that names it, so blocks shared by several loops sum with
// no float atomics.  Every sum of the factorisation and the solves runs in a
// fixed order, so a run repeats bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kB = 32;                 // panel width
constexpr int kChunkRows = 384;        // panel rows held in shared memory
constexpr int kChunkTiles = kChunkRows / kB;
constexpr int kPitch = kB + 4;         // floats a panel row in shared memory
constexpr float kTwoPi = 6.283185307179586f;
constexpr unsigned kAll = 0xffffffffu;

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

// B += w A^T C for 3 x 3 blocks (A^T B: a row of A^T times a column of C)
__device__ inline void acc_block(float (&B)[3][3], float w,
                                 const float (&A)[3][3],
                                 const float (&C)[3][3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      B[a][b] += w * (A[0][a] * C[0][b] + A[1][a] * C[1][b] +
                      A[2][a] * C[2][b]);
}

// rows 3k..3k+2 of H, columns of pose q < k: += w A^T C in device memory
__device__ inline void add_block(float* H, int ld, int k, int q, float w,
                                 const float (&A)[3][3],
                                 const float (&C)[3][3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float* row = H + static_cast<size_t>(3 * k + a) * ld + 3 * q;
#pragma unroll
    for (int b = 0; b < 3; ++b)
      row[b] += w * (A[0][a] * C[0][b] + A[1][a] * C[1][b] +
                     A[2][a] * C[2][b]);
  }
}

// g -= w A^T r
__device__ inline void acc_rhs(float (&g)[3], float w, const float (&A)[3][3],
                               const float (&r)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    g[a] -= w * (A[0][a] * r[0] + A[1][a] * r[1] + A[2][a] * r[2]);
}

__device__ inline void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Zero the tiles on and below the diagonal of the npad x npad matrix and the
// right-hand side; the padding rows n..npad-1 get a unit diagonal.
__device__ void clear_system(float* H, float* rhs, int n, int npad) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < npad; r += kWarps) {
    float4* row = reinterpret_cast<float4*>(H + static_cast<size_t>(r) * npad);
    const int n4 = (r / kB + 1) * (kB / 4);
    const int d = r >= n ? r : -1;            // a unit at (r, d)
    for (int s = lane; s < n4; s += 32)
      row[s] = make_float4(d == 4 * s ? 1.f : 0.f, d == 4 * s + 1 ? 1.f : 0.f,
                           d == 4 * s + 2 ? 1.f : 0.f,
                           d == 4 * s + 3 ? 1.f : 0.f);
  }
  for (int r = threadIdx.x; r < npad; r += kThreads) rhs[r] = 0.f;
}

// H and -g of the current poses p (shared) into the cleared system, one
// thread a pose, the lower triangle only (the factorisation reads nothing
// above the diagonal): its chain edges, then every loop edge that names it,
// in order, then the damping and the prior.  The pose's diagonal block and
// right-hand side sum in registers and its block with the previous pose
// starts there; a loop's block with an earlier pose is added in device
// memory, so two loops that join the same two poses sum in loop order.
__device__ void assemble(float* H, float* rhs, int ld, const float* p,
                         const float* poses, const float* odo,
                         const float* odo_w, const int* loop_i,
                         const int* loop_j, const float* loop_meas,
                         const float* loop_w, int K, int L, float prior_w,
                         float damping) {
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float D[3][3] = {}, g[3] = {};
    EdgeTerms e;
    if (k >= 1) {                         // edge k-1 -> k: k is its end
      edge_terms(p + 3 * (k - 1), p + 3 * k, odo + 3 * (k - 1), e);
      const float w = odo_w[k - 1];
      float P[3][3] = {};
      acc_block(D, w, e.Jj, e.Jj);
      acc_block(P, w, e.Jj, e.Ji);
      acc_rhs(g, w, e.Jj, e.r);
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
          H[static_cast<size_t>(3 * k + a) * ld + 3 * (k - 1) + b] = P[a][b];
    }
    if (k + 1 < K) {                      // edge k -> k+1: k is its start
      edge_terms(p + 3 * k, p + 3 * (k + 1), odo + 3 * k, e);
      const float w = odo_w[k];
      acc_block(D, w, e.Ji, e.Ji);
      acc_rhs(g, w, e.Ji, e.r);
    }
    for (int l = 0; l < L; ++l) {
      const float w = loop_w[l];
      const int i = min(max(loop_i[l], 0), K - 1);
      const int j = min(max(loop_j[l], 0), K - 1);
      if (w == 0.f || (i != k && j != k)) continue;
      edge_terms(p + 3 * i, p + 3 * j, loop_meas + 3 * l, e);
      if (i == k) {
        acc_block(D, w, e.Ji, e.Ji);
        if (j == k) acc_block(D, w, e.Ji, e.Jj);
        else if (j < k) add_block(H, ld, k, j, w, e.Ji, e.Jj);
        acc_rhs(g, w, e.Ji, e.r);
      }
      if (j == k) {
        acc_block(D, w, e.Jj, e.Jj);
        if (i == k) acc_block(D, w, e.Jj, e.Ji);
        else if (i < k) add_block(H, ld, k, i, w, e.Jj, e.Ji);
        acc_rhs(g, w, e.Jj, e.r);
      }
    }
    const float pr = k == 0 ? prior_w : 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      D[a][a] += pr + damping;
      if (k == 0) g[a] -= prior_w * (p[a] - poses[a]);
      rhs[3 * k + a] = g[a];
#pragma unroll
      for (int b = 0; b <= a; ++b)
        H[static_cast<size_t>(3 * k + a) * ld + 3 * k + b] = D[a][b];
    }
  }
}

// One warp: factor the diagonal tile J in place, L_JJ L_JJ^T = H_JJ (zeros
// above the diagonal), a row a lane in registers, each finished column
// passed to the other lanes through LT; a diagonal <= 1e-20 or NaN is taken
// as 1.  Leaves L_JJ^T in LT (shared, row-major), the diagonal's
// reciprocals in R (shared) and RG (device memory, for the back
// substitution), and solves the tile's part of the forward substitution,
// y_J = L_JJ^-1 rhs_J, into y and rhs.  Not inlined: the unrolled body is
// long, and one copy of it (not one a call site) was faster on the card.
__device__ __noinline__ void factor_tile(float* H, int ld, int J,
                                         float* rhs, float* LT, float* R,
                                         float* RG, float* y) {
  const int lane = threadIdx.x & 31;
  const int t0 = J * kB;
  float* row = H + static_cast<size_t>(t0 + lane) * ld + t0;
  float a[kB];
#pragma unroll
  for (int k = 0; k < kB; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + k);
    a[k] = v.x; a[k + 1] = v.y; a[k + 2] = v.z; a[k + 3] = v.w;
  }
  float rl = 0.f;                             // 1 / L[lane][lane]
#pragma unroll
  for (int c = 0; c < kB; ++c) {
    float d = __shfl_sync(kAll, a[c], c);
    if (!(d > 1e-20f)) d = 1.f;
    const float lcc = sqrtf(d);
    const float inv = 1.f / lcc;
    if (lane == c) rl = inv;
    a[c] = lane == c ? lcc : (lane > c ? a[c] * inv : 0.f);
    LT[c * kB + lane] = a[c];
    __syncwarp();
#pragma unroll
    for (int k = (c + 1) & ~3; k < kB; k += 4) {
      const float4 l = *reinterpret_cast<const float4*>(LT + c * kB + k);
      if (k > c && lane >= k) a[k] = fmaf(-a[c], l.x, a[k]);
      if (k + 1 > c && lane >= k + 1) a[k + 1] = fmaf(-a[c], l.y, a[k + 1]);
      if (k + 2 > c && lane >= k + 2) a[k + 2] = fmaf(-a[c], l.z, a[k + 2]);
      if (k + 3 > c && lane >= k + 3) a[k + 3] = fmaf(-a[c], l.w, a[k + 3]);
    }
  }
#pragma unroll
  for (int k = 0; k < kB; k += 4)
    *reinterpret_cast<float4*>(row + k) =
        make_float4(a[k], a[k + 1], a[k + 2], a[k + 3]);
  R[lane] = rl;
  RG[t0 + lane] = rl;
  float b = rhs[t0 + lane];
#pragma unroll
  for (int c = 0; c < kB; ++c) {
    if (lane == c) b *= rl;
    const float yc = __shfl_sync(kAll, b, c);
    if (lane > c) b = fmaf(-a[c], yc, b);
  }
  y[lane] = b;
  rhs[t0 + lane] = b;
}

// Rows r0..r0+nr-1 of panel column t0: x L_JJ^T = a, a row a thread, by
// substitution against LT = L_JJ^T and R (the diagonal's reciprocals),
// right-looking so that the 32 columns' updates overlap; each row goes back
// to H and into buf (pitch kPitch), and the forward substitution's
// rhs_r -= L_rJ y_J.
__device__ void panel_rows(float* H, int ld, int t0, int r0, int nr,
                           const float* LT, const float* R, const float* y,
                           float* rhs, float* buf) {
  for (int t = threadIdx.x; t < nr; t += kThreads) {
    float* row = H + static_cast<size_t>(r0 + t) * ld + t0;
    float a[kB];
#pragma unroll
    for (int k = 0; k < kB; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + k);
      a[k] = v.x; a[k + 1] = v.y; a[k + 2] = v.z; a[k + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < kB; ++c) {
      a[c] *= R[c];
#pragma unroll
      for (int k = (c + 1) & ~3; k < kB; k += 4) {
        const float4 l = *reinterpret_cast<const float4*>(LT + c * kB + k);
        if (k > c) a[k] = fmaf(-a[c], l.x, a[k]);
        if (k + 1 > c) a[k + 1] = fmaf(-a[c], l.y, a[k + 1]);
        if (k + 2 > c) a[k + 2] = fmaf(-a[c], l.z, a[k + 2]);
        if (k + 3 > c) a[k + 3] = fmaf(-a[c], l.w, a[k + 3]);
      }
    }
    float s = rhs[r0 + t];
#pragma unroll
    for (int c = 0; c < kB; ++c) s = fmaf(-a[c], y[c], s);
    rhs[r0 + t] = s;
#pragma unroll
    for (int k = 0; k < kB; k += 4) {
      const float4 v = make_float4(a[k], a[k + 1], a[k + 2], a[k + 3]);
      *reinterpret_cast<float4*>(row + k) = v;
      *reinterpret_cast<float4*>(buf + t * kPitch + k) = v;
    }
  }
}

// Rows r0..r0+nr-1 of panel column t0, from H into buf, by cp.async.
__device__ void load_panel_rows(const float* H, int ld, int t0, int r0,
                                int nr, float* buf) {
  for (int i = threadIdx.x; i < nr * (kB / 4); i += kThreads) {
    const int r = i / (kB / 4), s = i % (kB / 4);
    cp_async16(buf + r * kPitch + 4 * s,
               H + static_cast<size_t>(r0 + r) * ld + t0 + 4 * s);
  }
  cp_async_wait_all();
}

// One warp: tile (I, K) of H -= P_I P_K^T, P_I and P_K the panel's rows of
// the two tiles in shared memory (pitch kPitch).  Lane (ty, tx) keeps rows
// ty + 8i (i < 4) and the column pairs 2tx + 8j, +1 (j < 4) in registers:
// four lanes read 32 consecutive bytes of a row of H, and the lanes' shared
// loads fall in distinct banks.
__device__ void update_tile(float* H, int ld, int I, int K, const float* PI,
                            const float* PK) {
  const int lane = threadIdx.x & 31;
  const int ty = lane >> 2, tx = lane & 3;
  float* C = H + static_cast<size_t>(I * kB + ty) * ld + K * kB + 2 * tx;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 c = *reinterpret_cast<const float2*>(
          C + static_cast<size_t>(8 * i) * ld + 8 * j);
      acc[i][2 * j] = c.x;
      acc[i][2 * j + 1] = c.y;
    }
#pragma unroll 1
  for (int k = 0; k < kB; k += 4) {
    float4 a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(PI + (ty + 8 * i) * kPitch + k);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = *reinterpret_cast<const float4*>(
          PK + (2 * tx + 8 * (j >> 1) + (j & 1)) * kPitch + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] = fmaf(-a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(-a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(-a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(-a[i].w, b[j].w, acc[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(C + static_cast<size_t>(8 * i) * ld + 8 * j) =
          make_float2(acc[i][2 * j], acc[i][2 * j + 1]);
}

struct Shared {
  float* bufA;  // panel chunk of tiles I
  float* bufB;  // panel chunk of tiles K
  float* LT;    // 2 x kB x kB: L_JJ^T by the panel's parity
  float* R;     // 2 x kB: 1 / diag(L_JJ) by the panel's parity
  float* y;     // 2 x kB: y_J by the panel's parity
  float* v;     // 2 x kB: the back substitution's x_J by parity
};

// H = L L^T in place (the tiles on and below the diagonal) and
// rhs = L^-1 rhs, npad a multiple of kB.  Right-looking: panel J's rows are
// solved against its factored diagonal tile, then the trailing lower
// triangle is updated; during that update warp 0 first updates and factors
// the next diagonal tile (look-ahead), so that the next panel starts at
// once.  RG receives the reciprocals of L's diagonal.
__device__ void cholesky(float* H, int npad, float* rhs, float* RG,
                         const Shared& sm) {
  const int nb = npad / kB;
  const int warp = threadIdx.x >> 5;
  if (warp == 0) factor_tile(H, npad, 0, rhs, sm.LT, sm.R, RG, sm.y);
  __syncthreads();
  for (int J = 0; J + 1 < nb; ++J) {
    const int t0 = J * kB;
    const int cur = J & 1, nxt = cur ^ 1;
    const int below = nb - J - 1;                 // tiles below the diagonal
    const int n_chunks = (below + kChunkTiles - 1) / kChunkTiles;
    for (int cI = 0; cI < n_chunks; ++cI) {
      const int i0 = J + 1 + cI * kChunkTiles;    // first tile of chunk cI
      const int nI = min(kChunkTiles, nb - i0);
      panel_rows(H, npad, t0, i0 * kB, nI * kB, sm.LT + cur * kB * kB,
                 sm.R + cur * kB, sm.y + cur * kB, rhs, sm.bufA);
      __syncthreads();
      for (int cK = 0; cK <= cI; ++cK) {
        const int k0 = J + 1 + cK * kChunkTiles;
        const float* PK = sm.bufA;
        int n_tiles = nI * (nI + 1) / 2;
        if (cK < cI) {
          load_panel_rows(H, npad, t0, k0 * kB, kChunkTiles * kB, sm.bufB);
          __syncthreads();
          PK = sm.bufB;
          n_tiles = nI * kChunkTiles;
        }
        // tile 0 of the first pair is the next diagonal tile: warp 0's
        int t = warp, step = kWarps;
        if (cK == 0 && cI == 0) {
          if (warp == 0) {
            update_tile(H, npad, J + 1, J + 1, sm.bufA, sm.bufA);
            __syncwarp();
            factor_tile(H, npad, J + 1, rhs, sm.LT + nxt * kB * kB,
                        sm.R + nxt * kB, RG, sm.y + nxt * kB);
            t = n_tiles;
          } else {
            step = kWarps - 1;
          }
        }
        for (; t < n_tiles; t += step) {
          int i, k;
          if (cK < cI) {
            i = t / kChunkTiles;
            k = t % kChunkTiles;
          } else {                                // k <= i, row by row
            i = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
            while (i * (i + 1) / 2 > t) --i;
            while ((i + 1) * (i + 2) / 2 <= t) ++i;
            k = t - i * (i + 1) / 2;
          }
          update_tile(H, npad, i0 + i, k0 + k, sm.bufA + i * kB * kPitch,
                      PK + k * kB * kPitch);
        }
        __syncthreads();
      }
    }
  }
}

// rhs = L^-T rhs (rhs holds y = L^-1 (-g) on entry), panel by panel from the
// last: warp 0 takes tile J's part of the update by x_{J+1} and solves
// L_JJ^T x_J = (...) by shuffles, while the other warps apply x_{J+1} to
// the entries above tile J; one barrier a panel.
__device__ void back_substitute(const float* H, int npad, float* rhs,
                                const float* RG, const Shared& sm) {
  const int nb = npad / kB;
  for (int J = nb - 1; J >= 0; --J) {
    const int t0 = J * kB;
    const bool has_next = J + 1 < nb;
    const float* xn = sm.v + ((J + 1) & 1) * kB;        // x_{J+1}
    const float* Pn = H + static_cast<size_t>(t0 + kB) * npad;
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      float u[kB];                                      // column lane of L_JJ
#pragma unroll
      for (int c = 0; c < kB; ++c)
        u[c] = H[static_cast<size_t>(t0 + c) * npad + t0 + lane];
      const float rl = RG[t0 + lane];
      float s = rhs[t0 + lane];
      if (has_next) {
#pragma unroll
        for (int r = 0; r < kB; ++r)
          s = fmaf(-Pn[static_cast<size_t>(r) * npad + t0 + lane], xn[r], s);
      }
#pragma unroll
      for (int c = kB - 1; c >= 0; --c) {
        if (lane == c) s *= rl;
        const float xc = __shfl_sync(kAll, s, c);
        if (lane < c) s = fmaf(-u[c], xc, s);
      }
      rhs[t0 + lane] = s;
      sm.v[(J & 1) * kB + lane] = s;
    } else if (has_next) {
      for (int c = threadIdx.x - 32; c < t0; c += kThreads - 32) {
        float s = rhs[c];
#pragma unroll
        for (int r = 0; r < kB; ++r)
          s = fmaf(-Pn[static_cast<size_t>(r) * npad + c], xn[r], s);
        rhs[c] = s;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    pgo_kernel(const float* __restrict__ poses, const float* __restrict__ odo,
               const float* __restrict__ odo_w,
               const int* __restrict__ loop_i, const int* __restrict__ loop_j,
               const float* __restrict__ loop_meas,
               const float* __restrict__ loop_w, int K, int L, int n_iter,
               float prior_w, float damping, float* H,
               float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  Shared sm;
  sm.bufA = smem;
  sm.bufB = sm.bufA + kChunkRows * kPitch;
  sm.LT = sm.bufB + kChunkRows * kPitch;
  sm.R = sm.LT + 2 * kB * kB;
  sm.y = sm.R + 2 * kB;
  sm.v = sm.y + 2 * kB;
  float* p = sm.v + 2 * kB;                  // 3K current poses
  const int n = 3 * K;
  const int npad = (n + kB - 1) / kB * kB;
  float* rhs = H + static_cast<size_t>(npad) * npad;
  float* RG = rhs + npad;                    // 1 / diag(L)

  for (int i = threadIdx.x; i < n; i += kThreads) p[i] = poses[i];
  __syncthreads();

  for (int it = 0; it < n_iter; ++it) {
    clear_system(H, rhs, n, npad);
    __syncthreads();
    assemble(H, rhs, npad, p, poses, odo, odo_w, loop_i, loop_j, loop_meas,
             loop_w, K, L, prior_w, damping);
    __syncthreads();
    cholesky(H, npad, rhs, RG, sm);
    back_substitute(H, npad, rhs, RG, sm);
    for (int i = threadIdx.x; i < n; i += kThreads) p[i] += rhs[i];
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += kThreads) out[i] = p[i];
}

}  // namespace

// Dynamic shared memory, in bytes, for a graph of K poses (the wrapper's
// limit of 2048 poses keeps it within a block's 227 KB: 141 KB).
static int pgo_smem_bytes(int K) {
  return (2 * kChunkRows * kPitch + 2 * kB * kB + 6 * kB + 3 * K) *
         static_cast<int>(sizeof(float));
}

// Plain C entry point, loaded with ctypes.  Contiguous device buffers:
// poses (K, 3), odo (K-1, 3), odo_w (K-1,), loop_meas (L, 3), loop_w (L,)
// float32; loop_i, loop_j (L,) int32; scratch: float32 of npad * (npad + 2)
// (the matrix, the right-hand side and the reciprocals of L's diagonal),
// npad = 3K rounded up to a multiple of 32, 16-byte aligned; out (K, 3).
// Returns the CUDA error code of the launch (0 = launched;
// cudaErrorInvalidValue for K < 2, L < 0 or n_iter < 0).
extern "C" int pgo_solve(const void* poses, const void* odo,
                         const void* odo_w, const void* loop_i,
                         const void* loop_j, const void* loop_meas,
                         const void* loop_w, int K, int L, int n_iter,
                         float prior_w, float damping, void* scratch,
                         void* out, void* stream) {
  if (K < 2 || L < 0 || n_iter < 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = pgo_smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      pgo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto i32 = [](const void* q) { return static_cast<const int*>(q); };
  pgo_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      f(poses), f(odo), f(odo_w), i32(loop_i), i32(loop_j), f(loop_meas),
      f(loop_w), K, L, n_iter, prior_w, damping, static_cast<float*>(scratch),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
