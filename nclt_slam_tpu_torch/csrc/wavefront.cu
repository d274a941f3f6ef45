// Wavefront potential relaxation for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// nclt_slam_tpu/ops/wavefront_pallas.py:_relax_kernel.  For each grid of a
// batch it runs n_iter Jacobi iterations of
//
//     phi <- min(phi, min over 8 neighbours n of phi[n] + s_n * tc)
//
// with s_n = 1 (orthogonal) or 1.4142135 (diagonal), tc the receiving
// cell's cost and BIG = 1e9 for a neighbour outside the grid.  The planner
// calls it on (15, 192, 192) windows and on the (15, 119, 232) coarse map,
// 384 iterations each.
//
// Exactness.  The result must equal the JAX package's XLA loop and Pallas
// kernel bit for bit, so: every iteration reads only the previous
// iteration's phi (Jacobi), the trip count is fixed (no early exit),
// tc * 1.4142135f is rounded once and then added, and nothing is contracted
// into an FMA (__fmul_rn / __fadd_rn, and the library builds with
// --fmad=false).  The kernel takes the minimum of the four orthogonal (the
// four diagonal) neighbours before it adds tc (tc * s): rounded addition
// of a fixed addend is monotonic, so min(a + t, b + t) and min(a, b) + t
// round to the same float, and 6 of the 8 additions go.
//
// What bounds it on an H100.  The 384 iterations are a dependent chain of
// passes over the grid, each a few shared-memory loads, adds and mins per
// cell; device memory is touched once (tc and phi0 read, phi written).  So
// the time is the chain's length times one pass: the issue and
// shared-memory rate of the SMs that share a grid, plus whatever barrier
// joins them between passes.  The first version (one block a grid) kept 15
// of 132 SMs busy, re-read tc from L2 every pass and waited at two block
// barriers a pass: 6.05 ms a window call.
//
// What the design does about it.  Each grid is relaxed by a cluster of 8
// blocks on 8 SMs (15 grids = 120 blocks, one wave: the card holds 15 such
// clusters at once).  Rank k owns a band of R = ceil(H / 8) rows and holds
// in shared memory its band plus h halo rows on each side, (R + 2h) rows
// with a BIG border column, twice (ping-pong: one block barrier a step),
// and tc for its rows in registers (loaded once).  The block runs rounds
// of s = min(h, left) local Jacobi steps: each step's valid rows shrink by
// one on each side, so after s <= h steps its band is exact (temporal
// blocking; redundant work on halo rows changes no bit, since each cell's
// update is the same rounded arithmetic on the same inputs).  Every step
// stores every row it computes, valid or not (no predicate), and a row
// outside the grid carries tc = inf so that it stays BIG (fminf drops the
// NaN of inf + -inf as well).  Then each block
// stores its first and last h band rows, as float4 where W % 4 == 0, into
// the mailboxes of ranks k - 1 and k + 1 through distributed shared memory,
// and the cluster meets at one barrier (arrive.release / wait.acquire);
// after it each block copies its mailboxes into its halo rows.  h <= R, so
// halos come from adjacent ranks only.  Mailboxes alternate by round
// parity: a rank stores into a neighbour's slot for round r + 2 only after
// the barrier of round r + 1, which the neighbour reaches after it has read
// round r's slot.  Rows outside the grid hold BIG in every buffer, so empty
// bands (H < 8) and the short last band need no special case, and every
// block runs every barrier.  No tensor cores (min-plus) and no atomics
// (the Jacobi order is part of the result).
//
// Measured rounds (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6,
// tools/torch_wavefront_probe.py), window / coarse call: the first version
// 6.08 / 4.13 ms; round 1 (h = 1, row predicates, scalar exchange) 0.77 /
// 0.68; round 2 (h = 4) 0.53 / 0.50; round 3 (no predicates, float4 rows
// pushed to mailboxes) 0.39 / 0.44 at h = 8, the depth kept.  Pulling the
// halo rows from the neighbours' buffers instead (a second barrier, its
// wait hidden behind a step) was slower, 0.46 / 0.51: a remote load waits
// its round trip, a remote store does not.  One cluster barrier alone
// costs 0.72 us (~1,440 cycles), 0.28 ms for 384 of them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#ifdef WAVEFRONT_PROFILE
// per-phase clock64 cycles summed over blocks (thread 0 of each), and the
// number of blocks that added to them (tools/torch_wavefront_probe.py)
__device__ unsigned long long g_prof[8];
#define PROF_INIT                                 \
  long long prof_t = clock64();                   \
  unsigned long long prof_acc[6] = {0, 0, 0, 0, 0, 0}
#define PROF_STAMP(i)                       \
  do {                                      \
    const long long t_ = clock64();         \
    prof_acc[i] += t_ - prof_t;             \
    prof_t = t_;                            \
  } while (0)
#define PROF_FLUSH                                                  \
  do {                                                              \
    if (threadIdx.x == 0 && threadIdx.y == 0) {                     \
      for (int i_ = 0; i_ < 6; ++i_) atomicAdd(&g_prof[i_], prof_acc[i_]); \
      atomicAdd(&g_prof[7], 1ull);                                  \
    }                                                               \
  } while (0)
#else
#define PROF_INIT
#define PROF_STAMP(i)
#define PROF_FLUSH
#endif

namespace {

constexpr float kBig = 1e9f;
constexpr float kDiag = 1.4142135f;
constexpr int kCluster = 8;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" : : : "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" : : : "memory");
}

// Local column c of a buffer row lives at kOff + c; c = -1 and c = W hold
// BIG.  The pitch is a multiple of 4, so with W % 4 == 0 every row's first
// column is 16-byte aligned and rows move as float4.
constexpr int kOff = 4;

__host__ __device__ inline int pitch(int W) { return (W + kOff + 1 + 3) & ~3; }

// One Jacobi step over this thread's strip: local rows i0 .. i0 + n - 1 of
// column c, read from `cur`, stored into `nxt`.  A rolling 3 x 3 window
// (u = row i - 1, m = row i, d = row i + 1; L/C/R = columns c - 1, c,
// c + 1) loads 3 values a cell.  Every row of the strip is stored: a row
// outside the step's valid range holds a value no valid row reads before
// the halo refresh overwrites it, and a row outside the grid has t = td =
// inf, so it stores min(BIG, inf) = BIG whatever its neighbours hold.
template <int MAX_ROWS, bool FULL>
__device__ __forceinline__ void relax_strip(
    const float* __restrict__ cur, float* __restrict__ nxt, int P, int c,
    int i0, int n, const float (&t)[MAX_ROWS], const float (&td)[MAX_ROWS]) {
  const float* p = cur + (i0 - 1) * P + kOff - 1 + c;
  float* q = nxt + i0 * P + kOff + c;
  float uL = p[0], uC = p[1], uR = p[2];
  p += P;
  float mL = p[0], mC = p[1], mR = p[2];
#pragma unroll
  for (int k = 0; k < MAX_ROWS; ++k) {
    if (FULL || k < n) {
      p += P;
      const float dL = p[0], dC = p[1], dR = p[2];
      const float o = fminf(fminf(uC, dC), fminf(mL, mR));
      const float d = fminf(fminf(uL, uR), fminf(dL, dR));
      q[k * P] = fminf(mC, fminf(__fadd_rn(o, t[k]), __fadd_rn(d, td[k])));
      uL = mL; uC = mC; uR = mR;
      mL = dL; mC = dC; mR = dR;
    }
  }
}

// `rows` rows of W floats from src (row pitch sp) to dst (pitch dp), as
// float4 where W % 4 == 0 (both then start 16-byte aligned); dst or src may
// be another block's shared memory.
__device__ __forceinline__ void copy_rows(float* dst, int dp,
                                          const float* src, int sp, int rows,
                                          int W, int tid, int nthreads) {
  if ((W & 3) == 0) {
    const int Q = W >> 2;
    for (int idx = tid; idx < rows * Q; idx += nthreads) {
      const int r = idx / Q;
      reinterpret_cast<float4*>(dst + r * dp)[idx - r * Q] =
          reinterpret_cast<const float4*>(src + r * sp)[idx - r * Q];
    }
  } else {
    for (int idx = tid; idx < rows * W; idx += nthreads) {
      const int r = idx / W;
      dst[r * dp + idx - r * W] = src[r * sp + idx - r * W];
    }
  }
}

// Grid: kCluster blocks a grid (cluster dims (kCluster, 1, 1)); block: W x
// ty threads, thread (c, y) owns column c and the local rows
// 1 + y * rows ... of [1, L - 1).  Shared memory: two (L, pitch(W)) phi
// buffers, then mailboxes [2 parities][2 sides: from above, from below]
// [h][W].
template <int MAX_ROWS>
__global__ void __launch_bounds__(1024, 1)
relax_kernel(const float* __restrict__ tc, const float* __restrict__ phi0,
             float* __restrict__ out, int H, int W, int n_iter, int R,
             int h, int rows) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int P = pitch(W);
  const int L = R + 2 * h;
  float* buf0 = smem;
  float* buf1 = buf0 + L * P;
  const size_t base = static_cast<size_t>(blockIdx.x / kCluster) * H * W;
  const int g0 = rank * R - h;  // grid row of local row 0
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const bool up = rank > 0, dn = rank < kCluster - 1;
  PROF_INIT;

  for (int idx = tid; idx < L * P; idx += nthreads) {
    const int g = g0 + idx / P;
    const int cc = idx % P - kOff;
    const float v = (g >= 0 && g < H && cc >= 0 && cc < W)
                        ? phi0[base + static_cast<size_t>(g) * W + cc]
                        : kBig;
    buf0[idx] = v;
    buf1[idx] = v;
  }
  const int c = threadIdx.x;
  const int i0 = 1 + threadIdx.y * rows;
  const int n = max(0, min(rows, L - 1 - i0));
  float t[MAX_ROWS], td[MAX_ROWS];
#pragma unroll
  for (int k = 0; k < MAX_ROWS; ++k) {
    const int g = g0 + i0 + k;
    t[k] = (k < n && g >= 0 && g < H)
               ? tc[base + static_cast<size_t>(g) * W + c]
               : __int_as_float(0x7f800000);  // +inf
    td[k] = __fmul_rn(t[k], kDiag);
  }
  // every block of the cluster runs and has its buffers before any
  // distributed-shared-memory store
  cluster_arrive();
  cluster_wait();
  PROF_STAMP(0);

  float* cur = buf0;
  float* nxt = buf1;
  float* mail = buf1 + L * P;
  const int hw = h * W;
  float* up_mail = up ? cluster.map_shared_rank(mail, rank - 1) : nullptr;
  float* dn_mail = dn ? cluster.map_shared_rank(mail, rank + 1) : nullptr;
  for (int t0 = 0, rnd = 0; t0 < n_iter; ++rnd) {
    const int s = min(h, n_iter - t0);
    for (int j = 1; j <= s; ++j) {
      if (n == MAX_ROWS)
        relax_strip<MAX_ROWS, true>(cur, nxt, P, c, i0, n, t, td);
      else if (n > 0)
        relax_strip<MAX_ROWS, false>(cur, nxt, P, c, i0, n, t, td);
      __syncthreads();
      float* tmp = cur; cur = nxt; nxt = tmp;
    }
    t0 += s;
    PROF_STAMP(1);
    if (t0 < n_iter) {
      // my first h band rows go to rank - 1's slot "from below", my last
      // h to rank + 1's slot "from above"
      const int par = (rnd & 1) * 2 * hw;
      if (up) copy_rows(up_mail + par + hw, W, cur + h * P + kOff, P, h, W,
                        tid, nthreads);
      if (dn) copy_rows(dn_mail + par, W, cur + R * P + kOff, P, h, W, tid,
                        nthreads);
      PROF_STAMP(2);
      cluster_arrive();
      cluster_wait();
      PROF_STAMP(3);
      if (up) copy_rows(cur + kOff, P, mail + par, W, h, W, tid, nthreads);
      if (dn) copy_rows(cur + (R + h) * P + kOff, P, mail + par + hw, W, h,
                        W, tid, nthreads);
      __syncthreads();
      PROF_STAMP(4);
    }
  }

  for (int idx = tid; idx < R * W; idx += nthreads) {
    const int g = rank * R + idx / W;
    if (g < H)
      out[base + static_cast<size_t>(g) * W + idx % W] =
          cur[(h + idx / W) * P + kOff + idx % W];
  }
  PROF_STAMP(5);
  PROF_FLUSH;
  // no block leaves while a neighbour may still address its shared memory
  cluster_arrive();
  cluster_wait();
}

using Kernel = void (*)(const float*, const float*, float*, int, int, int,
                        int, int, int);

Kernel pick(int rows) {
  if (rows <= 1) return relax_kernel<1>;
  if (rows <= 2) return relax_kernel<2>;
  if (rows <= 4) return relax_kernel<4>;
  if (rows <= 6) return relax_kernel<6>;
  if (rows <= 8) return relax_kernel<8>;
  if (rows <= 12) return relax_kernel<12>;
  if (rows <= 16) return relax_kernel<16>;
  if (rows <= 24) return relax_kernel<24>;
  if (rows <= 32) return relax_kernel<32>;
  if (rows <= 48) return relax_kernel<48>;
  if (rows <= 64) return relax_kernel<64>;
  return nullptr;
}

cudaError_t configure(Kernel fn, int B, int W, int ty, int smem,
                      cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(B * kCluster);
  cfg->blockDim = dim3(W, ty);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  tc, phi0 and out are contiguous
// (B, H, W) float32 device buffers.  The launch plan comes from the caller
// (nclt_slam_tpu_torch/ops/wavefront.py:_launch_shape): bands of R rows,
// halo depth h (1 <= h <= R), a W x ty block whose threads relax `rows`
// local rows each, and `smem` bytes of shared memory
// (4 * (2 * (R + 2h) * pitch(W) + 4 * h * W)).  Returns the CUDA error code
// of the launch (0 = launched); an unsupported `rows` returns
// cudaErrorInvalidValue.
extern "C" int wavefront_relax(const float* tc, const float* phi0,
                               float* out, int B, int H, int W, int n_iter,
                               int R, int h, int ty, int rows, int smem,
                               void* stream) {
  Kernel fn = pick(rows);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(fn, B, W, ty, smem,
                              static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, fn, tc, phi0, out, H, W, n_iter, R, h, rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of this plan the card can hold at once (the grids of
// one launch run in one wave when B <= the count).  Returns the CUDA error
// code; the count goes to *n.
extern "C" int wavefront_max_active_clusters(int W, int ty, int rows,
                                             int smem, int* n) {
  Kernel fn = pick(rows);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(fn, 1, W, ty, smem, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(n, fn, &cfg));
}

#ifdef WAVEFRONT_PROFILE
extern "C" int wavefront_prof(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long z[8] = {0};
    return static_cast<int>(cudaMemcpyToSymbol(g_prof, z, sizeof(z)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_prof, 8 * sizeof(unsigned long long)));
}
#endif
