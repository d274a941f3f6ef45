// Mutual-nearest-neighbour Hamming matching of binary descriptors for
// Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// nclt_slam_tpu/ops/hamming_pallas.py:_cross_check_kernel (the BFMatcher
// crossCheck=True equivalent behind sensors/features.py:cross_check_match).
// For each problem p of a batch, with descriptor sets a (A x W words) and
// b (B x W words; problem p reads b set p / group) and validity flags:
//
//     D[a][b]   = popcount(a ^ b) over the W 32-bit words
//     Dm[a][b]  = D[a][b] if valid_a[a] and valid_b[b], else BIG = 1e6
//     rowkey[a] = min_b Dm[a][b] * B + b      (first b among ties)
//     colkey[b] = min_a Dm[a][b] * A + a      (first a among ties)
//     best_b[a] = rowkey[a] % B,  best_d[a] = rowkey[a] / B
//     matched[a] = colkey[best_b] == best_d * A + a
//                  and best_d <= max_dist and best_d < BIG
//
// The value*index keys make both argmins unique, so the last line is the
// same test as the Pallas kernel's OR-scan and the XLA path's
// best_ba[best_ab] == a.  An invalid row gets b = 0, d = BIG, unmatched.
// Everything is integer arithmetic and a min of integers does not depend on
// its order, so any tiling or reduction tree gives the same bits.  The main
// path calls it on (15 problems, A = 256 live features, B = 384 VIO map
// points) every tick and on (75 problems = 15 routes x 5 candidates,
// A = 256 stored features, B = 256 live features) every fifth repeat tick.
//
// What bounds it on an H100.  A VIO problem is 256 x 384 x 8 word pairs:
// 786,432 popcounts, and __popc issues at 16 a clock on an SM.  The first
// version (one block a problem) walked the pairs twice, once for the row
// keys and once for the column keys, on 15 of the 132 SMs: ~98 k cycles,
// 0.063 ms.  The whole card doing one pass needs ~6 k cycles for the VIO
// call, on the tensor cores far less; 26 KB of descriptors a block in, 3 KB
// of results a problem out.  So the time is latency: one round trip to
// memory, the key arithmetic of each distance (about seven integer
// operations), a cluster barrier, and the launch (an empty kernel of the
// same grid and clusters takes 0.0011 ms).  Of a VIO block's 10.1 k
// cycles, 31 % load, 38 % distances and keys, 26 % merge and barrier.
//
// What the design does about it.  Each problem is matched by a cluster of
// C blocks (C in 1, 2, 4, 8; the plan in ops/hamming.py picks it).  Rank r
// owns the band of R = ceil(A / C) a-rows from r * R and loads its band
// and the whole b set into shared memory as 32-bit words (the tensors hold
// int64 values in [0, 2^32); the low word is read).  It computes each
// distance of its band once and takes from it
//   - the complete row key of each of its rows, and
//   - a partial column key over its band for every b.
// Every rank keeps a full copy of the column keys, set to INT32_MAX before
// a split cluster barrier whose wait comes only after the distances (its
// latency hides behind them).  Each block then merges its partial column
// keys into every rank's copy by atomicMin in distributed shared memory
// (C x B remote atomics a block), and one full cluster barrier later every
// copy is complete: the mutual test reads colkey[best_b] from the block's
// own shared memory, and no block touches another's after that barrier,
// so the blocks leave without a further one.

// The distances on the tensor cores: mma.sync m16n8k256 .b1 .and.popc
// gives popc(a & b) for a 16 x 8 tile over one 256-bit descriptor, and
//     hamming = popc(a) + popc(b) - 2 popc(a & b),
// exact, with popc(a) and popc(b) computed once a row and a column while
// the descriptors are loaded.  A thread loads whole descriptor rows (64
// bytes), two rows in flight, so a block waits about one round trip to
// memory.  The band is cut into chunks of 32 rows (two m-tiles); for each
// chunk, warp w takes the n-tiles w, w + NW, ..., two an iteration (four
// independent MMAs).  A tile's column minimum over the chunk is complete in
// registers, then a shuffle over the tile's rows and one shared atomicMin;
// the row minima stay in registers over the warp's n-tiles, then a shuffle
// over a tile's columns and a shared atomicMin across warps.  A padded row
// or column (the band rounded up to 32 rows, B to 8 columns) takes the key
// INT32_MAX and so never wins.  Invalid rows and columns carry popc =
// -1024: then the sum is negative, and min((unsigned) sum, BIG) is BIG
// exactly where either row is invalid.
//
// Measured rounds (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6,
// tools/torch_hamming_probe.py, ms a launch from a CUDA graph, VIO /
// matcher call, the same call): the first version 0.063 / 0.048; round 1
// (one pass over the distances, clusters, popcounts on the CUDA cores:
// thread t held columns t, t + T, ... and walked the band's rows) 0.017 /
// 0.045; round 2 (the tensor cores, a tile at a time) 0.009 / 0.016; round
// 3 (whole-row loads, 32-row chunks) 0.0070 / 0.0143, the matcher in two
// waves at 64 registers; round 4 (48 registers, five blocks an SM, one
// wave) 0.0072 / 0.0122; round 5 (column keys merged into every rank, no
// remote reads, no exit barrier) 0.0067 / 0.0115, kept.  An empty kernel
// of the same launch takes 0.0011.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#ifdef HAMMING_PROFILE
// per-phase clock64 cycles summed over blocks (thread 0 of each), and the
// number of blocks that added to them (tools/torch_hamming_probe.py)
__device__ unsigned long long g_prof[8];
#define PROF_INIT              \
  long long prof_t = clock64(); \
  unsigned long long prof_acc[5] = {0, 0, 0, 0, 0}
#define PROF_STAMP(i)               \
  do {                              \
    const long long t_ = clock64(); \
    prof_acc[i] += t_ - prof_t;     \
    prof_t = t_;                    \
  } while (0)
#define PROF_FLUSH                                                           \
  do {                                                                       \
    if (threadIdx.x == 0) {                                                  \
      for (int i_ = 0; i_ < 5; ++i_) atomicAdd(&g_prof[i_], prof_acc[i_]);   \
      atomicAdd(&g_prof[7], 1ull);                                           \
    }                                                                        \
  } while (0)
#else
#define PROF_INIT
#define PROF_STAMP(i)
#define PROF_FLUSH
#endif

namespace {

constexpr int kBig = 1000000;
constexpr int kIntMax = 0x7fffffff;
constexpr int kInvalid = -1024;  // popc of an invalid row: every sum < 0
constexpr int W = 8;             // 32-bit words a descriptor
constexpr int kChunk = 2;       // m-tiles a chunk: 32 band rows

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" : : : "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" : : : "memory");
}

// The distance with the validity sentinel folded in: Dm = min(sum, BIG) as
// unsigned, where sum = pa + pb - 2 popc(a & b) is negative exactly when a
// row is invalid.
__device__ __forceinline__ int masked(int sum) {
  return static_cast<int>(min(static_cast<unsigned>(sum),
                              static_cast<unsigned>(kBig)));
}

struct Smem {
  uint32_t* sb;   // Bp x W: the b set, padded columns zero
  uint32_t* sa;   // Rp x W: the band, padded rows zero
  int* pb;        // Bp: popc of each column, kInvalid if invalid or padded
  int* pa;        // Rp: popc of each band row, kInvalid if invalid or padded
  int* rowkey;    // Rp: row keys of the band
  int* cpart;     // Bp: partial column keys over the band
  int* colkey;    // Bp: the column keys merged over the cluster
};

__device__ __forceinline__ Smem carve(uint32_t* smem, int Rp, int Bp) {
  Smem s;
  s.sb = smem;
  s.sa = s.sb + Bp * W;
  s.pb = reinterpret_cast<int*>(s.sa + Rp * W);
  s.pa = s.pb + Bp;
  s.rowkey = s.pa + Rp;
  s.cpart = s.rowkey + Rp;
  s.colkey = s.cpart + Bp;
  return s;
}

// The b set (rows 0 .. Bp - 1) and the band (rows Bp .. Bp + Rp - 1) into
// shared memory as 32-bit words with their popcounts: thread t loads rows
// t, t + T, ..., two at a time, each as four 16-byte loads of int64 words
// (the low word is kept).  gb and ga are 16-byte aligned.
__device__ __forceinline__ void load_rows(const Smem& s,
                                          const int64_t* __restrict__ gb,
                                          const bool* __restrict__ vb,
                                          const int64_t* __restrict__ ga,
                                          const bool* __restrict__ va,
                                          int B, int nr, int Bp, int Rp) {
  const int n = Bp + Rp;
  for (int j0 = threadIdx.x; j0 < n; j0 += 2 * blockDim.x) {
    longlong2 v[2][4];
    bool ok[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + u * blockDim.x;
      const longlong2* src = nullptr;
      ok[u] = false;
      if (j < B) {
        src = reinterpret_cast<const longlong2*>(gb + j * W);
        ok[u] = vb[j];
      } else if (j >= Bp && j - Bp < nr) {
        src = reinterpret_cast<const longlong2*>(ga + (j - Bp) * W);
        ok[u] = va[j - Bp];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[u][k] = src ? __ldg(src + k) : make_longlong2(0, 0);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < n) {
        uint32_t w[W];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[2 * k] = static_cast<uint32_t>(v[u][k].x);
          w[2 * k + 1] = static_cast<uint32_t>(v[u][k].y);
        }
        int pc = 0;
#pragma unroll
        for (int k = 0; k < W; ++k) pc += __popc(w[k]);
        uint4* dst = reinterpret_cast<uint4*>(j < Bp ? s.sb + j * W
                                                     : s.sa + (j - Bp) * W);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
        (j < Bp ? s.pb[j] : s.pa[j - Bp]) = ok[u] ? pc : kInvalid;
      }
    }
  }
}

// mma.sync m16n8k256, b1 operands, AND + popcount, s32 accumulators from 0.
// Fragments (PTX ISA, mma.m16n8k256 .b1; g = lane / 4, t = lane % 4):
// a0 = row g word t, a1 = row g + 8 word t, a2 = row g word t + 4,
// a3 = row g + 8 word t + 4; b0 = column g word t, b1 = column g word
// t + 4; d0, d1 = row g columns 2t, 2t + 1; d2, d3 = row g + 8, the same.
__device__ __forceinline__ void mma_and_popc(const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1,
                                             int (&d)[4]) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0));
}

// One n-tile of the chunk: the keys of this thread's 4 x kChunk elements
// (rows g, g + 8 of each m-tile; columns col0, col0 + 1).  Row keys go
// into rmin; the chunk's column keys of the two columns are returned in
// cmin0, cmin1.  edge: the tile holds padded rows or columns.
__device__ __forceinline__ void tile_keys(
    const int (&c)[kChunk][4], const int (&pa)[kChunk][2], int2 pb,
    int row0, int col0, int A, int B, int a0, int nr, bool edge,
    int (&rmin)[kChunk][2], int& cmin0, int& cmin1) {
  cmin0 = cmin1 = kIntMax;
#pragma unroll
  for (int m = 0; m < kChunk; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d0 = masked(pa[m][h] + pb.x - 2 * c[m][2 * h]);
      const int d1 = masked(pa[m][h] + pb.y - 2 * c[m][2 * h + 1]);
      const int row = row0 + m * 16 + h * 8;
      int r0 = d0 * B + col0, r1 = d1 * B + col0 + 1;
      int c0 = d0 * A + a0 + row, c1 = d1 * A + a0 + row;
      if (edge) {
        if (col0 >= B) r0 = kIntMax;
        if (col0 + 1 >= B) r1 = kIntMax;
        if (row >= nr) c0 = c1 = kIntMax;
      }
      rmin[m][h] = min(rmin[m][h], min(r0, r1));
      cmin0 = min(cmin0, c0);
      cmin1 = min(cmin1, c1);
    }
  }
}

// Distances and block keys: row keys into s.rowkey and partial column keys
// into s.cpart, by shared atomicMin.  Every loop that holds a shuffle runs
// the same number of times in every lane of a warp (its bounds are uniform
// kernel arguments), so the shuffles need no reconvergence.
__device__ __forceinline__ void block_keys(const Smem& s, int A, int B,
                                           int a0, int nr, int Rp, int Bp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int NT = Bp >> 3;
  const int steps = (NT + 2 * nw - 1) / (2 * nw);  // n-tile pairs a warp
  for (int c0 = 0; c0 < Rp; c0 += 16 * kChunk) {
    const int row0 = c0 + g;
    uint32_t a[kChunk][4];
    int pa[kChunk][2], rmin[kChunk][2];
#pragma unroll
    for (int m = 0; m < kChunk; ++m) {
      const int r = row0 + m * 16;
      a[m][0] = s.sa[r * W + t];
      a[m][1] = s.sa[(r + 8) * W + t];
      a[m][2] = s.sa[r * W + t + 4];
      a[m][3] = s.sa[(r + 8) * W + t + 4];
      pa[m][0] = s.pa[r];
      pa[m][1] = s.pa[r + 8];
      rmin[m][0] = rmin[m][1] = kIntMax;
    }
    const bool edge_m = c0 + 16 * kChunk > nr;
    for (int k = 0; k < steps; ++k) {
      // n-tiles warp + 2k NW and warp + (2k + 1) NW; one past the last
      // repeats the last, which changes no minimum and is not stored
      const int n0 = warp + 2 * k * nw;
      const int tiles[2] = {min(n0, NT - 1), min(n0 + nw, NT - 1)};
      const bool store[2] = {n0 < NT, n0 + nw < NT};
      int c[2][kChunk][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = tiles[u] * 8 + g;
        const uint32_t b0 = s.sb[col * W + t], b1 = s.sb[col * W + t + 4];
#pragma unroll
        for (int m = 0; m < kChunk; ++m) mma_and_popc(a[m], b0, b1, c[u][m]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col0 = tiles[u] * 8 + 2 * t;
        const int2 pb = *reinterpret_cast<const int2*>(s.pb + col0);
        int cmin0, cmin1;
        tile_keys(c[u], pa, pb, row0, col0, A, B, a0, nr,
                  edge_m || tiles[u] * 8 + 8 > B, rmin, cmin0, cmin1);
        // the chunk's rows: over g (lanes 4 apart)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          cmin0 = min(cmin0, __shfl_xor_sync(0xffffffffu, cmin0, off));
          cmin1 = min(cmin1, __shfl_xor_sync(0xffffffffu, cmin1, off));
        }
        if (g == 0 && store[u]) {
          atomicMin(s.cpart + col0, cmin0);
          atomicMin(s.cpart + col0 + 1, cmin1);
        }
      }
    }
    // the warp's columns: over t (adjacent lanes)
#pragma unroll
    for (int m = 0; m < kChunk; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int v = rmin[m][h];
        v = min(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = min(v, __shfl_xor_sync(0xffffffffu, v, 2));
        if (t == 0) atomicMin(s.rowkey + row0 + m * 16 + h * 8, v);
      }
    }
  }
}

// Grid: C blocks a problem (cluster dims (C, 1, 1)), T threads a block.
// R band rows (Rp padded to 32), Bp = B padded to 8.  The plan makes every
// band non-empty.  At most 48 registers a thread let an SM hold five
// blocks of 256 threads: 75 problems in clusters of 8 then run in one wave.
__global__ void __launch_bounds__(256, 5)
cross_check_kernel(const int64_t* __restrict__ desc_a,
                   const bool* __restrict__ valid_a,
                   const int64_t* __restrict__ desc_b,
                   const bool* __restrict__ valid_b, int A, int B, int group,
                   int max_dist, int R, int Rp, int Bp,
                   int32_t* __restrict__ best_b, bool* __restrict__ matched,
                   int32_t* __restrict__ best_d) {
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int p = blockIdx.x / C;
  const int q = p / group;  // the b set this problem reads
  const int a0 = rank * R;
  const int nr = min(R, A - a0);  // real rows of the band
  const int tid = threadIdx.x, nt = blockDim.x;
  const Smem s = carve(smem, Rp, Bp);
  PROF_INIT;

  load_rows(s, desc_b + static_cast<size_t>(q) * B * W,
            valid_b + static_cast<size_t>(q) * B,
            desc_a + (static_cast<size_t>(p) * A + a0) * W,
            valid_a + static_cast<size_t>(p) * A + a0, B, nr, Bp, Rp);
  for (int i = tid; i < Rp; i += nt) s.rowkey[i] = kIntMax;
  for (int i = tid; i < Bp; i += nt) s.cpart[i] = s.colkey[i] = kIntMax;
  __syncthreads();
  // this block's column keys are set: the other ranks may merge into them
  // once they pass the matching wait
  cluster_arrive();
  PROF_STAMP(0);

  block_keys(s, A, B, a0, nr, Rp, Bp);
  __syncthreads();
  PROF_STAMP(1);

  // merge the band's partial column keys into every rank's copy
  cluster_wait();
  for (int b = tid; b < B; b += nt) {
    const int v = s.cpart[b];
    for (int r = 0; r < C; ++r)
      atomicMin(cluster.map_shared_rank(s.colkey, r) + b, v);
  }
  PROF_STAMP(2);
  cluster_arrive();
  cluster_wait();
  PROF_STAMP(3);

  // the mutual test of the band's rows, from this block's own copy
  for (int i = tid; i < nr; i += nt) {
    const int rk = s.rowkey[i];
    const int bb = rk % B;
    const int d = rk / B;
    const size_t o = static_cast<size_t>(p) * A + a0 + i;
    best_b[o] = bb;
    best_d[o] = d;
    matched[o] = s.colkey[bb] == d * A + a0 + i && d <= max_dist && d < kBig;
  }
  PROF_STAMP(4);
  PROF_FLUSH;
}

__global__ void empty_kernel() {}

template <typename F>
cudaError_t configure(F fn, int P, int C, int threads, int smem,
                      cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(P * C);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  desc_a (P, A, 8) and desc_b
// (P / group, B, 8) are contiguous, 16-byte aligned int64 device buffers
// holding uint32 values; valid_a (P, A) and valid_b (P / group, B) are
// bool; problem p matches a set p against b set p / group.  Outputs best_b,
// best_d (int32) and matched (bool) are (P, A).  The launch plan comes from
// the caller (nclt_slam_tpu_torch/ops/hamming.py:plan): C blocks a problem,
// bands of R rows (Rp padded), Bp padded columns, `threads` a block (at
// most 256), `smem` bytes.  The caller checks that
// BIG * max(A, B) + max(A, B) fits an int32.  Returns the CUDA error code
// of the launch (0 = launched; cudaErrorInvalidValue for a width other
// than 8 words).
extern "C" int hamming_cross_check(const void* desc_a, const void* valid_a,
                                   const void* desc_b, const void* valid_b,
                                   int P, int A, int B, int words, int group,
                                   int max_dist, int C, int R, int Rp, int Bp,
                                   int threads, int smem,
                                   void* best_b, void* matched, void* best_d,
                                   void* stream) {
  if (words != W) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(cross_check_kernel, P, C, threads, smem,
                              static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(
      &cfg, cross_check_kernel, static_cast<const int64_t*>(desc_a),
      static_cast<const bool*>(valid_a), static_cast<const int64_t*>(desc_b),
      static_cast<const bool*>(valid_b), A, B, group, max_dist, R, Rp, Bp,
      static_cast<int32_t*>(best_b), static_cast<bool*>(matched),
      static_cast<int32_t*>(best_d));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of this plan the card holds at once (the problems of
// one launch run in one wave when P <= the count).  Returns the CUDA error
// code; the count goes to *n.
extern "C" int hamming_max_active_clusters(int C, int threads, int smem,
                                           int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(cross_check_kernel, 1, C, threads, smem,
                              nullptr, &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(n, cross_check_kernel, &cfg));
}

// The launch floor: an empty kernel with the same grid, cluster, block and
// shared memory as a cross-check launch of P problems.
extern "C" int hamming_empty_launch(int P, int C, int threads, int smem,
                                    void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(empty_kernel, P, C, threads, smem,
                              static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef HAMMING_PROFILE
extern "C" int hamming_prof(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long z[8] = {0};
    return static_cast<int>(cudaMemcpyToSymbol(g_prof, z, sizeof(z)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_prof, 8 * sizeof(unsigned long long)));
}
#endif
