// Mutual-nearest-neighbour Hamming matching of binary descriptors for
// Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// nclt_slam_tpu/ops/hamming_pallas.py:_cross_check_kernel (the BFMatcher
// crossCheck=True equivalent behind sensors/features.py:cross_check_match).
// For each problem p of a batch, with descriptor sets a (A x W words) and
// b (B x W words) and validity flags:
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
// The main path calls it on (15 problems, A = 256 live features, B = 384 VIO
// map points) every tick and on (75 problems = 15 routes x 5 candidates,
// A = 256 stored features, B = 256 live features) every fifth repeat tick.
//
// What bounds it on an H100.  A problem is A*B*W xor + popcount + add
// (3 integer operations a word pair) twice over (row pass and column pass),
// i.e. ~4.7e6 operations for a VIO problem: microseconds of the card's
// integer rate, and ~40 KB of descriptors in, 3 KB out.  At 15 or 75 blocks
// the kernel fills a fraction of the 132 SMs, and its time is launch latency
// plus one SM's pass over A*B pairs; the caller's tick is bound by the host
// launching hundreds of other small kernels, so this is not yet worth
// tiling further.
//
// What the design does about it.  One block per problem.  Both descriptor
// sets go to shared memory as 32-bit words (the tensors hold them as int64
// values in [0, 2^32); the low word is read): (256 + 384) x 8 x 4 B = 20 KB.
// Pass 1: thread a holds its row's W words in registers and walks every b
// in order (all threads of a warp read the same b word: a shared-memory
// broadcast, no bank conflicts).  Pass 2 is the same with the roles
// swapped.  Pass 3 applies the mutual test from the two key arrays.  The
// descriptor width is fixed at the configuration's 8 words (256 bits,
// LandmarkConfig.desc_words) so the row lives in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1000000;
constexpr int W = 8;  // 32-bit words a descriptor

__global__ void cross_check_kernel(
    const int64_t* __restrict__ desc_a, const bool* __restrict__ valid_a,
    const int64_t* __restrict__ desc_b, const bool* __restrict__ valid_b,
    int A, int B, int group, int max_dist, int32_t* __restrict__ best_b,
    bool* __restrict__ matched, int32_t* __restrict__ best_d) {
  extern __shared__ uint32_t smem[];
  uint32_t* sa = smem;                                   // A * W
  uint32_t* sb = sa + static_cast<size_t>(A) * W;        // B * W
  int* rowkey = reinterpret_cast<int*>(sb + static_cast<size_t>(B) * W);
  int* colkey = rowkey + A;                              // B
  unsigned char* va = reinterpret_cast<unsigned char*>(colkey + B);  // A
  unsigned char* vb = va + A;                            // B

  const int p = blockIdx.x;
  const int q = p / group;  // the b set this problem reads
  const int64_t* ga = desc_a + static_cast<size_t>(p) * A * W;
  const int64_t* gb = desc_b + static_cast<size_t>(q) * B * W;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int i = tid; i < A * W; i += nt)
    sa[i] = static_cast<uint32_t>(static_cast<uint64_t>(ga[i]));
  for (int i = tid; i < B * W; i += nt)
    sb[i] = static_cast<uint32_t>(static_cast<uint64_t>(gb[i]));
  for (int i = tid; i < A; i += nt) va[i] = valid_a[static_cast<size_t>(p) * A + i];
  for (int i = tid; i < B; i += nt) vb[i] = valid_b[static_cast<size_t>(q) * B + i];
  __syncthreads();

  // pass 1: row argmin keys
  for (int a = tid; a < A; a += nt) {
    uint32_t row[W];
#pragma unroll
    for (int w = 0; w < W; ++w) row[w] = sa[a * W + w];
    const bool ok_a = va[a] != 0;
    int key = 0x7fffffff;  // every candidate key is <= BIG*B + (B-1)
    for (int b = 0; b < B; ++b) {
      int d = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) d += __popc(row[w] ^ sb[b * W + w]);
      const int dm = (ok_a && vb[b]) ? d : kBig;
      key = min(key, dm * B + b);
    }
    rowkey[a] = key;
  }

  // pass 2: column argmin keys
  for (int b = tid; b < B; b += nt) {
    uint32_t col[W];
#pragma unroll
    for (int w = 0; w < W; ++w) col[w] = sb[b * W + w];
    const bool ok_b = vb[b] != 0;
    int key = 0x7fffffff;
    for (int a = 0; a < A; ++a) {
      int d = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) d += __popc(col[w] ^ sa[a * W + w]);
      const int dm = (ok_b && va[a]) ? d : kBig;
      key = min(key, dm * A + a);
    }
    colkey[b] = key;
  }
  __syncthreads();

  // pass 3: mutual check
  for (int a = tid; a < A; a += nt) {
    const int rk = rowkey[a];
    const int bb = rk % B;
    const int d = rk / B;
    const bool mutual = colkey[bb] == d * A + a;
    const size_t o = static_cast<size_t>(p) * A + a;
    best_b[o] = bb;
    best_d[o] = d;
    matched[o] = mutual && d <= max_dist && d < kBig;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  desc_a (P, A, 8) and desc_b
// (P / group, B, 8) are contiguous int64 device buffers holding uint32
// values; valid_a (P, A) and valid_b (P / group, B) are bool; problem p
// matches a set p against b set p / group.  Outputs best_b, best_d (int32)
// and matched (bool) are (P, A).  The caller checks that BIG * max(A, B) +
// max(A, B) fits an int32 and that the shared memory fits.  Returns the CUDA
// error code of the launch (0 = launched; cudaErrorInvalidValue for a width
// other than 8 words).
extern "C" int hamming_cross_check(const void* desc_a, const void* valid_a,
                                   const void* desc_b, const void* valid_b,
                                   int P, int A, int B, int words, int group,
                                   int max_dist, int threads, void* best_b,
                                   void* matched, void* best_d,
                                   void* stream) {
  if (words != W) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(A + B) * W * sizeof(uint32_t) +
                      static_cast<size_t>(A + B) * sizeof(int) +
                      static_cast<size_t>(A + B);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cross_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cross_check_kernel<<<P, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc_a), static_cast<const bool*>(valid_a),
      static_cast<const int64_t*>(desc_b), static_cast<const bool*>(valid_b),
      A, B, group, max_dist, static_cast<int32_t*>(best_b),
      static_cast<bool*>(matched), static_cast<int32_t*>(best_d));
  return static_cast<int>(cudaGetLastError());
}

