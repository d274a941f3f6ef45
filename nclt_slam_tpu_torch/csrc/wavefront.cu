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
// --fmad=false).
//
// What bounds it on an H100.  The 384 iterations are a dependent chain,
// and each one is a full pass over the grid: per iteration a 192x192
// window reads ~3 phi values per cell from shared memory (a rolling 3x3
// window down each thread's column strip), one tc value, and writes one
// phi value, then waits at two block barriers.  With one block per route
// the card runs 15 blocks on 132 SMs, so the kernel is bound by one SM's
// shared-memory bandwidth and barrier latency per iteration, not by device
// memory (the grids are read once and written once).
//
// What the design does about it.  One block per grid keeps the whole
// potential resident in shared memory for all iterations: a (H+2) x (W+2)
// float plane with a BIG border, so no neighbour read needs an edge test
// (150.5 KB for 192x192, 113 KB for 119x232, under the 227 KB a block may
// take).  Threads form W columns x TY rows; each owns one grid column and
// a strip of `rows` consecutive grid rows, computes the strip's new values
// into registers from a rolling 3x3 window (3 shared loads per cell instead
// of 9), and writes them back after a barrier.  tc does not fit beside phi
// in shared memory, and a register copy of it next to the strip's new
// values would exceed the 64 registers a thread may hold at 1024 threads,
// so tc streams through the read-only cache from L2 (where all 15 grids,
// 2.2 MB, stay resident).  Spreading a grid over a thread block cluster to
// use more than 15 SMs is later work.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;
constexpr float kDiag = 1.4142135f;

template <int MAX_ROWS>
__global__ void __launch_bounds__(1024, 1)
relax_kernel(const float* __restrict__ tc, const float* __restrict__ phi0,
             float* __restrict__ out, int H, int W, int n_iter, int rows) {
  extern __shared__ float plane[];  // (H + 2) x (W + 2), border = kBig
  const int P = W + 2;
  const size_t base = static_cast<size_t>(blockIdx.x) * H * W;
  const float* tcb = tc + base;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;

  for (int i = tid; i < (H + 2) * P; i += nthreads) {
    const int r = i / P - 1;
    const int c = i % P - 1;
    plane[i] = (r >= 0 && r < H && c >= 0 && c < W) ? phi0[base + r * W + c]
                                                    : kBig;
  }
  __syncthreads();

  const int c = threadIdx.x;          // this thread's grid column
  const int r0 = threadIdx.y * rows;  // first grid row of its strip
  const bool active = r0 < H;
  float nv[MAX_ROWS];

  for (int it = 0; it < n_iter; ++it) {
    if (active) {
      // window rows: u = grid row r-1, m = row r, d = row r+1; L/C/R = the
      // columns c-1, c, c+1.  Grid (r, c) lives at plane[(r+1)*P + c+1].
      const float* up = plane + r0 * P + c;
      float uL = up[0], uC = up[1], uR = up[2];
      float mL = up[P], mC = up[P + 1], mR = up[P + 2];
#pragma unroll
      for (int k = 0; k < MAX_ROWS; ++k) {
        const int r = r0 + k;
        if (k < rows && r < H) {
          const float* dn = plane + (r + 2) * P + c;
          const float dL = dn[0], dC = dn[1], dR = dn[2];
          const float t = __ldg(tcb + r * W + c);
          const float td = __fmul_rn(t, kDiag);
          float best = mC;
          best = fminf(best, __fadd_rn(uC, t));
          best = fminf(best, __fadd_rn(dC, t));
          best = fminf(best, __fadd_rn(mL, t));
          best = fminf(best, __fadd_rn(mR, t));
          best = fminf(best, __fadd_rn(uL, td));
          best = fminf(best, __fadd_rn(uR, td));
          best = fminf(best, __fadd_rn(dL, td));
          best = fminf(best, __fadd_rn(dR, td));
          nv[k] = best;
          uL = mL; uC = mC; uR = mR;
          mL = dL; mC = dC; mR = dR;
        }
      }
    }
    __syncthreads();  // every read of this iteration's phi is done
    if (active) {
#pragma unroll
      for (int k = 0; k < MAX_ROWS; ++k) {
        const int r = r0 + k;
        if (k < rows && r < H) plane[(r + 1) * P + c + 1] = nv[k];
      }
    }
    __syncthreads();  // the new phi is complete
  }

  for (int i = tid; i < H * W; i += nthreads) {
    out[base + i] = plane[(i / W + 1) * P + i % W + 1];
  }
}

template <int MAX_ROWS>
cudaError_t launch(const float* tc, const float* phi0, float* out, int B,
                   int H, int W, int n_iter, int ty, int rows,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(H + 2) * (W + 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      relax_kernel<MAX_ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  relax_kernel<MAX_ROWS><<<B, dim3(W, ty), smem, stream>>>(
      tc, phi0, out, H, W, n_iter, rows);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  tc, phi0 and out are contiguous
// (B, H, W) float32 device buffers; the block is W x ty threads and each
// thread relaxes `rows` grid rows (the caller checks W <= 1024,
// ty * rows >= H, rows <= 64 and the shared-memory size).  Returns the CUDA
// error code of the launch (0 = launched); an unsupported `rows` returns
// cudaErrorInvalidValue.
extern "C" int wavefront_relax(const float* tc, const float* phi0,
                               float* out, int B, int H, int W, int n_iter,
                               int ty, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows <= 1) err = launch<1>(tc, phi0, out, B, H, W, n_iter, ty, rows, s);
  else if (rows <= 2) err = launch<2>(tc, phi0, out, B, H, W, n_iter, ty, rows, s);
  else if (rows <= 4) err = launch<4>(tc, phi0, out, B, H, W, n_iter, ty, rows, s);
  else if (rows <= 8) err = launch<8>(tc, phi0, out, B, H, W, n_iter, ty, rows, s);
  else if (rows <= 16) err = launch<16>(tc, phi0, out, B, H, W, n_iter, ty, rows, s);
  else if (rows <= 24) err = launch<24>(tc, phi0, out, B, H, W, n_iter, ty, rows, s);
  else if (rows <= 32) err = launch<32>(tc, phi0, out, B, H, W, n_iter, ty, rows, s);
  else if (rows <= 40) err = launch<40>(tc, phi0, out, B, H, W, n_iter, ty, rows, s);
  else if (rows <= 48) err = launch<48>(tc, phi0, out, B, H, W, n_iter, ty, rows, s);
  else if (rows <= 56) err = launch<56>(tc, phi0, out, B, H, W, n_iter, ty, rows, s);
  else if (rows <= 64) err = launch<64>(tc, phi0, out, B, H, W, n_iter, ty, rows, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
