// Batched sliding-window bundle adjustment for Hopper (sm_90a): a whole
// damped Gauss-Newton solve of one window per thread block, in one launch.
//
// Replaces the JAX package's Pallas TPU kernel
// nclt_slam_tpu/ops/ba_pallas.py:_ba_kernel (behind solve_ba_pallas), which
// restates nclt_slam_tpu/vio/ba.py:solve_ba.  For each window of K keyframe
// poses and P landmarks, n_iter times:
//
//   r(k,p)  = [u - u_obs, v - v_obs, 2 (z - z_obs) / sigma_z],
//             sigma_z = max(0.02, depth_noise z_obs^2), z = max(p_cam_z, 0.1)
//             in the pinhole only (the clamp zeroes the depth derivative)
//   w(k,p)  = obs_w * huber(|r_uv|, huber_px) * huber(|r_z|, 6)
//   A_p     = sum_k Jl^T w Jl + (prior_p + damping) I,  its adjugate inverse
//             (determinant guard 1e-12)
//   g_l_p   = sum_k Jl^T w r + prior_p (X_p - X_p at input)
//   H_kk    = sum_p Jp^T w Jp,  g_k = sum_p Jp^T w r
//   B_p     = the 6K x 3 stack of Jp^T w Jl
//   K - 1 relative-pose factors [log(dq^-1 q_i^-1 q_j), R_i^T (p_j - p_i) - dp]
//   with weight w_rel on the block tridiagonal, a gauge prior 1e4 on
//   keyframe 0, damping on the diagonal
//   S       = H - sum_p B_p A_p^-1 B_p^T,  rhs = -(g - sum_p B_p A_p^-1 g_l_p)
//   S dx = rhs by Gauss-Jordan (pivot guard 1e-20); a non-finite dx entry
//   becomes 0;  dX_p = -A_p^-1 (g_l_p + B_p^T dx)
//   pos += dx_t,  q <- normalize(q exp(dx_theta)),  X += dX
//
// and the cost sum w |r|^2 + sum w_rel |r_rel|^2 at the last linearization
// point.  All Jacobians are analytic (the reference takes the relative
// factors' with jacfwd of the same residual, the so3_log included).
//
// What bounds it on an H100.  A 16 x 192 window moves 60 KB in and 3 KB out
// and needs ~7.7 MFLOP an iteration with every observation present (~630
// operations an observation, the symmetric half of the Schur product
// (6K)^2 x 3P, which dominates, and the reduced solve): microseconds at the
// card's float32 rate.  The main path calls
// it on 15 windows (one per route) every tenth repeat tick, the batch
// benchmark on 64, so at most half of the 132 SMs have a block, and inside a
// block the 6K pivot steps of the reduced solve and the barriers between the
// phases are sequential.  Its time is latency, not bytes or operations.
//
// What the design does about it.  Everything of a window stays on one SM:
// the reduced system, the poses, the landmarks and their 3x3 blocks live in
// shared memory for the whole solve, and nothing intermediate goes to device
// memory.  An observation's residual, weight and Jacobians cost ~100
// operations, so they are recomputed where they are needed (normal-equation
// blocks, Schur tiles, back-substitution) instead of being stored: the 6K x
// 3P matrix B would not fit shared memory at the largest benchmark window.
// The Schur product walks the landmarks in tiles of 16: the block fills a
// tile of B_p and C_p = B_p A_p^-1 (6 x 3 blocks, padded to 19 floats so
// that neighbouring keyframes fall on different banks), then thread
// (ka, kb) adds the tile's 6 x 6 contribution to block (ka, kb) of S from
// registers.  Sums over landmarks are taken in a fixed order (per thread,
// then warp shuffles, then warps in order; no float atomics), so a run
// repeats bit for bit.  The P-on-lanes layout, the pltpu.repeat block
// placement, the masked-reduction row extraction and the polynomial arcsine
// of the TPU kernel are Mosaic workarounds and have no counterpart here.

#include <cuda_runtime.h>
#include <math.h>

#include "gauss_jordan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;   // landmarks per Schur tile
constexpr int kBlk = 19;    // floats per 6 x 3 block in a tile (18 + 1 pad)
constexpr int kAcc = 27;    // 21 upper-triangular H_kk entries + 6 of g_k
constexpr int kRel = 78;    // a relative factor: r (6), J_i (36), J_j (36)
constexpr float kGauge = 1e4f;
constexpr float kHuberZ = 6.0f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  float fx, fy, cx, cy, t_fwd, t_up, depth_noise, huber_px, damping;
  int K, P, n_iter;
};

// One (keyframe, landmark) observation at the current estimate.
struct Obs {
  float r[3];      // residual
  float w;         // robust weight
  float Jl[3][3];  // d r / d landmark, [row][column]
  float Jr[3][3];  // d r / d rotation increment; d r / d translation = -Jl
};

__host__ __device__ inline int smem_floats(int K, int P) {
  const int N = 6 * K;
  const int tiles = 2 * kTile * K * kBlk;  // >= K * kWarps * kAcc partials
  return N * (N + 1) + N + (N + 1)         // S | rhs, pivot column and row
         + K * 3 + K * 4 + K * 9           // pos, quat, R
         + K * kAcc                        // H_kk, g_k
         + (K - 1) * kRel + (K - 1)        // relative factors, w_rel
         + P * 3 + P * 9                   // landmarks, A_p^-1 | g_l_p
         + kWarps                          // cost partials
         + tiles;
}

__device__ __forceinline__ int tri(int i, int j) {  // i <= j < 6
  return i * 6 - (i * (i - 1)) / 2 + (j - i);
}

__device__ __forceinline__ void quat_mul(const float* a, const float* b,
                                         float* o) {
  const float x1 = a[0], y1 = a[1], z1 = a[2], w1 = a[3];
  const float x2 = b[0], y2 = b[1], z2 = b[2], w2 = b[3];
  o[0] = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  o[1] = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  o[2] = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
  o[3] = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
}

__device__ __forceinline__ void quat_to_mat(const float* q, float* R) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float n = x * x + y * y + z * z + w * w;
  const float s = n > 1e-12f ? 2.0f / fmaxf(n, 1e-12f) : 0.0f;
  const float xx = x * x * s, yy = y * y * s, zz = z * z * s;
  const float xy = x * y * s, xz = x * z * s, yz = y * z * s;
  const float wx = w * x * s, wy = w * y * s, wz = w * z * s;
  R[0] = 1.0f - (yy + zz); R[1] = xy - wz;          R[2] = xz + wy;
  R[3] = xy + wz;          R[4] = 1.0f - (xx + zz); R[5] = yz - wx;
  R[6] = xz - wy;          R[7] = yz + wx;          R[8] = 1.0f - (xx + yy);
}

// Rotation vector -> quaternion, with the normalized first-order form
// [w / 2, 1] below 1e-8 rad.
__device__ __forceinline__ void so3_exp(const float* w, float* q) {
  const float ang = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
  if (ang < 1e-8f) {
    const float hx = 0.5f * w[0], hy = 0.5f * w[1], hz = 0.5f * w[2];
    const float inv = 1.0f / (sqrtf(hx * hx + hy * hy + hz * hz + 1.0f) + 1e-12f);
    q[0] = hx * inv; q[1] = hy * inv; q[2] = hz * inv; q[3] = inv;
    return;
  }
  float ax = w[0] / ang, ay = w[1] / ang, az = w[2] / ang;
  const float inv = 1.0f / (sqrtf(ax * ax + ay * ay + az * az) + 1e-12f);
  const float sn = sinf(0.5f * ang) * inv;
  q[0] = ax * sn; q[1] = ay * sn; q[2] = az * sn; q[3] = cosf(0.5f * ang);
}

__device__ __forceinline__ void observe(const Params& c, const float* R,
                                        const float* pos, const float* X,
                                        float ou, float ov, float oz,
                                        float ow, Obs& o) {
  const float dx = X[0] - pos[0], dy = X[1] - pos[1], dz = X[2] - pos[2];
  // v = R^T (X - pos); p_base = v - t_bc; p_cam = (-p_base_y, -p_base_z,
  // p_base_x)
  const float v0 = R[0] * dx + R[3] * dy + R[6] * dz;
  const float v1 = R[1] * dx + R[4] * dy + R[7] * dz;
  const float v2 = R[2] * dx + R[5] * dy + R[8] * dz;
  const float pc0 = -v1;
  const float pc1 = -(v2 - c.t_up);
  const float pc2 = v0 - c.t_fwd;
  const float z = fmaxf(pc2, 0.1f);
  const float invz = 1.0f / z;
  const float inv_sigz = 2.0f / fmaxf(0.02f, c.depth_noise * oz * oz);
  o.r[0] = c.fx * pc0 * invz + c.cx - ou;
  o.r[1] = c.fy * pc1 * invz + c.cy - ov;
  o.r[2] = (pc2 - oz) * inv_sigz;
  const float rn = sqrtf(o.r[0] * o.r[0] + o.r[1] * o.r[1]);
  const float hub = rn <= c.huber_px ? 1.0f : c.huber_px / fmaxf(rn, 1e-6f);
  const float arz = fabsf(o.r[2]);
  const float hub_z = arz <= kHuberZ ? 1.0f : kHuberZ / fmaxf(arz, 1e-6f);
  o.w = ow * hub * hub_z;

  const float unclamped = pc2 >= 0.1f ? 1.0f : 0.0f;
  const float a = c.fx * invz;
  const float b = -c.fx * pc0 * invz * invz * unclamped;
  const float cc = c.fy * invz;
  const float d = -c.fy * pc1 * invz * invz * unclamped;
  const float e = inv_sigz;
  // a column g = d p_base / d parameter chains to
  //   (du, dv, drz) = (-a g1 + b g0, -cc g2 + d g0, e g0)
#pragma unroll
  for (int j = 0; j < 3; ++j) {  // d p_base / d X_j = row j of R
    const float g0 = R[3 * j], g1 = R[3 * j + 1], g2 = R[3 * j + 2];
    o.Jl[0][j] = -a * g1 + b * g0;
    o.Jl[1][j] = -cc * g2 + d * g0;
    o.Jl[2][j] = e * g0;
  }
  // d p_base / d theta = [v]x, columns (0, v2, -v1), (-v2, 0, v0), (v1, -v0, 0)
  o.Jr[0][0] = -a * v2;           o.Jr[1][0] = cc * v1;           o.Jr[2][0] = 0.0f;
  o.Jr[0][1] = -b * v2;           o.Jr[1][1] = -cc * v0 - d * v2; o.Jr[2][1] = -e * v2;
  o.Jr[0][2] = a * v0 + b * v1;   o.Jr[1][2] = d * v1;            o.Jr[2][2] = e * v1;
}

// d r / d pose increment, [row][rotation 0..2 | translation 3..5]
__device__ __forceinline__ void pose_jacobian(const Obs& o, float Jp[3][6]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Jp[r][i] = o.Jr[r][i];
      Jp[r][3 + i] = -o.Jl[r][i];
    }
  }
}

// Residual r (6) and Jacobians J_i, J_j (6 x 6, row-major) of the relative
// factor between keyframes i and j = i + 1, against the increments of pose i
// and of pose j (q <- q exp(dtheta), p <- p + dp) at zero.
__device__ void rel_factor(const float* pi, const float* qi, const float* pj,
                           const float* qj, const float* dp, const float* dq,
                           float* out) {
  float* r = out;
  float* Ji = out + 6;
  float* Jj = out + 42;
  const float m[4] = {-dq[0], -dq[1], -dq[2], dq[3]};
  const float qic[4] = {-qi[0], -qi[1], -qi[2], qi[3]};
  float c[4], a[4];
  quat_mul(qic, qj, c);
  quat_mul(m, c, a);

  // so3_log(a) and its derivative against a (3 x 4): sign canonicalization,
  // w clamped to [-1, 1], scale 2 below |v| = 1e-8
  const float s = a[3] < 0.0f ? -1.0f : 1.0f;
  const float v[3] = {a[0] * s, a[1] * s, a[2] * s};
  const float w_raw = a[3] * s;
  const float w_in = fabsf(w_raw) <= 1.0f ? 1.0f : 0.0f;
  const float w = fminf(fmaxf(w_raw, -1.0f), 1.0f);
  const float n = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  float scale = 2.0f, dsdn_n = 0.0f, dsdw = 0.0f;
  if (!(n < 1e-8f)) {
    const float angle = 2.0f * atan2f(n, w);
    const float n2w2 = n * n + w * w;
    scale = angle / n;
    dsdn_n = (2.0f * w / n2w2 - angle / n) / n / n;
    dsdw = -2.0f / n2w2 * w_in;
  }
  float Jlog[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r[i] = v[i] * scale;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      Jlog[i][k] = ((i == k ? scale : 0.0f) + dsdn_n * v[i] * v[k]) * s;
    Jlog[i][3] = dsdw * v[i] * s;
  }

  // d a / d theta_j[k] = a (e_k / 2, 0);  d a / d theta_i[k] = -m (e_k / 2, 0) c
  float Drot_i[3][3], Drot_j[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    e[k] = 0.5f;
    float dj[4], t[4], di[4];
    quat_mul(a, e, dj);
    quat_mul(m, e, t);
    quat_mul(t, c, di);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float sj = 0.0f, si = 0.0f;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        sj += Jlog[i][x] * dj[x];
        si -= Jlog[i][x] * di[x];
      }
      Drot_j[i][k] = sj;
      Drot_i[i][k] = si;
    }
  }

  float R[9];
  quat_to_mat(qi, R);
  const float d0 = pj[0] - pi[0], d1 = pj[1] - pi[1], d2 = pj[2] - pi[2];
  const float y[3] = {R[0] * d0 + R[3] * d1 + R[6] * d2,
                      R[1] * d0 + R[4] * d1 + R[7] * d2,
                      R[2] * d0 + R[5] * d1 + R[8] * d2};
  const float sk[3][3] = {{0.0f, -y[2], y[1]}, {y[2], 0.0f, -y[0]},
                          {-y[1], y[0], 0.0f}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r[3 + i] = y[i] - dp[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float rt = R[3 * k + i];  // R^T[i][k]
      Ji[i * 6 + k] = Drot_i[i][k];
      Ji[i * 6 + 3 + k] = 0.0f;
      Ji[(3 + i) * 6 + k] = sk[i][k];
      Ji[(3 + i) * 6 + 3 + k] = -rt;
      Jj[i * 6 + k] = Drot_j[i][k];
      Jj[i * 6 + 3 + k] = 0.0f;
      Jj[(3 + i) * 6 + k] = 0.0f;
      Jj[(3 + i) * 6 + 3 + k] = rt;
    }
  }
}

__global__ void __launch_bounds__(kThreads) ba_kernel(
    Params c, const float* __restrict__ kf_pos,
    const float* __restrict__ kf_quat, const float* __restrict__ points,
    const float* __restrict__ obs_uv, const float* __restrict__ obs_z,
    const float* __restrict__ obs_w, const float* __restrict__ rel_dp,
    const float* __restrict__ rel_dq, const float* __restrict__ w_rel,
    const float* __restrict__ prior, float* __restrict__ out_pos,
    float* __restrict__ out_quat, float* __restrict__ out_pts,
    float* __restrict__ out_cost) {
  extern __shared__ float sm[];
  const int K = c.K, P = c.P;
  const int N = 6 * K, ld = N + 1;
  float* S = sm;                        // N x (N + 1): [S | rhs]
  float* gj_col = S + N * ld;           // N
  float* gj_row = gj_col + N;           // N + 1
  float* pos = gj_row + (N + 1);        // K x 3
  float* quat = pos + K * 3;            // K x 4
  float* R = quat + K * 4;              // K x 9
  float* hpp = R + K * 9;               // K x 27
  float* rel = hpp + K * kAcc;          // (K - 1) x 78
  float* wrel = rel + (K - 1) * kRel;   // K - 1
  float* pts = wrel + (K - 1);          // P x 3
  float* hl = pts + P * 3;              // P x 9: A_p (then A_p^-1) | g_l_p
  float* red = hl + P * 9;              // kWarps
  float* tileB = red + kWarps;          // kTile x K x 19
  float* tileC = tileB + kTile * K * kBlk;
  float* partial = tileB;               // K x kWarps x 27, before the tiles

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* g_uv = obs_uv + static_cast<size_t>(b) * K * P * 2;
  const float* g_z = obs_z + static_cast<size_t>(b) * K * P;
  const float* g_w = obs_w + static_cast<size_t>(b) * K * P;
  const float* g_pts0 = points + static_cast<size_t>(b) * P * 3;
  const float* g_prior = prior + static_cast<size_t>(b) * P;
  const float* g_dp = rel_dp + static_cast<size_t>(b) * (K - 1) * 3;
  const float* g_dq = rel_dq + static_cast<size_t>(b) * (K - 1) * 4;

  for (int i = tid; i < K * 3; i += kThreads)
    pos[i] = kf_pos[static_cast<size_t>(b) * K * 3 + i];
  for (int i = tid; i < K * 4; i += kThreads)
    quat[i] = kf_quat[static_cast<size_t>(b) * K * 4 + i];
  for (int i = tid; i < P * 3; i += kThreads) pts[i] = g_pts0[i];
  for (int i = tid; i < K - 1; i += kThreads)
    wrel[i] = w_rel[static_cast<size_t>(b) * (K - 1) + i];
  __syncthreads();

  float cost = 0.0f;  // thread 0's
  for (int it = 0; it < c.n_iter; ++it) {
    for (int k = tid; k < K; k += kThreads) quat_to_mat(quat + 4 * k, R + 9 * k);
    for (int i = tid; i < P * 9; i += kThreads) hl[i] = 0.0f;
    __syncthreads();

    // --- phase 1: normal-equation blocks, keyframe by keyframe; a thread
    // owns the landmarks tid, tid + 256, ... ---
    float cost_acc = 0.0f;
    for (int k = 0; k < K; ++k) {
      float acc[kAcc];
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[e] = 0.0f;
      for (int p = tid; p < P; p += kThreads) {
        Obs o;
        const int kp = k * P + p;
        observe(c, R + 9 * k, pos + 3 * k, pts + 3 * p, g_uv[2 * kp],
                g_uv[2 * kp + 1], g_z[kp], g_w[kp], o);
        float* h = hl + 9 * p;
        int idx = 0;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
#pragma unroll
          for (int m = j; m < 3; ++m) {
            h[idx++] += o.w * (o.Jl[0][j] * o.Jl[0][m] + o.Jl[1][j] * o.Jl[1][m] +
                               o.Jl[2][j] * o.Jl[2][m]);
          }
        }
#pragma unroll
        for (int j = 0; j < 3; ++j)
          h[6 + j] += o.w * (o.Jl[0][j] * o.r[0] + o.Jl[1][j] * o.r[1] +
                             o.Jl[2][j] * o.r[2]);
        float Jp[3][6];
        pose_jacobian(o, Jp);
        idx = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = i; j < 6; ++j) {
            acc[idx++] += o.w * (Jp[0][i] * Jp[0][j] + Jp[1][i] * Jp[1][j] +
                                 Jp[2][i] * Jp[2][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 6; ++i)
          acc[21 + i] += o.w * (Jp[0][i] * o.r[0] + Jp[1][i] * o.r[1] +
                                Jp[2][i] * o.r[2]);
        cost_acc += o.w * (o.r[0] * o.r[0] + o.r[1] * o.r[1] + o.r[2] * o.r[2]);
      }
#pragma unroll
      for (int e = 0; e < kAcc; ++e) {
        float x = acc[e];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_down_sync(kFull, x, off);
        if (lane == 0) partial[(k * kWarps + warp) * kAcc + e] = x;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cost_acc += __shfl_down_sync(kFull, cost_acc, off);
    if (lane == 0) red[warp] = cost_acc;
    __syncthreads();
    for (int e = tid; e < K * kAcc; e += kThreads) {
      const int k = e / kAcc, j = e % kAcc;
      float x = 0.0f;
      for (int wdx = 0; wdx < kWarps; ++wdx)
        x += partial[(k * kWarps + wdx) * kAcc + j];
      hpp[e] = x;
    }

    // --- phase 2: A_p^-1 by the adjugate, landmark prior ---
    for (int p = tid; p < P; p += kThreads) {
      float* h = hl + 9 * p;
      const float pw = g_prior[p];
      const float a = h[0] + pw + c.damping, bb = h[1], cc = h[2];
      const float e = h[3] + pw + c.damping, f = h[4];
      const float i = h[5] + pw + c.damping;
      const float A11 = e * i - f * f;
      const float A12 = cc * f - bb * i;
      const float A13 = bb * f - cc * e;
      const float A22 = a * i - cc * cc;
      const float A23 = cc * bb - a * f;
      const float A33 = a * e - bb * bb;
      const float det = a * A11 + bb * A12 + cc * A13;
      const float idet = 1.0f / (fabsf(det) > 1e-12f ? det : 1e-12f);
      h[0] = A11 * idet; h[1] = A12 * idet; h[2] = A13 * idet;
      h[3] = A22 * idet; h[4] = A23 * idet; h[5] = A33 * idet;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        h[6 + j] += pw * (pts[3 * p + j] - g_pts0[3 * p + j]);
    }

    // --- phase 3: relative factors, then the pose system without the
    // landmarks' Schur term ---
    for (int k = tid; k < K - 1; k += kThreads)
      rel_factor(pos + 3 * k, quat + 4 * k, pos + 3 * (k + 1),
                 quat + 4 * (k + 1), g_dp + 3 * k, g_dq + 4 * k,
                 rel + k * kRel);
    for (int i = tid; i < N * ld; i += kThreads) S[i] = 0.0f;
    __syncthreads();
    if (tid == 0) {
      float x = 0.0f;
      for (int wdx = 0; wdx < kWarps; ++wdx) x += red[wdx];
      for (int k = 0; k < K - 1; ++k) {
        const float* r = rel + k * kRel;
        float rr = 0.0f;
        for (int i = 0; i < 6; ++i) rr += r[i] * r[i];
        x += wrel[k] * rr;
      }
      cost = x;
    }
    for (int e = tid; e < K * 36; e += kThreads) {
      const int k = e / 36, i = (e % 36) / 6, j = e % 6;
      float val = hpp[k * kAcc + (i <= j ? tri(i, j) : tri(j, i))];
      if (k < K - 1) {
        const float* Ji = rel + k * kRel + 6;
        const float* Jj = Ji + 36;
        float dsum = 0.0f, osum = 0.0f;
        for (int r = 0; r < 6; ++r) {
          dsum += Ji[r * 6 + i] * Ji[r * 6 + j];
          osum += Ji[r * 6 + i] * Jj[r * 6 + j];
        }
        val += wrel[k] * dsum;
        osum *= wrel[k];
        S[(6 * k + i) * ld + 6 * (k + 1) + j] = osum;
        S[(6 * (k + 1) + j) * ld + 6 * k + i] = osum;
      }
      if (k > 0) {
        const float* Jj = rel + (k - 1) * kRel + 42;
        float dsum = 0.0f;
        for (int r = 0; r < 6; ++r) dsum += Jj[r * 6 + i] * Jj[r * 6 + j];
        val += wrel[k - 1] * dsum;
      }
      if (i == j) val += c.damping + (k == 0 ? kGauge : 0.0f);
      S[(6 * k + i) * ld + 6 * k + j] = val;
    }
    for (int a = tid; a < N; a += kThreads) {
      const int k = a / 6, i = a % 6;
      float g = hpp[k * kAcc + 21 + i];
      if (k < K - 1) {
        const float* r = rel + k * kRel;
        const float* Ji = r + 6;
        float x = 0.0f;
        for (int q = 0; q < 6; ++q) x += Ji[q * 6 + i] * r[q];
        g += wrel[k] * x;
      }
      if (k > 0) {
        const float* r = rel + (k - 1) * kRel;
        const float* Jj = r + 42;
        float x = 0.0f;
        for (int q = 0; q < 6; ++q) x += Jj[q * 6 + i] * r[q];
        g += wrel[k - 1] * x;
      }
      S[a * ld + N] = -g;
    }
    __syncthreads();

    // --- phase 4: Schur complement over the landmarks, a tile at a time ---
    for (int p0 = 0; p0 < P; p0 += kTile) {
      for (int item = tid; item < kTile * K; item += kThreads) {
        const int pl = item / K, k = item % K;
        const int p = p0 + pl;
        float* tb = tileB + item * kBlk;
        float* tc = tileC + item * kBlk;
        if (p < P) {
          Obs o;
          const int kp = k * P + p;
          observe(c, R + 9 * k, pos + 3 * k, pts + 3 * p, g_uv[2 * kp],
                  g_uv[2 * kp + 1], g_z[kp], g_w[kp], o);
          float Jp[3][6];
          pose_jacobian(o, Jp);
          const float* h = hl + 9 * p;
          const float Hi[3][3] = {{h[0], h[1], h[2]}, {h[1], h[3], h[4]},
                                  {h[2], h[4], h[5]}};
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            float bi[3];
#pragma unroll
            for (int m = 0; m < 3; ++m)
              bi[m] = o.w * (Jp[0][i] * o.Jl[0][m] + Jp[1][i] * o.Jl[1][m] +
                             Jp[2][i] * o.Jl[2][m]);
#pragma unroll
            for (int m = 0; m < 3; ++m) {
              tb[i * 3 + m] = bi[m];
              tc[i * 3 + m] = bi[0] * Hi[0][m] + bi[1] * Hi[1][m] + bi[2] * Hi[2][m];
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 18; ++i) {
            tb[i] = 0.0f;
            tc[i] = 0.0f;
          }
        }
      }
      __syncthreads();
      const int npl = min(kTile, P - p0);
      for (int pair = tid; pair < K * K; pair += kThreads) {
        const int ka = pair / K, kb = pair % K;
        float acc[36];
#pragma unroll
        for (int e = 0; e < 36; ++e) acc[e] = 0.0f;
        float accg[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int pl = 0; pl < npl; ++pl) {
          const float* cp = tileC + (pl * K + ka) * kBlk;
          const float* bp = tileB + (pl * K + kb) * kBlk;
          float cv[18], bv[18];
#pragma unroll
          for (int e = 0; e < 18; ++e) {
            cv[e] = cp[e];
            bv[e] = bp[e];
          }
#pragma unroll
          for (int i = 0; i < 6; ++i) {
#pragma unroll
            for (int j = 0; j < 6; ++j)
              acc[i * 6 + j] += cv[i * 3] * bv[j * 3] + cv[i * 3 + 1] * bv[j * 3 + 1] +
                                cv[i * 3 + 2] * bv[j * 3 + 2];
          }
          if (ka == kb) {
            const float* gl = hl + 9 * (p0 + pl) + 6;
#pragma unroll
            for (int i = 0; i < 6; ++i)
              accg[i] += cv[i * 3] * gl[0] + cv[i * 3 + 1] * gl[1] + cv[i * 3 + 2] * gl[2];
          }
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = 0; j < 6; ++j)
            S[(6 * ka + i) * ld + 6 * kb + j] -= acc[i * 6 + j];
        }
        if (ka == kb) {
#pragma unroll
          for (int i = 0; i < 6; ++i) S[(6 * ka + i) * ld + N] += accg[i];
        }
      }
      __syncthreads();
    }

    // --- phase 5: the reduced solve ---
    gauss_jordan_solve(S, N, ld, gj_col, gj_row);
    for (int a = tid; a < N; a += kThreads) {
      const float x = S[a * ld + N];
      if (!isfinite(x)) S[a * ld + N] = 0.0f;
    }
    __syncthreads();

    // --- phase 6: back-substitute the landmarks at the old linearization
    // point, then move the poses ---
    for (int p = tid; p < P; p += kThreads) {
      float bt[3] = {0.0f, 0.0f, 0.0f};
      for (int k = 0; k < K; ++k) {
        Obs o;
        const int kp = k * P + p;
        observe(c, R + 9 * k, pos + 3 * k, pts + 3 * p, g_uv[2 * kp],
                g_uv[2 * kp + 1], g_z[kp], g_w[kp], o);
        float dxk[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) dxk[i] = S[(6 * k + i) * ld + N];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const float sr = o.w * (o.Jr[r][0] * dxk[0] + o.Jr[r][1] * dxk[1] +
                                  o.Jr[r][2] * dxk[2] - o.Jl[r][0] * dxk[3] -
                                  o.Jl[r][1] * dxk[4] - o.Jl[r][2] * dxk[5]);
#pragma unroll
          for (int m = 0; m < 3; ++m) bt[m] += o.Jl[r][m] * sr;
        }
      }
      const float* h = hl + 9 * p;
      const float q0 = h[6] + bt[0], q1 = h[7] + bt[1], q2 = h[8] + bt[2];
      pts[3 * p] -= h[0] * q0 + h[1] * q1 + h[2] * q2;
      pts[3 * p + 1] -= h[1] * q0 + h[3] * q1 + h[4] * q2;
      pts[3 * p + 2] -= h[2] * q0 + h[4] * q1 + h[5] * q2;
    }
    __syncthreads();
    for (int k = tid; k < K; k += kThreads) {
      float dth[3], dq[4], qn[4];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        dth[i] = S[(6 * k + i) * ld + N];
        pos[3 * k + i] += S[(6 * k + 3 + i) * ld + N];
      }
      so3_exp(dth, dq);
      quat_mul(quat + 4 * k, dq, qn);
      const float inv = 1.0f / sqrtf(qn[0] * qn[0] + qn[1] * qn[1] +
                                     qn[2] * qn[2] + qn[3] * qn[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) quat[4 * k + i] = qn[i] * inv;
    }
    __syncthreads();
  }

  for (int i = tid; i < K * 3; i += kThreads)
    out_pos[static_cast<size_t>(b) * K * 3 + i] = pos[i];
  for (int i = tid; i < K * 4; i += kThreads)
    out_quat[static_cast<size_t>(b) * K * 4 + i] = quat[i];
  for (int i = tid; i < P * 3; i += kThreads)
    out_pts[static_cast<size_t>(b) * P * 3 + i] = pts[i];
  if (tid == 0) out_cost[b] = cost;
}

}  // namespace

// Dynamic shared memory, in bytes, that a (K, P) window needs; the caller
// refuses a shape beyond the card's 232448 bytes a block.
extern "C" int ba_smem_bytes(int K, int P) {
  return smem_floats(K, P) * static_cast<int>(sizeof(float));
}

// Plain C entry point, loaded with ctypes.  All buffers are contiguous
// float32 on the device: kf_pos (B, K, 3), kf_quat (B, K, 4), points
// (B, P, 3), obs_uv (B, K, P, 2), obs_z and obs_w (B, K, P), rel_dp
// (B, K-1, 3), rel_dq (B, K-1, 4), w_rel (B, K-1), prior (B, P; zeros for free
// points); outputs out_pos, out_quat, out_pts shaped like the first three and
// out_cost (B,).  Returns the CUDA error code of the launch (0 = launched;
// cudaErrorInvalidValue for K < 2, P < 1 or n_iter < 1).
extern "C" int ba_solve(const void* kf_pos, const void* kf_quat,
                        const void* points, const void* obs_uv,
                        const void* obs_z, const void* obs_w,
                        const void* rel_dp, const void* rel_dq,
                        const void* w_rel, const void* prior, int B, int K,
                        int P, int n_iter, float fx, float fy, float cx,
                        float cy, float t_fwd, float t_up, float depth_noise,
                        float huber_px, float damping, void* out_pos,
                        void* out_quat, void* out_pts, void* out_cost,
                        void* stream) {
  if (B < 1 || K < 2 || P < 1 || n_iter < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ba_smem_bytes(K, P);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ba_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Params c{fx, fy, cx, cy, t_fwd, t_up, depth_noise, huber_px, damping,
           K, P, n_iter};
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
  ba_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      c, f(kf_pos), f(kf_quat), f(points), f(obs_uv), f(obs_z), f(obs_w),
      f(rel_dp), f(rel_dq), f(w_rel), f(prior), g(out_pos), g(out_quat),
      g(out_pts), g(out_cost));
  return static_cast<int>(cudaGetLastError());
}
