// Batched sliding-window bundle adjustment for Hopper (sm_90a): a whole
// damped Gauss-Newton solve of one window per cluster of thread blocks, in
// one launch.
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
//   M(k,p)  = Jp^T w Jp (6 x 6, Jp = [Jr | -Jl]),  v(k,p) = Jp^T w r
//   A_p     = sum_k Jl^T w Jl + (prior_p + damping) I,  its adjugate inverse
//             (determinant guard 1e-12);  Jl^T w Jl is M's lower right block
//   g_l_p   = sum_k Jl^T w r + prior_p (X_p - X_p at input) = -sum_k v[3:6] + ...
//   H_kk    = sum_p M(k,p),  g_k = sum_p v(k,p)
//   B_pk    = Jp^T w Jl = -M(k,p)[:, 3:6]
//   K - 1 relative-pose factors [log(dq^-1 q_i^-1 q_j), R_i^T (p_j - p_i) - dp]
//   with weight w_rel on the block tridiagonal, a gauge prior 1e4 on
//   keyframe 0, damping on the diagonal
//   S       = H - sum_p B_p A_p^-1 B_p^T,  rhs = -(g - sum_p B_p A_p^-1 g_l_p)
//   S dx = rhs by an unpivoted Cholesky factorisation; a pivot that is not
//   positive (or not finite) gives the whole window dx = 0, and a
//   non-finite dx entry becomes 0;  dX_p = -A_p^-1 (g_l_p + B_p^T dx)
//   pos += dx_t,  q <- normalize(q exp(dx_theta)),  X += dX
//
// and the cost sum w |r|^2 + sum w_rel |r_rel|^2 at the last linearization
// point.  All Jacobians are analytic (the reference takes the relative
// factors' with jacfwd of the same residual, the so3_log included).
//
// What bounds it on an H100.  A 16 x 192 window moves 60 KB in and 3 KB out
// and needs ~2 MFLOP an iteration with every observation present (~630
// operations an observation, the symmetric half of the Schur product, and
// a Cholesky of the 96 x 96 reduced system): microseconds at the card's
// float32 rate.  The main path calls it on 15 windows (one per route) every
// tenth repeat tick, the batch benchmark on 64.  The first version ran one
// block of a window on one SM (15 of 132 busy at the rollout's call) and
// spent its ~600 k cycles an iteration on chains of dependent steps inside
// that block: 58 % on 96 Gauss-Jordan pivot steps of two barriers each,
// 32 % on the whole Schur product (all 256 keyframe pairs) on one SM.  So
// its time is latency: the length of those chains, not bytes or operations.
//
// What the design does about it.  A window is solved by a cluster of C
// blocks (the plan in ops/ba.py picks C, the landmark slices, the chunk of
// landmarks a pass holds and the keyframe bands).  Rank r owns a contiguous
// slice of about P / C landmarks and the band of keyframes [r Kr, (r+1) Kr).
//   - Its landmarks go through shared memory a chunk at a time.  A thread a
//     (landmark, keyframe) observation computes the residual, the weight and
//     the 30 numbers that everything else needs: Bs = M[:, 3:6] (18, stored
//     transposed as Y), the upper half of M's rotation block (6) and v (6).
//     A thread a (landmark, entry) sums A_p and g_l_p over the keyframes, a
//     thread a landmark inverts A_p, and a thread an observation forms
//     X = (Bs A_p^-1)^T.  Where the whole slice's Y fits, it stays for the
//     back-substitution; otherwise each chunk's is formed again there.
//   - Its partial reduced system, upper blocks only (136 of 256 at K = 16):
//     warps 0-3 take the blocks ka < kb, each a 6 x 6 register tile of
//     -sum X[., 6ka..] Y[., 6kb..]^T over the chunk; warps 4-6 take the rows
//     of the diagonal blocks (M, the Schur term and the rhs); warp 7 forms
//     the relative factors that the band needs.
//   - After a cluster barrier rank r sums its band's rows of the C partial
//     systems (from each row's first upper-block float4; the rhs and the
//     partial costs ride in the pad column) in rank order, adds the band's
//     pose-only terms (relative factors, gauge prior, damping) and pushes
//     the rows into every rank's system through distributed shared memory.
//     Only rank r reads its band's rows, so a second barrier is all that
//     stands between the pushes and the solve; no block touches another's
//     memory after it, so none waits to leave.
//   - Every rank factors the same system in the same order (the same bits
//     in every rank), S = U^T U in place, right-looking over 8-column
//     panels: one thread factors the 8 x 8 diagonal tile in registers (an
//     rsqrt a pivot), a thread a column solves the panel's rows, a thread a
//     4 x 4 tile updates the trailing upper triangle; three barriers a
//     panel, one a panel in the back substitution.  A pivot that is not
//     positive zeroes the window's step.  So each rank has dx for its own
//     landmarks' back-substitution (four lanes a landmark) and updates all K
//     poses itself.
// Every sum runs in a fixed order and no float atomics are used, so a run
// repeats bit for bit.  The P-on-lanes layout, the Gauss-Jordan solve, the
// pltpu.repeat block placement, the masked-reduction row extraction and the
// polynomial arcsine of the TPU kernel are Mosaic workarounds and have no
// counterpart here.
//
// Measured (tools/torch_ba_probe.py, NVIDIA H100 80GB HBM3, 700 W; ms a
// launch from a CUDA graph, the rollout's (15,16,192) x 3 / the bench's
// (64,16,192) x 8): the first version 0.920 / 2.434; this one 0.0986 /
// 0.509 (C = 8 / 2; C = 1, 2, 4, 8 give 0.366, 0.192, 0.128, 0.0986 and
// 0.969, 0.509, 0.993, 1.263).  Of a rollout block's 67.7 k cycles an
// iteration the reduced solve takes 32.8 k: 12 panels of a single-thread
// factor (~860 cycles), panel columns (~390) and a trailing update (~1010)
// between barriers, and 12 back-substitution steps.  That chain of
// dependent steps, not the card's rates, is what holds it now; a
// look-ahead that factored the next tile beside the trailing update was
// slower (its warp's block update and factor outlasted the update).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

#ifdef BA_PROFILE
// per-phase clock64 cycles summed over blocks (thread 0 of each, each stamp
// after a block barrier), and the number of blocks (tools/torch_ba_probe.py)
__device__ unsigned long long g_prof[16];
#define PROF_INIT long long prof_t = clock64()
#define PROF_STAMP(i)                                               \
  do {                                                              \
    if (threadIdx.x == 0) {                                         \
      const long long t_ = clock64();                               \
      atomicAdd(&g_prof[i], static_cast<unsigned long long>(t_ - prof_t)); \
      prof_t = t_;                                                  \
    }                                                               \
  } while (0)
#define PROF_FLUSH \
  do { if (threadIdx.x == 0) atomicAdd(&g_prof[15], 1ull); } while (0)
#else
#define PROF_INIT
#define PROF_STAMP(i)
#define PROF_FLUSH
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kExtra = 12;  // floats an observation besides Bs: M[0:3,0:3] | v
constexpr int kRel = 78;    // a relative factor: r (6), J_i (36), J_j (36)
constexpr int kPanel = 8;   // the Cholesky's panel width
constexpr int kMaxCluster = 8;
// the chunk's phase of the Schur product: warps 0-3 take the off-diagonal
// blocks, warps 4-6 the rows of the diagonal blocks, warp 7 the relative
// factors (in the first chunk)
constexpr int kGemmThreads = 128;
constexpr int kDiagThreads = 96;
constexpr int kSideWarp = 7;
constexpr float kGauge = 1e4f;
constexpr float kHuberZ = 6.0f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  float fx, fy, cx, cy, t_fwd, t_up, depth_noise, huber_px, damping;
  int K, P, n_iter;
  int Pr;  // landmarks a rank
  int Lc;  // landmarks a chunk
  int Yl;  // landmarks whose Bs^T the rank holds: Pr (all) or Lc (a chunk)
  int Kr;  // keyframes a rank's band
};

__host__ __device__ inline int pad_n(int K) {
  return (6 * K + kPanel - 1) / kPanel * kPanel;
}

__host__ __device__ inline int ld_of(int K) { return pad_n(K) + 4; }

// 6K rounded up to whole float4s: the row stride of a chunk's Y and X
__host__ __device__ inline int n6p_of(int K) { return (6 * K + 3) / 4 * 4; }

// Offsets (floats) of a rank's shared memory; ops/ba.py:smem_bytes repeats
// the sum.  Everything up to E starts on a 16-byte boundary.
struct Layout {
  int S, rhs, dinv, vb, Y, X, E, As, pos, quat, R, rel, wrel, relcost, pts,
      pts0, prior, lm, red, misc, total;
};

__host__ __device__ inline Layout layout(int K, int Pr, int Lc, int Yl) {
  const int npad = pad_n(K), ld = ld_of(K), n6p = n6p_of(K);
  Layout L;
  int o = 0;
  L.S = o;       o += npad * ld;       // the system, upper blocks: U in place
  L.rhs = o;     o += npad;            // rhs, then y, then dx
  L.dinv = o;    o += npad;            // 1 / diag(U)
  L.vb = o;      o += 4 * kPanel;      // y_J | x_J by parity
  L.Y = o;       o += 3 * Yl * n6p;    // Bs^T: [landmark][m][6k + i]
  L.X = o;       o += 3 * Lc * n6p;    // (Bs A_p^-1)^T, the same layout
  L.E = o;       o += kExtra * K * Lc; // [landmark][keyframe][12]
  L.As = o;      o += 9 * Lc;          // A_p (upper 6) | g_l_p (3) sums
  L.pos = o;     o += 3 * K;
  L.quat = o;    o += 4 * K;
  L.R = o;       o += 9 * K;
  L.rel = o;     o += kRel * (K - 1);
  L.wrel = o;    o += K - 1;
  L.relcost = o; o += K - 1;
  L.pts = o;     o += 3 * Pr;
  L.pts0 = o;    o += 3 * Pr;
  L.prior = o;   o += Pr;
  L.lm = o;      o += 9 * Pr;          // A_p^-1 (upper 6) | g_l_p (3)
  L.red = o;     o += kWarps;
  L.misc = o;    o += 4;               // partial cost | window flag
  L.total = o;
  return L;
}

// One (keyframe, landmark) observation at the current estimate.
struct Obs {
  float r[3];      // residual
  float w;         // robust weight
  float Jl[3][3];  // d r / d landmark, [row][column]
  float Jr[3][3];  // d r / d rotation increment; d r / d translation = -Jl
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" : : : "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" : : : "memory");
}

__device__ __forceinline__ int tri3(int i, int j) {  // i <= j < 3
  return i * 3 - (i * (i - 1)) / 2 + (j - i);
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

// The observation (k, p) of landmark X at the current estimate, with
// M = Jp^T w Jp and v = Jp^T w r (Jp = [Jr | -Jl]): Bs = M[:, 3:6] goes to
// y[m * stride + i] (row i of 6, column m of 3: the landmark's three rows
// of the chunk's Y, at this keyframe's six columns), and the upper half of
// M[0:3, 0:3] (6) and v (6) to e.  Returns w |r|^2.
__device__ __forceinline__ float observation(const Params& c, const float* R,
                                             const float* pos, const float* X,
                                             const float* __restrict__ g_uv,
                                             const float* __restrict__ g_z,
                                             const float* __restrict__ g_w,
                                             int kp, float* y, int stride,
                                             float* e) {
  Obs o;
  observe(c, R, pos, X, __ldg(g_uv + 2 * kp), __ldg(g_uv + 2 * kp + 1),
          __ldg(g_z + kp), __ldg(g_w + kp), o);
  float Jp[3][6];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Jp[r][i] = o.Jr[r][i];
      Jp[r][3 + i] = -o.Jl[r][i];
    }
  }
  float wJl[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int m = 0; m < 3; ++m) wJl[r][m] = o.w * Jp[r][3 + m];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int m = 0; m < 3; ++m)
      y[m * stride + i] = Jp[0][i] * wJl[0][m] + Jp[1][i] * wJl[1][m] +
                          Jp[2][i] * wJl[2][m];
  const float wr[3] = {o.w * o.r[0], o.w * o.r[1], o.w * o.r[2]};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j)
      e[tri3(i, j)] = o.w * (Jp[0][i] * Jp[0][j] + Jp[1][i] * Jp[1][j] +
                             Jp[2][i] * Jp[2][j]);
#pragma unroll
  for (int i = 0; i < 6; ++i)
    e[6 + i] = Jp[0][i] * wr[0] + Jp[1][i] * wr[1] + Jp[2][i] * wr[2];
  return wr[0] * o.r[0] + wr[1] * o.r[1] + wr[2] * o.r[2];
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

// Pose k moved by dx (rhs): pos += dx_t, q <- normalize(q exp(dx_theta)).
__device__ __forceinline__ void update_pose(const float* dx, float* pos,
                                            float* quat, int k) {
  float dth[3], dq[4], qn[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dth[i] = dx[6 * k + i];
    pos[3 * k + i] += dx[6 * k + 3 + i];
  }
  so3_exp(dth, dq);
  quat_mul(quat + 4 * k, dq, qn);
  const float inv = 1.0f / sqrtf(qn[0] * qn[0] + qn[1] * qn[1] +
                                 qn[2] * qn[2] + qn[3] * qn[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) quat[4 * k + i] = qn[i] * inv;
}

// --- the reduced solve: S = U^T U in place (upper triangle of an npad x
// npad matrix with row stride ld, npad a multiple of kPanel), rhs <- dx ---

#ifdef BA_PROFILE
#define PROF_PARAM , long long& prof_t
#define PROF_ARG , prof_t
#else
#define PROF_PARAM
#define PROF_ARG
#endif

// One thread: factor the diagonal tile at t0, already updated by the
// earlier panels, in registers (its upper triangle).  A pivot that is not
// positive (or NaN) is taken as 1 and sets *bad.  Also the tile's part of
// the forward substitution: y_J = U_JJ^-T rhs_J into rhs and y.
__device__ __forceinline__ void factor_tile(float* A, int ld, int t0,
                                            float* rhs, float* dinv,
                                            float* y, int* bad) {
  float a[kPanel][kPanel];
  float inv[kPanel];
#pragma unroll
  for (int i = 0; i < kPanel; ++i)
#pragma unroll
    for (int j = i; j < kPanel; ++j) a[i][j] = A[(t0 + i) * ld + t0 + j];
  bool fail = false;
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    float d = a[c][c];
    if (!(d > 0.0f)) {
      fail = true;
      d = 1.0f;
    }
    inv[c] = rsqrtf(d);
    a[c][c] = d * inv[c];
#pragma unroll
    for (int j = c + 1; j < kPanel; ++j) a[c][j] *= inv[c];
#pragma unroll
    for (int i = c + 1; i < kPanel; ++i)
#pragma unroll
      for (int j = i; j < kPanel; ++j)
        a[i][j] = fmaf(-a[c][i], a[c][j], a[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kPanel; ++i) {
    dinv[t0 + i] = inv[i];
#pragma unroll
    for (int j = i; j < kPanel; ++j) A[(t0 + i) * ld + t0 + j] = a[i][j];
  }
  if (fail) *bad = 1;
  float yv[kPanel];
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    float s = rhs[t0 + c];
#pragma unroll
    for (int m = 0; m < c; ++m) s = fmaf(-a[m][c], yv[m], s);
    yv[c] = s * inv[c];
    rhs[t0 + c] = yv[c];
    y[c] = yv[c];
  }
}

// Columns r in [t0 + kPanel, npad) of the panel's rows, a thread a column:
// U_JJ^T x = A[t0.., r] by substitution; x goes back to A, and the forward
// substitution's rhs_r -= x . y_J.
__device__ __forceinline__ void panel_columns(float* A, int ld, int t0,
                                              int npad, const float* dinv,
                                              const float* y, float* rhs) {
  for (int r = t0 + kPanel + threadIdx.x; r < npad; r += kThreads) {
    float x[kPanel];
#pragma unroll
    for (int k = 0; k < kPanel; ++k) x[k] = A[(t0 + k) * ld + r];
#pragma unroll
    for (int c = 0; c < kPanel; ++c) {
      x[c] *= dinv[t0 + c];
#pragma unroll
      for (int k = c + 1; k < kPanel; ++k)
        x[k] = fmaf(-A[(t0 + c) * ld + t0 + k], x[c], x[k]);
    }
    float s = rhs[r];
#pragma unroll
    for (int k = 0; k < kPanel; ++k) {
      A[(t0 + k) * ld + r] = x[k];
      s = fmaf(-x[k], y[k], s);
    }
    rhs[r] = s;
  }
}

// The trailing upper triangle: A[i][j] -= sum_c U[t0+c][i] U[t0+c][j] for
// t1 <= i <= j, a thread a 4 x 4 tile (tiles on and above the diagonal).
__device__ __forceinline__ void trailing_update(float* A, int ld, int t0,
                                                int npad) {
  const int t1 = t0 + kPanel;
  const int T = (npad - t1) / 4;
  const int n_tiles = T * (T + 1) / 2;
  for (int t = threadIdx.x; t < n_tiles; t += kThreads) {
    int I = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    while (I * (I + 1) / 2 > t) --I;
    while ((I + 1) * (I + 2) / 2 <= t) ++I;
    const int Jt = t - I * (I + 1) / 2;      // Jt <= I: tile (Jt, I)
    const int i0 = t1 + 4 * Jt, j0 = t1 + 4 * I;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(A + (i0 + i) * ld + j0);
      acc[i][0] = v.x; acc[i][1] = v.y; acc[i][2] = v.z; acc[i][3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < kPanel; ++c) {
      const float4 u = *reinterpret_cast<const float4*>(A + (t0 + c) * ld + i0);
      const float4 v = *reinterpret_cast<const float4*>(A + (t0 + c) * ld + j0);
      const float ui[4] = {u.x, u.y, u.z, u.w};
      const float vj[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(-ui[i], vj[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(A + (i0 + i) * ld + j0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// rhs = U^-1 rhs (rhs holds y on entry), panel by panel from the last:
// lanes 0-7 apply x_{J+1} to tile J's rows, lane 0 solves U_JJ x_J = (...)
// in registers, while the threads from 32 on apply x_{J+1} to the rows
// above tile J; one barrier a panel.
__device__ __forceinline__ void back_substitute(const float* A, int ld,
                                                int npad, float* rhs,
                                                const float* dinv,
                                                float* xb) {
  const int nb = npad / kPanel;
  for (int J = nb - 1; J >= 0; --J) {
    const int t0 = J * kPanel;
    const bool has_next = J + 1 < nb;
    const float* xn = xb + ((J + 1) & 1) * kPanel;   // x_{J+1}
    if (threadIdx.x < kPanel && has_next) {
      const int i = threadIdx.x;
      const float* row = A + (t0 + i) * ld + t0 + kPanel;
      float s = rhs[t0 + i];
#pragma unroll
      for (int r = 0; r < kPanel; ++r) s = fmaf(-row[r], xn[r], s);
      rhs[t0 + i] = s;
    }
    __syncwarp();
    if (threadIdx.x == 0) {
      float s[kPanel];
#pragma unroll
      for (int i = 0; i < kPanel; ++i) s[i] = rhs[t0 + i];
#pragma unroll
      for (int c = kPanel - 1; c >= 0; --c) {
        s[c] *= dinv[t0 + c];
#pragma unroll
        for (int i = 0; i < c; ++i)
          s[i] = fmaf(-A[(t0 + i) * ld + t0 + c], s[c], s[i]);
      }
#pragma unroll
      for (int i = 0; i < kPanel; ++i) {
        rhs[t0 + i] = s[i];
        xb[(J & 1) * kPanel + i] = s[i];
      }
    } else if (has_next && threadIdx.x >= 32) {
      for (int i = threadIdx.x - 32; i < t0; i += kThreads - 32) {
        const float* row = A + i * ld + t0 + kPanel;
        float s = rhs[i];
#pragma unroll
        for (int r = 0; r < kPanel; r += 4) {
          const float4 u = *reinterpret_cast<const float4*>(row + r);
          s = fmaf(-u.x, xn[r], s);
          s = fmaf(-u.y, xn[r + 1], s);
          s = fmaf(-u.z, xn[r + 2], s);
          s = fmaf(-u.w, xn[r + 3], s);
        }
        rhs[i] = s;
      }
    }
    __syncthreads();
  }
}

// S dx = rhs by the blocked Cholesky; rhs holds dx on return (every entry 0
// if a pivot failed, a non-finite entry 0).
__device__ void reduced_solve(float* A, int ld, int npad, float* rhs,
                              float* dinv, float* vb, int* bad PROF_PARAM) {
  const int nb = npad / kPanel;
  for (int J = 0; J < nb; ++J) {
    const int t0 = J * kPanel;
    if (threadIdx.x == 0) factor_tile(A, ld, t0, rhs, dinv, vb, bad);
    __syncthreads();
    PROF_STAMP(8);
    if (J + 1 < nb) {
      panel_columns(A, ld, t0, npad, dinv, vb, rhs);
      __syncthreads();
      PROF_STAMP(9);
      trailing_update(A, ld, t0, npad);
      __syncthreads();
      PROF_STAMP(10);
    }
  }
  back_substitute(A, ld, npad, rhs, dinv, vb + 2 * kPanel);
  PROF_STAMP(11);
  const bool zero = *bad != 0;
  for (int a = threadIdx.x; a < npad; a += kThreads) {
    const float x = rhs[a];
    rhs[a] = zero || !isfinite(x) ? 0.0f : x;
  }
  __syncthreads();
}

// The band's pose-only term at (a, j), j < N: the relative factors, the
// gauge prior on keyframe 0 and the damping on the diagonal block, the
// relative factor on the next block.
__device__ __forceinline__ float pose_term(const Params& c, int K, int a,
                                           int j, const float* rel,
                                           const float* wrel) {
  const int ka = a / 6, i = a % 6, kb = j / 6, jj = j % 6;
  float x = 0.0f;
  if (kb == ka) {
    if (ka < K - 1) {
      const float* Ji = rel + ka * kRel + 6;
      float d = 0.0f;
      for (int r = 0; r < 6; ++r) d += Ji[r * 6 + i] * Ji[r * 6 + jj];
      x += wrel[ka] * d;
    }
    if (ka > 0) {
      const float* Jj = rel + (ka - 1) * kRel + 42;
      float d = 0.0f;
      for (int r = 0; r < 6; ++r) d += Jj[r * 6 + i] * Jj[r * 6 + jj];
      x += wrel[ka - 1] * d;
    }
    if (i == jj) x += c.damping + (ka == 0 ? kGauge : 0.0f);
  } else if (kb == ka + 1) {
    const float* Ji = rel + ka * kRel + 6;
    const float* Jj = Ji + 36;
    float d = 0.0f;
    for (int r = 0; r < 6; ++r) d += Ji[r * 6 + i] * Jj[r * 6 + jj];
    x += wrel[ka] * d;
  }
  return x;
}

__device__ __forceinline__ void band_factors(const float* pos,
                                             const float* quat,
                                             const float* g_dp,
                                             const float* g_dq,
                                             const float* wrel, float* rel,
                                             float* relcost, int f0, int f1,
                                             int first, int stride) {
  for (int f = f0 + first; f < f1; f += stride) {
    float* out = rel + f * kRel;
    rel_factor(pos + 3 * f, quat + 4 * f, pos + 3 * (f + 1),
               quat + 4 * (f + 1), g_dp + 3 * f, g_dq + 4 * f, out);
    float rr = 0.0f;
    for (int i = 0; i < 6; ++i) rr += out[i] * out[i];
    relcost[f] = wrel[f] * rr;
  }
}

// The band's pose-only rhs term of row a: the relative factors' gradient.
__device__ __forceinline__ float rel_rhs_term(int K, int a, const float* rel,
                                              const float* wrel) {
  const int ka = a / 6, i = a % 6;
  float x = 0.0f;
  if (ka < K - 1) {
    const float* r = rel + ka * kRel;
    float g = 0.0f;
    for (int q = 0; q < 6; ++q) g += r[6 + q * 6 + i] * r[q];
    x += wrel[ka] * g;
  }
  if (ka > 0) {
    const float* r = rel + (ka - 1) * kRel;
    float g = 0.0f;
    for (int q = 0; q < 6; ++q) g += r[42 + q * 6 + i] * r[q];
    x += wrel[ka - 1] * g;
  }
  return x;
}

// Landmarks [l0, l0 + nl) of the slice: X -= A_p^-1 (g_l_p - Bs^T dx), by
// warps 0-6, four lanes a landmark: lane m < 3 takes component m of Bs^T dx
// (Y's row 3 (p - y0) + m against dx, in four interleaved sums), lane 0 the
// update.
__device__ __forceinline__ void back_substitute_landmarks(
    const float* Y, int y0, int n6p, int N, const float* dx, const float* lm,
    float* pts, int l0, int nl) {
  const int lane = threadIdx.x & 31;
  for (int t0 = (threadIdx.x >> 5) * 32; t0 < 4 * nl; t0 += kSideWarp * 32) {
    const int t = t0 + lane;
    const int p = l0 + t / 4, m = t % 4;
    float q = 0.0f;
    if (t < 4 * nl && m < 3) {
      const float* y = Y + (3 * (p - y0) + m) * n6p;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      int a = 0;
      for (; a + 4 <= N; a += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) s[u] = fmaf(y[a + u], dx[a + u], s[u]);
      }
      for (; a < N; ++a) s[a & 3] = fmaf(y[a], dx[a], s[a & 3]);
      q = (s[0] + s[1]) + (s[2] + s[3]);
    }
    const int base = lane & ~3;
    const float q0 = __shfl_sync(kFull, q, base);
    const float q1 = __shfl_sync(kFull, q, base + 1);
    const float q2 = __shfl_sync(kFull, q, base + 2);
    if (t < 4 * nl && m == 0) {
      const float* h = lm + 9 * p;
      const float g0 = h[6] - q0, g1 = h[7] - q1, g2 = h[8] - q2;
      float* X = pts + 3 * p;
      X[0] -= h[0] * g0 + h[1] * g1 + h[2] * g2;
      X[1] -= h[1] * g0 + h[3] * g1 + h[4] * g2;
      X[2] -= h[2] * g0 + h[4] * g1 + h[5] * g2;
    }
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
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
  extern __shared__ __align__(16) float sm[];
  PROF_INIT;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int K = c.K, P = c.P, N = 6 * K;
  const int npad = pad_n(K), ld = ld_of(K), n6p = n6p_of(K), q4 = ld / 4;
  const Layout L = layout(K, c.Pr, c.Lc, c.Yl);
  float* S = sm + L.S;
  float* rhs = sm + L.rhs;
  float* Y = sm + L.Y;
  float* X = sm + L.X;
  float* E = sm + L.E;
  float* As = sm + L.As;
  float* pos = sm + L.pos;
  float* quat = sm + L.quat;
  float* R = sm + L.R;
  float* rel = sm + L.rel;
  float* wrel = sm + L.wrel;
  float* relcost = sm + L.relcost;
  float* pts = sm + L.pts;
  float* pts0 = sm + L.pts0;
  float* prw = sm + L.prior;
  float* lm = sm + L.lm;
  float* red = sm + L.red;
  int* bad = reinterpret_cast<int*>(sm + L.misc + 1);

  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this rank's landmarks [p0, p0 + np), never empty, and keyframe band
  // [k0, k1), which may be
  const int p0 = rank * c.Pr;
  const int np = min(c.Pr, P - p0);
  const int k0 = min(K, rank * c.Kr), k1 = min(K, k0 + c.Kr);
  // the relative factors the band needs: [f0, f1)
  const int f0 = max(0, k0 - 1), f1 = min(K - 1, k1);
  const int n_chunks = (np + c.Lc - 1) / c.Lc;
  // Y holds the whole slice (no recomputation for the back-substitution)
  // or one chunk
  const bool keep_y = c.Yl == c.Pr;
  const float* g_uv = obs_uv + static_cast<size_t>(b) * K * P * 2;
  const float* g_z = obs_z + static_cast<size_t>(b) * K * P;
  const float* g_w = obs_w + static_cast<size_t>(b) * K * P;
  const float* g_dp = rel_dp + static_cast<size_t>(b) * (K - 1) * 3;
  const float* g_dq = rel_dq + static_cast<size_t>(b) * (K - 1) * 4;

  for (int i = tid; i < K * 3; i += kThreads)
    pos[i] = kf_pos[static_cast<size_t>(b) * K * 3 + i];
  for (int i = tid; i < K * 4; i += kThreads)
    quat[i] = kf_quat[static_cast<size_t>(b) * K * 4 + i];
  for (int i = tid; i < np * 3; i += kThreads)
    pts[i] = pts0[i] = points[(static_cast<size_t>(b) * P + p0) * 3 + i];
  for (int i = tid; i < np; i += kThreads)
    prw[i] = prior[static_cast<size_t>(b) * P + p0 + i];
  for (int i = tid; i < K - 1; i += kThreads)
    wrel[i] = w_rel[static_cast<size_t>(b) * (K - 1) + i];
  // the system: zero, the padding an identity (it stays one: every update
  // of it adds zeros); a float4 lies in one row
  for (int i = tid; i < npad * q4; i += kThreads) {
    const int row = i / q4, col = 4 * (i % q4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row >= N) {
      if (row == col) v.x = 1.0f;
      if (row == col + 1) v.y = 1.0f;
      if (row == col + 2) v.z = 1.0f;
      if (row == col + 3) v.w = 1.0f;
    }
    reinterpret_cast<float4*>(S)[i] = v;
  }
  for (int i = tid; i < npad; i += kThreads) rhs[i] = 0.0f;
  __syncthreads();

  float cost = 0.0f;  // thread 0 of rank 0's
  for (int it = 0; it < c.n_iter; ++it) {
    for (int k = tid; k < K; k += kThreads) quat_to_mat(quat + 4 * k, R + 9 * k);
    if (tid == 0) *bad = 0;
    __syncthreads();
    PROF_STAMP(0);

    float cost_acc = 0.0f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int l0 = ch * c.Lc;
      const int nl = min(c.Lc, np - l0);
      float* Yc = Y + (keep_y ? 3 * l0 * n6p : 0);   // the chunk's rows
      // --- observations: a thread a (landmark, keyframe) ---
      for (int item = tid; item < nl * K; item += kThreads) {
        const int pl = item / K, k = item % K;
        cost_acc += observation(c, R + 9 * k, pos + 3 * k, pts + 3 * (l0 + pl),
                                g_uv, g_z, g_w, k * P + p0 + l0 + pl,
                                Yc + 3 * pl * n6p + 6 * k, n6p,
                                E + item * kExtra);
      }
      __syncthreads();
      PROF_STAMP(1);

      // --- the landmarks' blocks: A_p (upper 6) and g_l_p summed over
      // the keyframes, a thread a (landmark, entry); then a thread a
      // landmark inverts A_p ---
      for (int item = tid; item < nl * 9; item += kThreads) {
        const int pl = item / 9, e = item % 9;
        float s = 0.0f;
        if (e < 6) {  // A[m][n] = Bs[3 + m][n], m <= n
          const int m = (e >= 3) + (e >= 5);
          const int n = m + e - (m == 0 ? 0 : (m == 1 ? 3 : 5));
          const float* y = Yc + (3 * pl + n) * n6p + 3 + m;
          for (int k = 0; k < K; ++k) s += y[6 * k];
        } else {      // g_l = -sum v[3:6]
          const float* ev = E + pl * K * kExtra + 3 + e;
          for (int k = 0; k < K; ++k) s -= ev[k * kExtra];
        }
        As[item] = s;
      }
      __syncthreads();
      if (tid < nl) {
        const int pl = tid;
        const float* A = As + 9 * pl;
        const float* gl = A + 6;
        const int q = l0 + pl;
        const float pw = prw[q];
        const float a = A[0] + pw + c.damping, bb = A[1], cc = A[2];
        const float e = A[3] + pw + c.damping, f = A[4];
        const float i = A[5] + pw + c.damping;
        const float A11 = e * i - f * f;
        const float A12 = cc * f - bb * i;
        const float A13 = bb * f - cc * e;
        const float A22 = a * i - cc * cc;
        const float A23 = cc * bb - a * f;
        const float A33 = a * e - bb * bb;
        const float det = a * A11 + bb * A12 + cc * A13;
        const float idet = 1.0f / (fabsf(det) > 1e-12f ? det : 1e-12f);
        float* h = lm + 9 * q;
        h[0] = A11 * idet; h[1] = A12 * idet; h[2] = A13 * idet;
        h[3] = A22 * idet; h[4] = A23 * idet; h[5] = A33 * idet;
#pragma unroll
        for (int j = 0; j < 3; ++j)
          h[6 + j] = gl[j] + pw * (pts[3 * q + j] - pts0[3 * q + j]);
      }
      __syncthreads();
      // X = (Bs A_p^-1)^T, a thread an observation
      for (int item = tid; item < nl * K; item += kThreads) {
        const int pl = item / K, k = item % K;
        const float* h = lm + 9 * (l0 + pl);
        const float Hi[3][3] = {{h[0], h[1], h[2]}, {h[1], h[3], h[4]},
                                {h[2], h[4], h[5]}};
        const float* y = Yc + 3 * pl * n6p + 6 * k;
        float* x = X + 3 * pl * n6p + 6 * k;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float b0 = y[i], b1 = y[n6p + i], b2 = y[2 * n6p + i];
#pragma unroll
          for (int n = 0; n < 3; ++n)
            x[n * n6p + i] = b0 * Hi[0][n] + b1 * Hi[1][n] + b2 * Hi[2][n];
        }
      }
      __syncthreads();
      PROF_STAMP(2);

      // --- the partial Schur product, upper blocks only ---
      const bool first = ch == 0;
      if (tid < kGemmThreads) {
        // block (ka, kb), ka < kb: -sum over the chunk's (landmark, m) of
        // X[., 6ka..] Y[., 6kb..]^T, six by six in registers
        for (int t = tid; t < K * (K - 1) / 2; t += kGemmThreads) {
          int ka = 0, rem = t;
          while (rem >= K - 1 - ka) {
            rem -= K - 1 - ka;
            ++ka;
          }
          const int kb = ka + 1 + rem;
          float acc[6][6];
#pragma unroll
          for (int i = 0; i < 6; ++i)
#pragma unroll
            for (int j = 0; j < 6; ++j) acc[i][j] = 0.0f;
          const float* xa = X + 6 * ka;
          const float* yb = Yc + 6 * kb;
#pragma unroll 2
          for (int q = 0; q < 3 * nl; ++q) {
            const float2 x0 = *reinterpret_cast<const float2*>(xa + q * n6p);
            const float2 x1 = *reinterpret_cast<const float2*>(xa + q * n6p + 2);
            const float2 x2 = *reinterpret_cast<const float2*>(xa + q * n6p + 4);
            const float2 y0 = *reinterpret_cast<const float2*>(yb + q * n6p);
            const float2 y1 = *reinterpret_cast<const float2*>(yb + q * n6p + 2);
            const float2 y2 = *reinterpret_cast<const float2*>(yb + q * n6p + 4);
            const float xv[6] = {x0.x, x0.y, x1.x, x1.y, x2.x, x2.y};
            const float yv[6] = {y0.x, y0.y, y1.x, y1.y, y2.x, y2.y};
#pragma unroll
            for (int i = 0; i < 6; ++i)
#pragma unroll
              for (int j = 0; j < 6; ++j)
                acc[i][j] = fmaf(-xv[i], yv[j], acc[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            float* row = S + (6 * ka + i) * ld + 6 * kb;
#pragma unroll
            for (int j = 0; j < 6; ++j)
              row[j] = first ? acc[i][j] : row[j] + acc[i][j];
          }
        }
      } else if (tid < kGemmThreads + kDiagThreads) {
        // row ii of diagonal block k: H_kk's row and the Schur term, and
        // the rhs entry -(v + X^T g_l)
        for (int r = tid - kGemmThreads; r < N; r += kDiagThreads) {
          const int k = r / 6, ii = r % 6;
          float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          float racc = 0.0f;
          for (int pl = 0; pl < nl; ++pl) {
            const float* y = Yc + 3 * pl * n6p + 6 * k;
            const float* x = X + 3 * pl * n6p + 6 * k;
            const float* e = E + (pl * K + k) * kExtra;
            const float* gl = lm + 9 * (l0 + pl) + 6;
            // M[ii][j]: j >= 3 is Bs[ii][j - 3]; j < 3 is M[0:3, 0:3] for
            // ii < 3 and Bs[j][ii - 3] otherwise
            const int im = max(ii - 3, 0);
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const float top = e[ii < 3 ? (ii <= j ? tri3(ii, j) : tri3(j, ii))
                                         : 0];
              acc[j] += ii < 3 ? top : y[im * n6p + j];
              acc[3 + j] += y[j * n6p + ii];
            }
            float xg = e[6 + ii];
#pragma unroll
            for (int m = 0; m < 3; ++m) {
              const float xm = x[m * n6p + ii];
              xg = fmaf(xm, gl[m], xg);
#pragma unroll
              for (int j = 0; j < 6; ++j)
                acc[j] = fmaf(-xm, y[m * n6p + j], acc[j]);
            }
            racc -= xg;
          }
          float* row = S + r * ld + 6 * k;
#pragma unroll
          for (int j = 0; j < 6; ++j)
            row[j] = first ? acc[j] : row[j] + acc[j];
          float* pr = S + r * ld + npad;   // the partial rhs
          *pr = first ? racc : *pr + racc;
        }
      } else if (first) {
        band_factors(pos, quat, g_dp, g_dq, wrel, rel, relcost, f0, f1, lane,
                     32);
      }
      PROF_STAMP(12);
      __syncthreads();
      PROF_STAMP(4);
    }
    // the rank's partial cost: threads, warps in order, then the factors
    // that its band owns ([k0, k1) of K - 1)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cost_acc += __shfl_down_sync(kFull, cost_acc, off);
    if (lane == 0) red[warp] = cost_acc;
    __syncthreads();
    if (tid == 0) {
      float x = 0.0f;
      for (int w = 0; w < kWarps; ++w) x += red[w];
      for (int f = k0; f < min(k1, K - 1); ++f) x += relcost[f];
      S[npad + 1] = x;   // row 0's pad: rank 0 sums them with its band
    }
    PROF_STAMP(13);
    cluster_arrive();
    cluster_wait();
    PROF_STAMP(7);

    // --- the band's rows of the sum, rank by rank, as float4 from the
    // first one that holds an upper-block entry (the first pad float4
    // carries the partial rhs, and row 0's the partial costs), plus the
    // band's pose-only terms, pushed into every rank's system: a warp a
    // half row, a lane a float4.  Only this rank reads its band's rows, and each
    // thread reads an entry everywhere before it writes it, so the pushes
    // race with no read ---
    const int halves = npad / 4 + 1 > 32 ? 2 : 1;   // 32 float4s a half
    for (int e = warp; e < 6 * (k1 - k0) * halves; e += kWarps) {
      const int a = 6 * k0 + e / halves, ka = a / 6;
      const int col = ((6 * ka) & ~3) + 4 * (lane + 32 * (e % halves));
      if (col > npad) continue;
      float* dst = S + a * ld + col;
      float4 v[kMaxCluster];
#pragma unroll
      for (int s = 0; s < kMaxCluster; ++s)
        if (s < C)
          v[s] = *reinterpret_cast<const float4*>(
              s == rank ? dst : cluster.map_shared_rank(dst, s));
      float4 x = v[0];
#pragma unroll
      for (int s = 1; s < kMaxCluster; ++s)
        if (s < C) x = add4(x, v[s]);
      if (col == npad) {
        x.x -= rel_rhs_term(K, a, rel, wrel);
      } else if (col < min(6 * ka + 12, N)) {
        if (col < N) x.x += pose_term(c, K, a, col, rel, wrel);
        if (col + 1 < N) x.y += pose_term(c, K, a, col + 1, rel, wrel);
        if (col + 2 < N) x.z += pose_term(c, K, a, col + 2, rel, wrel);
        if (col + 3 < N) x.w += pose_term(c, K, a, col + 3, rel, wrel);
      }
#pragma unroll
      for (int s = 0; s < kMaxCluster; ++s)
        if (s < C)
          *reinterpret_cast<float4*>(
              s == rank ? dst : cluster.map_shared_rank(dst, s)) = x;
    }
    PROF_STAMP(3);
    // every band is in every rank once all have arrived; no rank touches
    // another's memory again before the next iteration's first barrier
    cluster_arrive();
    cluster_wait();
    for (int a = tid; a < N; a += kThreads) rhs[a] = S[a * ld + npad];
    if (tid == 0) cost = S[npad + 1];   // rank 0's is the one written out
    __syncthreads();
    PROF_STAMP(7);

    // --- the reduced solve, the same in every rank ---
    reduced_solve(S, ld, npad, rhs, sm + L.dinv, sm + L.vb, bad PROF_ARG);
    PROF_STAMP(5);

    // --- back-substitute this rank's landmarks at the old linearization
    // point (warps 0-6, four lanes a landmark) and move the poses (every
    // rank the same): beside them when Y holds the slice, after them when
    // each chunk's Y is formed again ---
    if (keep_y) {
      if (warp < kSideWarp)
        back_substitute_landmarks(Y, 0, n6p, N, rhs, lm, pts, 0, np);
      else
        for (int k = lane; k < K; k += 32) update_pose(rhs, pos, quat, k);
      __syncthreads();
    } else {
      for (int ch = 0; ch < n_chunks; ++ch) {
        const int l0 = ch * c.Lc;
        const int nl = min(c.Lc, np - l0);
        for (int item = tid; item < nl * K; item += kThreads) {
          const int pl = item / K, k = item % K;
          observation(c, R + 9 * k, pos + 3 * k, pts + 3 * (l0 + pl), g_uv,
                      g_z, g_w, k * P + p0 + l0 + pl,
                      Y + 3 * pl * n6p + 6 * k, n6p, E + item * kExtra);
        }
        __syncthreads();
        if (warp < kSideWarp)
          back_substitute_landmarks(Y, l0, n6p, N, rhs, lm, pts, l0, nl);
        __syncthreads();
      }
      for (int k = tid; k < K; k += kThreads) update_pose(rhs, pos, quat, k);
      __syncthreads();
    }
    PROF_STAMP(6);
  }

  for (int i = tid; i < np * 3; i += kThreads)
    out_pts[(static_cast<size_t>(b) * P + p0) * 3 + i] = pts[i];
  if (rank == 0) {
    for (int i = tid; i < K * 3; i += kThreads)
      out_pos[static_cast<size_t>(b) * K * 3 + i] = pos[i];
    for (int i = tid; i < K * 4; i += kThreads)
      out_quat[static_cast<size_t>(b) * K * 4 + i] = quat[i];
    if (tid == 0) out_cost[b] = cost;
  }
  PROF_STAMP(0);
  PROF_FLUSH;
}

__global__ void empty_kernel() {}

template <typename F>
cudaError_t configure(F fn, int B, int C, int smem, cudaStream_t stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
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
  cfg->gridDim = dim3(B * C);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Dynamic shared memory, in bytes, of one rank of a plan: K keyframes, Pr
// landmarks a rank, Lc a chunk, Yl landmarks whose Bs^T the rank holds.  The wrapper's plan
// (ops/ba.py:smem_bytes) computes the same sum and refuses a plan beyond the
// card's 232448 bytes a block.
extern "C" int ba_smem_bytes(int K, int Pr, int Lc, int Yl) {
  return layout(K, Pr, Lc, Yl).total * static_cast<int>(sizeof(float));
}

// Plain C entry point, loaded with ctypes.  All buffers are contiguous
// float32 on the device: kf_pos (B, K, 3), kf_quat (B, K, 4), points
// (B, P, 3), obs_uv (B, K, P, 2), obs_z and obs_w (B, K, P), rel_dp
// (B, K-1, 3), rel_dq (B, K-1, 4), w_rel (B, K-1), prior (B, P; zeros for free
// points); outputs out_pos, out_quat, out_pts shaped like the first three and
// out_cost (B,).  The plan (ops/ba.py:plan): C blocks a window (1..8), Pr
// landmarks a rank, Lc a chunk, Yl landmarks whose Bs^T a rank holds (Pr
// or Lc), Kr keyframes a band, `threads` (256) and `smem` bytes
// (ba_smem_bytes).  Returns the CUDA error code of the launch
// (0 = launched; cudaErrorInvalidValue for an inconsistent plan, one with
// a rank that holds no landmark among them).
extern "C" int ba_solve(const void* kf_pos, const void* kf_quat,
                        const void* points, const void* obs_uv,
                        const void* obs_z, const void* obs_w,
                        const void* rel_dp, const void* rel_dq,
                        const void* w_rel, const void* prior, int B, int K,
                        int P, int n_iter, float fx, float fy, float cx,
                        float cy, float t_fwd, float t_up, float depth_noise,
                        float huber_px, float damping, int C, int Pr, int Lc,
                        int Yl, int Kr, int threads, int smem, void* out_pos,
                        void* out_quat, void* out_pts, void* out_cost,
                        void* stream) {
  if (B < 1 || K < 2 || P < 1 || n_iter < 1 || C < 1 || C > kMaxCluster ||
      Pr < 1 || C * Pr < P || (C - 1) * Pr >= P || Lc < 1 || Lc > 32 ||
      Lc > Pr || Kr < 1 ||
      (Yl != Pr && Yl != Lc) || C * Kr < K || threads != kThreads ||
      smem != ba_smem_bytes(K, Pr, Lc, Yl))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(ba_kernel, B, C, smem,
                              static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params c{fx, fy, cx, cy, t_fwd, t_up, depth_noise, huber_px, damping,
           K, P, n_iter, Pr, Lc, Yl, Kr};
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
  err = cudaLaunchKernelEx(&cfg, ba_kernel, c, f(kf_pos), f(kf_quat),
                           f(points), f(obs_uv), f(obs_z), f(obs_w),
                           f(rel_dp), f(rel_dq), f(w_rel), f(prior),
                           g(out_pos), g(out_quat), g(out_pts), g(out_cost));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of C blocks with `smem` bytes each the card holds at
// once (the windows of one launch run in one wave when B <= the count).
// Returns the CUDA error code; the count goes to *n.
extern "C" int ba_max_active_clusters(int C, int smem, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(ba_kernel, 1, C, smem, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(n, ba_kernel, &cfg));
}

// The launch floor: an empty kernel with the grid, cluster, block and shared
// memory of a launch on B windows.
extern "C" int ba_empty_launch(int B, int C, int smem, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(empty_kernel, B, C, smem,
                              static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef BA_PROFILE
extern "C" int ba_prof(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long z[16] = {0};
    return static_cast<int>(cudaMemcpyToSymbol(g_prof, z, sizeof(z)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_prof, 16 * sizeof(unsigned long long)));
}
#endif
