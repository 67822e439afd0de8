// Shared device helpers for the hand-written Hopper kernels of the
// humanoid step (smooth.cu, solver.cu) and of the explicit-row solve
// (euler.cu).
//
// Layout: B1 (smooth.cu) and B3 (euler.cu) read batch-first inputs at
// their strides; B1 writes its outputs batch-last ([..., B], element i
// of env e at p[i * B + e]) and B2 (solver.cu) reads them so.
//
// All three kernels run one warp per environment: the env's working set
// sits in shared memory and the warp helpers at the end of this file
// spread a factorization, a triangular solve or a sum over the 32 lanes,
// always in a fixed order, so that two launches on the same inputs agree
// to the bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hm {

// max that keeps a NaN in its first argument (jnp.maximum semantics for
// the clamp pattern max(x, eps)): a diverged state must stay NaN so the
// step's divergence guard sees it.
__device__ __forceinline__ float mx(float a, float b) {
  return (a != a) ? a : fmaxf(a, b);
}

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

struct V3 {
  float x, y, z;
};
struct Q4 {
  float w, x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

// v + w t + qv × t with t = 2 qv × v (math.quat_rotate)
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  V3 qv{q.x, q.y, q.z};
  V3 t = cross(qv, v) * 2.0f;
  return v + t * q.w + cross(qv, t);
}

__device__ __forceinline__ Q4 qnormalize(Q4 q) {
  float n = sqrtf(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  float inv = 1.0f / mx(n, 1e-9f);
  return {q.w * inv, q.x * inv, q.y * inv, q.z * inv};
}

// columns of the rotation matrix of q (math.quat_to_mat)
__device__ __forceinline__ void qcols(Q4 q, V3& c0, V3& c1, V3& c2) {
  float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  c0 = {1 - 2 * (yy + zz), 2 * (xy + wz), 2 * (xz - wy)};
  c1 = {2 * (xy - wz), 1 - 2 * (xx + zz), 2 * (yz + wx)};
  c2 = {2 * (xz + wy), 2 * (yz - wx), 1 - 2 * (xx + yy)};
}

template <class View>
__device__ __forceinline__ V3 ld3(const View& v, int i) {
  return {v[i], v[i + 1], v[i + 2]};
}
template <class View>
__device__ __forceinline__ Q4 ld4(const View& v, int i) {
  return {v[i], v[i + 1], v[i + 2], v[i + 3]};
}

// MuJoCo solimp sigmoid (solver.impedance)
__device__ __forceinline__ float impedance(float viol, float dmin, float dmax,
                                           float width) {
  float x = clipf(viol / mx(width, 1e-9f), 0.0f, 1.0f);
  float y = x < 0.5f ? 2.0f * x * x : 1.0f - 2.0f * (1.0f - x) * (1.0f - x);
  return dmin + y * (dmax - dmin);
}

// (k, b) from solref / solimp with timeconst >= 2 dt (solver._kb)
__device__ __forceinline__ void solref_kb(float tc, float dr, float dmax,
                                          float d, float dt, float& k,
                                          float& b) {
  tc = fmaxf(tc, 2.0f * dt);
  b = 2.0f / fmaxf(dmax * tc, 1e-9f);
  k = d / fmaxf(dmax * dmax * tc * tc * dr * dr, 1e-12f);
}

// Cholesky clamp of the TPU kernels (pallas_solver._EPS)
constexpr float EPS_CHOL = 1e-12f;

// ---- one warp per environment ----

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Asynchronous 4-byte copy from global to shared memory (cp.async,
// sm_80 and later): a thread keeps many in flight without staging them
// in registers; cp_async_wait() waits for the calling thread's copies
// (a __syncwarp must follow before other lanes read them).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// term(u0) + ... + term(u1 - 1) in four partial sums, so that the loads
// of four terms are in flight at once; a fixed order
template <class F>
__device__ __forceinline__ float sum4(int u0, int u1, F term) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  int u = u0;
  for (; u + 4 <= u1; u += 4) {
    s0 += term(u);
    s1 += term(u + 1);
    s2 += term(u + 2);
    s3 += term(u + 3);
  }
  for (; u < u1; ++u) s0 += term(u);
  return (s0 + s1) + (s2 + s3);
}

// Sum of v over the 32 lanes by an xor butterfly: a fixed order, and
// every lane gets the same bits (a + b == b + a in IEEE arithmetic).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// In-place lower Cholesky of the n x n matrix A in shared memory (row
// stride ld, lower triangle read and written), n <= 32, by the whole
// warp, two columns at a time: lane i takes the dot products of row i
// with rows j and j + 1 over the finished columns k < j, finishes column
// j, subtracts l_ij l_(j+1)j from column j + 1 and finishes it, so that
// one round of shared-memory loads and one __syncwarp serve two columns.
// Pivots are clamped at EPS_CHOL (`mx` keeps a NaN, so a diverged env
// stays NaN). Also writes inv[j] = 1 / L_jj for the solves.
__device__ inline void warp_chol(float* A, int n, int ld, float* inv) {
  const int i = lane_id();
  const float* ai = A + min(i, n - 1) * ld;  // lanes >= n discard theirs
  for (int j = 0; j < n; j += 2) {
    const int j1 = j + 1 < n ? j + 1 : j;
    const float* aj = A + j * ld;
    const float* aj1 = A + j1 * ld;
    float t0 = 0.0f, t1 = 0.0f, u0 = 0.0f, u1 = 0.0f;
    int k = 0;
    for (; k + 2 <= j; k += 2) {
      const float a0 = ai[k], a1 = ai[k + 1];
      t0 -= a0 * aj[k];
      u0 -= a0 * aj1[k];
      t1 -= a1 * aj[k + 1];
      u1 -= a1 * aj1[k + 1];
    }
    if (k < j) {
      t0 -= ai[k] * aj[k];
      u0 -= ai[k] * aj1[k];
    }
    const float t = ai[j] + (t0 + t1);
    const float s = mx(__shfl_sync(FULL_MASK, t, j), EPS_CHOL);
    const float r = rsqrtf(s);
    const float lj = i == j ? s * r : t * r;
    const float u = ai[j1] + (u0 + u1) - lj * __shfl_sync(FULL_MASK, lj, j1);
    const float s1 = mx(__shfl_sync(FULL_MASK, u, j1), EPS_CHOL);
    const float r1 = rsqrtf(s1);
    if (i >= j && i < n) A[i * ld + j] = lj;
    if (i == j) inv[j] = r;
    if (j1 > j && i >= j1 && i < n) A[i * ld + j1] = i == j1 ? s1 * r1 : u * r1;
    if (j1 > j && i == j1) inv[j1] = r1;
    __syncwarp();
  }
}

// (L Lᵀ)⁻¹ b for the warp's factor L and inverse diagonal `inv` from
// `warp_chol`: lane i holds b_i on entry and x_i on return (lanes >= n
// hold 0). Forward and backward substitution one unknown at a time,
// broadcast by a shuffle; branch-free, so that the warp never splits.
__device__ inline float warp_chol_solve(const float* L, const float* inv,
                                        int n, int ld, float b) {
  const int i = lane_id();
  const int row = min(i, n - 1);
  if (i >= n) b = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float yk = __shfl_sync(FULL_MASK, b, k) * inv[k];
    const float lik = L[row * ld + k];
    b = i == k ? yk : (i > k && i < n ? b - lik * yk : b);
  }
  for (int k = n - 1; k >= 0; --k) {
    const float xk = __shfl_sync(FULL_MASK, b, k) * inv[k];
    const float lki = L[k * ld + min(i, k)];
    b = i == k ? xk : (i < k ? b - lki * xk : b);
  }
  return b;
}

// Li = L⁻¹ (lower triangle, row stride ld; the upper triangle is left
// as it is) for the warp's factor from `warp_chol`: lane i substitutes
// column i. With it, y = L⁻¹ b for a sparse b is a sum of independent
// products instead of a dependent chain.
__device__ inline void warp_tri_inv(const float* L, const float* inv, int n,
                                    int ld, float* Li) {
  const int i = lane_id();
  if (i < n) {
    for (int k = i; k < n; ++k) {
      float s0 = k == i ? 1.0f : 0.0f, s1 = 0.0f;
      int m = i;
      for (; m + 2 <= k; m += 2) {
        s0 -= L[k * ld + m] * Li[m * ld + i];
        s1 -= L[k * ld + m + 1] * Li[(m + 1) * ld + i];
      }
      if (m < k) s0 -= L[k * ld + m] * Li[m * ld + i];
      Li[k * ld + i] = (s0 + s1) * inv[k];
    }
  }
  __syncwarp();
}

// The same three helpers for n up to 32 R (kernels B2 and B3 take them
// at R = 2 for 32 < nv <= 64): a lane owns the matrix rows lane + 32 q, q < R.
// Row j's value sits in slot j >> 5 of lane j & 31; `pick` reads that
// slot (j is the same on every lane) and `src` names that lane.
template <int R>
__device__ __forceinline__ float pick(const float (&v)[R], int j) {
  float s = v[0];
#pragma unroll
  for (int q = 1; q < R; ++q)
    if ((j >> 5) == q) s = v[q];
  return s;
}
template <int R>
__device__ __forceinline__ int src(int j) {
  return R == 1 ? j : (j & 31);
}

// warp_chol for n <= 32 R
template <int R>
__device__ inline void warp_chol_rows(float* A, int n, int ld, float* inv) {
  const int lane = lane_id();
  const float* ai[R];
#pragma unroll
  for (int q = 0; q < R; ++q)  // rows >= n discard theirs
    ai[q] = A + min(lane + 32 * q, n - 1) * ld;
  for (int j = 0; j < n; j += 2) {
    const int j1 = j + 1 < n ? j + 1 : j;
    const float* aj = A + j * ld;
    const float* aj1 = A + j1 * ld;
    float t[R], u[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      t[q] = u[q] = 0.0f;
      if (R > 1 && 32 * q + 31 < j) continue;  // this slot's rows are done
      float t0 = 0.0f, t1 = 0.0f, u0 = 0.0f, u1 = 0.0f;
      int k = 0;
      for (; k + 2 <= j; k += 2) {
        const float a0 = ai[q][k], a1 = ai[q][k + 1];
        t0 -= a0 * aj[k];
        u0 -= a0 * aj1[k];
        t1 -= a1 * aj[k + 1];
        u1 -= a1 * aj1[k + 1];
      }
      if (k < j) {
        t0 -= ai[q][k] * aj[k];
        u0 -= ai[q][k] * aj1[k];
      }
      t[q] = ai[q][j] + (t0 + t1);
      u[q] = u0 + u1;
    }
    const float s = mx(__shfl_sync(FULL_MASK, pick(t, j), src<R>(j)),
                       EPS_CHOL);
    const float r = rsqrtf(s);
    float lj[R];
#pragma unroll
    for (int q = 0; q < R; ++q)
      lj[q] = lane + 32 * q == j ? s * r : t[q] * r;
    const float lj1 = __shfl_sync(FULL_MASK, pick(lj, j1), src<R>(j1));
#pragma unroll
    for (int q = 0; q < R; ++q) u[q] = ai[q][j1] + u[q] - lj[q] * lj1;
    const float s1 = mx(__shfl_sync(FULL_MASK, pick(u, j1), src<R>(j1)),
                        EPS_CHOL);
    const float r1 = rsqrtf(s1);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + 32 * q;
      if (i >= j && i < n) A[i * ld + j] = lj[q];
      if (i == j) inv[j] = r;
      if (j1 > j && i >= j1 && i < n)
        A[i * ld + j1] = i == j1 ? s1 * r1 : u[q] * r1;
      if (j1 > j && i == j1) inv[j1] = r1;
    }
    __syncwarp();
  }
}

// warp_chol_solve for n <= 32 R: the lane of row i holds b_i on entry
// and x_i on return (rows >= n hold 0)
template <int R>
__device__ inline void warp_chol_solve_rows(const float* L, const float* inv,
                                            int n, int ld, float (&b)[R]) {
  const int lane = lane_id();
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (lane + 32 * q >= n) b[q] = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float yk = __shfl_sync(FULL_MASK, pick(b, k), src<R>(k)) * inv[k];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + 32 * q;
      const float lik = L[min(i, n - 1) * ld + k];
      b[q] = i == k ? yk : (i > k && i < n ? b[q] - lik * yk : b[q]);
    }
  }
  for (int k = n - 1; k >= 0; --k) {
    const float xk = __shfl_sync(FULL_MASK, pick(b, k), src<R>(k)) * inv[k];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + 32 * q;
      const float lki = L[k * ld + min(i, k)];
      b[q] = i == k ? xk : (i < k ? b[q] - lki * xk : b[q]);
    }
  }
}

// warp_tri_inv for n <= 32 R: the lane of column i substitutes it
template <int R>
__device__ inline void warp_tri_inv_rows(const float* L, const float* inv, int n,
                                    int ld, float* Li) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane_id() + 32 * q;
    if (i < n) {
      for (int k = i; k < n; ++k) {
        float s0 = k == i ? 1.0f : 0.0f, s1 = 0.0f;
        int m = i;
        for (; m + 2 <= k; m += 2) {
          s0 -= L[k * ld + m] * Li[m * ld + i];
          s1 -= L[k * ld + m + 1] * Li[(m + 1) * ld + i];
        }
        if (m < k) s0 -= L[k * ld + m] * Li[m * ld + i];
        Li[k * ld + i] = (s0 + s1) * inv[k];
      }
    }
  }
  __syncwarp();
}

// The warp's Cholesky, solve and L⁻¹ at R matrix rows per lane (B2 and
// B3 are templates on R): the n <= 32 helpers at R = 1, their
// two-rows-a-lane forms at R = 2.
template <int R>
__device__ __forceinline__ void chol(float* A, int n, int ld, float* inv) {
  if constexpr (R == 1)
    warp_chol(A, n, ld, inv);
  else
    warp_chol_rows<R>(A, n, ld, inv);
}
template <int R>
__device__ __forceinline__ void chol_solve(const float* L, const float* inv,
                                           int n, int ld, float (&b)[R]) {
  if constexpr (R == 1)
    b[0] = warp_chol_solve(L, inv, n, ld, b[0]);
  else
    warp_chol_solve_rows<R>(L, inv, n, ld, b);
}
template <int R>
__device__ __forceinline__ void tri_inv(const float* L, const float* inv,
                                        int n, int ld, float* Li) {
  if constexpr (R == 1)
    warp_tri_inv(L, inv, n, ld, Li);
  else
    warp_tri_inv_rows<R>(L, inv, n, ld, Li);
}

}  // namespace hm
