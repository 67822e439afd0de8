// Kernel B3: Newton constraint solve on explicit rows + implicit-damping
// Euler, one thread per env.
//
// Replaces the TPU kernel humanoid_mujoco_tpu/physics/pallas_solver.py
// `_kernel` + `_solve_core` (launched by `fused_batched`). Per
// environment, from the rows J (ne x nv) with per-row pos, k, b, d: the
// Cholesky of M; the unconstrained acceleration; diag(J M⁻¹ Jᵀ), R, D
// and aref = -b J qvel - k d pos; `niter` iterations of active set,
// gradient, H = M + Jᵀ Da J (lower half), Cholesky, search direction and
// the line search on the grid {0} ∪ logspace(-3, log10 4, 15) with
// sign-crossing interpolation; the forces f and qfrc_constraint = Jᵀ f;
// and the Euler update (M + diag(hd)) dv = dt (qfrc_smooth + qfrc_c).
// Constants as in the TPU kernel: Cholesky clamp 1e-12, diagA >= 1e-10,
// d floored at 1e-4 and R at 1e-6, 1e-12 in the crossing fraction.
//
// What bounds it on the H100: on the Swimmer's rows (nv 8, ne 10) it
// moves ~1 KB per env and needs a few thousand FLOPs per env, so at
// B = 1024 its bound is well under a microsecond; the time is latency:
// one thread per env puts 8 blocks on 132 SMs, and each thread runs a
// long dependent chain (three Cholesky factorizations and substitutions
// per iteration, sums over the rows). On the humanoid's 694 selection-
// free rows (J 51 MB at B = 1024) it reads J about twice per iteration.
//
// What the design does about it: the simple design, sized generically
// in nv and ne. J and the per-row data are read batch-last, so the
// threads of a warp read neighbouring floats. diag(J M⁻¹ Jᵀ)_i is
// |L⁻¹ J_iᵀ|² by one forward substitution per row (the same quantity as
// the TPU kernel's explicit M⁻¹ columns, with half the work). Inactive
// rows skip the gradient and Hessian updates, zero entries of J skip
// their Hessian row, and rows that are inactive everywhere on the grid
// skip the line search (r + t J p is linear in t). All per-env scratch
// is wrapper-allocated and batch-last; the kernel allocates nothing.

#include "common.cuh"

using namespace hm;

namespace {

constexpr int LS_MAX = 16;  // capacity of the line-search grid

struct EulerArgs {
  const float *M, *qf, *qv, *J, *pos, *k, *b, *d, *hd, *dt, *grid;
  float *qacc, *qvn, *f, *qfc, *scratch;
  int B, nv, ne, niter, nls;
};

__global__ void __launch_bounds__(128) euler_kernel(EulerArgs a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int B = a.B;
  if (e >= B) return;
  const int nv = a.nv, ne = a.ne, nls = a.nls;

  const In M{a.M + e, B}, qf{a.qf + e, B}, qv{a.qv + e, B}, J{a.J + e, B},
      pos{a.pos + e, B}, kk{a.k + e, B}, bb{a.b + e, B}, dd{a.d + e, B};
  const Out qacc{a.qacc + e, B}, qvn{a.qvn + e, B}, f{a.f + e, B},
      qfc{a.qfc + e, B};

  Carver cv{a.scratch + e, B, 0};
  const Out L = cv.take(nv * nv), H = cv.take(nv * nv);
  const Out as = cv.take(nv), x = cv.take(nv), p = cv.take(nv),
            g = cv.take(nv), Mx = cv.take(nv), y = cv.take(nv);
  const Out D = cv.take(ne), ar = cv.take(ne), r = cv.take(ne);

  float grid[LS_MAX];
#pragma unroll
  for (int t = 0; t < LS_MAX; ++t) grid[t] = t < nls ? __ldg(a.grid + t) : 0.f;
  // r + t jp is linear in t: a row is active somewhere on the grid iff it
  // is at t = 0 or at the last grid point
  const float tmax = __ldg(a.grid + nls - 1);

  // ---- Cholesky of M, unconstrained acceleration ----
  for (int i = 0; i < nv * nv; ++i) L[i] = M[i];
  chol(L, nv);
  for (int v = 0; v < nv; ++v) as[v] = qf[v];
  chol_solve(L, nv, as);

  // ---- per row: diag(J M⁻¹ Jᵀ) = |L⁻¹ Jᵢᵀ|², D, aref ----
  for (int i = 0; i < ne; ++i) {
    const int o = i * nv;
    float jv = 0.0f, diag = 0.0f;
    for (int u = 0; u < nv; ++u) {
      const float ju = J[o + u];
      jv += ju * qv[u];
      float s = ju;
      for (int w = 0; w < u; ++w) s -= L[u * nv + w] * y[w];
      s /= L[u * nv + u];
      y[u] = s;
      diag += s * s;
    }
    const float di = dd[i];
    const float Rf = fmaxf((1.0f - di) / fmaxf(di, 1e-4f), 1e-6f);
    D[i] = 1.0f / (Rf * mx(diag, 1e-10f));
    ar[i] = -bb[i] * jv - kk[i] * di * pos[i];
  }

  // ---- Newton iterations ----
  for (int v = 0; v < nv; ++v) x[v] = as[v];
  for (int it = 0; it < a.niter; ++it) {
    for (int u = 0; u < nv; ++u) {
      float s = 0.0f;
      for (int v = 0; v < nv; ++v) s += M[u * nv + v] * (x[v] - as[v]);
      Mx[u] = s;
      g[u] = s;
      for (int w = 0; w <= u; ++w) H[u * nv + w] = M[u * nv + w];
    }
    for (int i = 0; i < ne; ++i) {
      const int o = i * nv;
      float jx = 0.0f;
      for (int u = 0; u < nv; ++u) jx += J[o + u] * x[u];
      const float ri = jx - ar[i];
      r[i] = ri;
      if (!(ri < 0.0f)) continue;
      // g += Jᵢᵀ Dᵢ rᵢ;  H += Dᵢ Jᵢᵀ Jᵢ (lower triangle)
      const float Di = D[i], Dr = Di * ri;
      for (int u = 0; u < nv; ++u) {
        const float ju = J[o + u];
        if (ju == 0.0f) continue;
        g[u] += ju * Dr;
        const float Dju = Di * ju;
        for (int w = 0; w <= u; ++w) H[u * nv + w] += Dju * J[o + w];
      }
    }
    chol(H, nv);
    for (int v = 0; v < nv; ++v) p[v] = g[v];
    chol_solve(H, nv, p);
    for (int v = 0; v < nv; ++v) p[v] = -p[v];

    // ---- line search on the fixed grid ----
    float pMp = 0.0f, b0 = 0.0f;
    for (int u = 0; u < nv; ++u) {
      float s = 0.0f;
      for (int v = 0; v < nv; ++v) s += M[u * nv + v] * p[v];
      pMp += p[u] * s;
      b0 += p[u] * Mx[u];
    }
    float dphi[LS_MAX];
#pragma unroll
    for (int t = 0; t < LS_MAX; ++t) dphi[t] = b0 + grid[t] * pMp;
    for (int i = 0; i < ne; ++i) {
      const int o = i * nv;
      float jp = 0.0f;
      for (int u = 0; u < nv; ++u) jp += J[o + u] * p[u];
      const float ri = r[i];
      if (ri >= 0.0f && ri + tmax * jp >= 0.0f) continue;  // never active
      const float DJ = D[i] * jp;
#pragma unroll
      for (int t = 0; t < LS_MAX; ++t)
        dphi[t] += DJ * fminf(ri + grid[t] * jp, 0.0f);
    }
    // piecewise-linear monotone dphi: interpolate the sign crossing
    float alpha = 0.0f;
#pragma unroll
    for (int t = 0; t < LS_MAX; ++t)
      if (t == nls - 1 && dphi[t] < 0.0f) alpha = grid[t];
#pragma unroll
    for (int t = 0; t + 1 < LS_MAX; ++t) {
      if (t + 1 >= nls) break;
      const float lo = dphi[t], hi = dphi[t + 1];
      if (lo < 0.0f && hi >= 0.0f) {
        const float frac = clipf(lo / fminf(lo - hi, -1e-12f), 0.0f, 1.0f);
        alpha = grid[t] + frac * (grid[t + 1] - grid[t]);
      }
    }
    for (int v = 0; v < nv; ++v) x[v] += alpha * p[v];
  }

  // ---- final forces, qfrc_constraint = Jᵀ f ----
  for (int v = 0; v < nv; ++v) y[v] = 0.0f;
  for (int i = 0; i < ne; ++i) {
    const int o = i * nv;
    float jx = 0.0f;
    for (int u = 0; u < nv; ++u) jx += J[o + u] * x[u];
    const float ri = jx - ar[i];
    const float fi = ri < 0.0f ? fmaxf(-D[i] * ri, 0.0f) : 0.0f;
    f[i] = fi;
    if (fi == 0.0f) continue;
    for (int u = 0; u < nv; ++u) y[u] += J[o + u] * fi;
  }
  for (int v = 0; v < nv; ++v) qfc[v] = y[v];

  // ---- implicit-damping Euler: (M + diag(hd)) dv = dt qfrc ----
  for (int u = 0; u < nv; ++u)
    for (int w = 0; w <= u; ++w)
      H[u * nv + w] = M[u * nv + w] + (u == w ? __ldg(a.hd + u) : 0.0f);
  chol(H, nv);
  for (int v = 0; v < nv; ++v) y[v] += qf[v];
  chol_solve(H, nv, y);
  const float h = __ldg(a.dt);
  for (int v = 0; v < nv; ++v) {
    qacc[v] = x[v];
    qvn[v] = qv[v] + h * y[v];
  }
}

}  // namespace

extern "C" int hm_solve_euler(const float* M, const float* qf,
                              const float* qv, const float* J,
                              const float* pos, const float* k,
                              const float* b, const float* d,
                              const float* hd, const float* dt,
                              const float* grid, float* qacc, float* qvn,
                              float* f, float* qfc, float* scratch, int B,
                              int nv, int ne, int niter, int nls,
                              void* stream) {
  if (nls < 2 || nls > LS_MAX || nv < 1 || ne < 0 || B < 1)
    return (int)cudaErrorInvalidValue;
  EulerArgs a{M,    qf,  qv,  J,   pos,     k,  b,  d,  hd,    dt, grid,
              qacc, qvn, f,   qfc, scratch, B,  nv, ne, niter, nls};
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  euler_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
