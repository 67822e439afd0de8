// Kernel B2: contact rows + Newton contact solve + implicit-damping Euler,
// one thread per env.
//
// Replaces the TPU kernel humanoid_mujoco_tpu/physics/pallas_solver.py
// `_rows_kernel` + `_solve_core_pyramid` (launched by
// `fused_rows_batched`). Per environment: the branch-free tangent frame
// of every contact slot; the six base Jacobian rows per slot
// [Jn, Jt1, Jt2, Js, Jr1, Jr2] from cdof × rel, masked by the static
// (K, nv) chain mask; the condim-6 pyramid Newton solve factorized on
// those base rows (Cholesky of M, diag(J M⁻¹ Jᵀ) through explicit M⁻¹,
// D and aref from the impedance, then `niter` iterations of active set,
// gradient, H = M + Jᵀ Da J, Cholesky, search direction and the line
// search on the grid {0} ∪ logspace(-3, log10 4, 15) with sign-crossing
// interpolation); the per-slot normal force; qfrc_constraint = Jᵀ f; and
// the Euler update (M + h diag(damping)) dv = h (qfrc_smooth + qfrc_c).
// Constants as in the TPU kernel: Cholesky clamp 1e-12, 1e-9 norm guard.
//
// What bounds it on the H100: at B = 1024 on stand states it moves
// ~6.4 MB of inputs and outputs, and the algorithm needs ~0.26 MFLOP per
// env (chip_smoke.solve_cost counts it from the twin's active sets; ~4 us
// at the fp32 peak), so neither bytes nor FLOPs bound it: one thread per env
// leaves most SMs idle (8 blocks of 128 threads at B = 1024), and each
// thread runs a long dependent chain of small Cholesky factorizations.
//
// What the design does about it: the simple design. Base rows are not
// stored for all slots (6 x 67 x 18 floats per env); each pass recomputes
// one slot's rows from cdof, rel and its frame into a small batch-last
// scratch, and skips dofs outside the slot's chain mask (uniform across
// the warp, since the mask is static). Slots with no active edge skip the
// gradient and Hessian updates, and edges that cannot become active skip
// the line search. All per-env scratch is wrapper-allocated and
// batch-last; the kernel allocates nothing. Spreading one env over a warp
// is later work.

#include "common.cuh"

using namespace hm;

namespace {

constexpr int LS_MAX = 16;  // capacity of the line-search grid

struct SolveArgs {
  const float *M, *qf, *qv, *cdof, *rel, *nrm, *dist, *mu3, *dmask, *kc, *bc,
      *dc, *lpos, *kl, *bl, *dl, *hd, *dt;
  const int *lim_ptr, *lim_dof;
  const float *lim_coef, *grid;
  float *qacc, *qvn, *fslot, *qfc, *scratch;
  int B, nv, K, nlim, niter, nls;
};

struct Ctx {
  In cdof, rel, nrm;
  Out fr;  // per-slot frame [t1 (3); t2 (3)] x K
  const float* dmask;
  int nv, K;

  __device__ __forceinline__ float dm(int c, int v) const {
    return __ldg(dmask + c * nv + v);
  }

  // base rows of slot c for dof v: [Jn, Jt1, Jt2, Js, Jr1, Jr2]
  __device__ __forceinline__ void rows(int c, int v, float dmv,
                                       float J[6]) const {
    const V3 w{cdof[6 * v], cdof[6 * v + 1], cdof[6 * v + 2]};
    const V3 l{cdof[6 * v + 3], cdof[6 * v + 4], cdof[6 * v + 5]};
    const V3 r{rel[c], rel[K + c], rel[2 * K + c]};
    const V3 n{nrm[c], nrm[K + c], nrm[2 * K + c]};
    const V3 t1{fr[c], fr[K + c], fr[2 * K + c]};
    const V3 t2{fr[3 * K + c], fr[4 * K + c], fr[5 * K + c]};
    // point jacobian: cdof_lin + cdof_ang × rel, masked to the chain
    const V3 jp = (l + cross(w, r)) * dmv;
    const V3 ja = w * dmv;
    J[0] = dot(jp, n);
    J[1] = dot(jp, t1);
    J[2] = dot(jp, t2);
    J[3] = dot(ja, n);
    J[4] = dot(ja, t1);
    J[5] = dot(ja, t2);
  }

  // b[a] = J_a(slot c) · x for the 6 base rows; also stores the rows
  // into Jc (6 x nv) when given
  template <class View>
  __device__ void dots(int c, const View& x, float b[6],
                       const Out* Jc) const {
    for (int a = 0; a < 6; ++a) b[a] = 0.0f;
    for (int v = 0; v < nv; ++v) {
      const float dmv = dm(c, v);
      if (dmv == 0.0f) {
        if (Jc)
          for (int a = 0; a < 6; ++a) (*Jc)[a * nv + v] = 0.0f;
        continue;
      }
      float J[6];
      rows(c, v, dmv, J);
      const float xv = x[v];
      for (int a = 0; a < 6; ++a) {
        b[a] += J[a] * xv;
        if (Jc) (*Jc)[a * nv + v] = J[a];
      }
    }
  }
};

__global__ void __launch_bounds__(128) solve_kernel(SolveArgs a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int B = a.B;
  if (e >= B) return;
  const int nv = a.nv, K = a.K, nlim = a.nlim, nls = a.nls;

  const In Min{a.M + e, B}, qf{a.qf + e, B}, qv{a.qv + e, B},
      dist{a.dist + e, B}, mu3{a.mu3 + e, B}, kc{a.kc + e, B},
      bc{a.bc + e, B}, dc{a.dc + e, B}, lpos{a.lpos + e, B},
      kl{a.kl + e, B}, bl{a.bl + e, B}, dl{a.dl + e, B};
  const Out qacc{a.qacc + e, B}, qvn{a.qvn + e, B}, fslot{a.fslot + e, B},
      qfc{a.qfc + e, B};

  Carver cv{a.scratch + e, B, 0};
  const Out Mm = cv.take(nv * nv), L = cv.take(nv * nv),
            Minv = cv.take(nv * nv), H = cv.take(nv * nv);
  const Out as = cv.take(nv), x = cv.take(nv), p = cv.take(nv),
            g = cv.take(nv), Mx = cv.take(nv), tmp = cv.take(nv);
  const Out fr = cv.take(6 * K), De = cv.take(10 * K), ar = cv.take(10 * K),
            re = cv.take(10 * K);
  const Out Dl = cv.take(nlim), al = cv.take(nlim), rl = cv.take(nlim);
  const Out Jc = cv.take(6 * nv), PQ = cv.take(6 * nv);

  const Ctx C{In{a.cdof + e, B}, In{a.rel + e, B}, In{a.nrm + e, B}, fr,
              a.dmask, nv, K};
  const int* lim_ptr = a.lim_ptr;
  const int* lim_dof = a.lim_dof;
  const float* lim_coef = a.lim_coef;

  float grid[LS_MAX];
#pragma unroll
  for (int t = 0; t < LS_MAX; ++t) grid[t] = t < nls ? __ldg(a.grid + t) : 0.f;
  // r + t jp is linear in t: a row is active somewhere on the grid iff it
  // is at t = 0 or at the last grid point
  const float tmax = __ldg(a.grid + nls - 1);

  // ---- Cholesky of M, unconstrained acceleration, explicit M⁻¹ ----
  for (int i = 0; i < nv * nv; ++i) {
    Mm[i] = Min[i];
    L[i] = Mm[i];
  }
  chol(L, nv);
  for (int v = 0; v < nv; ++v) as[v] = qf[v];
  chol_solve(L, nv, as);
  for (int u = 0; u < nv; ++u) {
    for (int v = 0; v < nv; ++v) tmp[v] = v == u ? 1.0f : 0.0f;
    chol_solve(L, nv, tmp);
    for (int v = 0; v < nv; ++v) Minv[v * nv + u] = tmp[v];
  }

  // ---- per slot: tangent frame, diag(J M⁻¹ Jᵀ) per edge, D, aref ----
  for (int c = 0; c < K; ++c) {
    const V3 n{C.nrm[c], C.nrm[K + c], C.nrm[2 * K + c]};
    const bool up = fabsf(n.z) > 0.9f;
    const float rx = up ? 1.0f : 0.0f, rz = up ? 0.0f : 1.0f;
    V3 t1{-rz * n.y, rz * n.x - rx * n.z, rx * n.y};
    t1 = t1 * (1.0f / mx(sqrtf(dot(t1, t1)), 1e-9f));
    const V3 t2 = cross(n, t1);
    fr[c] = t1.x;
    fr[K + c] = t1.y;
    fr[2 * K + c] = t1.z;
    fr[3 * K + c] = t2.x;
    fr[4 * K + c] = t2.y;
    fr[5 * K + c] = t2.z;
  }
  for (int c = 0; c < K; ++c) {
    float bq[6];
    C.dots(c, qv, bq, &Jc);
    // Gram entries: A_nn, A_nt[t], A_tt[t] over the slot's chain dofs
    float Ann = 0.0f, Ant[6] = {0}, Att[6] = {0};
    for (int base = 0; base < 6; ++base) {
      for (int u = 0; u < nv; ++u) {
        if (C.dm(c, u) == 0.0f) continue;
        float y = 0.0f;
        for (int v = 0; v < nv; ++v)
          if (C.dm(c, v) != 0.0f) y += Minv[u * nv + v] * Jc[base * nv + v];
        if (base == 0) {
          Ann += Jc[u] * y;
        } else {
          Ant[base] += Jc[u] * y;
          Att[base] += Jc[base * nv + u] * y;
        }
      }
    }
    const float mus = mu3[c], mut = mu3[K + c], mur = mu3[2 * K + c];
    const float mu[5] = {mus, mus, mut, mur, mur};
    const float d = dc[c];
    const float Rf = fmaxf((1.0f - d) / fmaxf(d, 1e-4f), 1e-6f);
    const float kdp = kc[c] * d * dist[c], b = bc[c];
    for (int i = 0; i < 5; ++i) {
      const float cr = 2.0f * mu[i] * Ant[i + 1];
      const float qd = mu[i] * mu[i] * Att[i + 1];
      const float mt = mu[i] * bq[i + 1];
      De[(2 * i) * K + c] = 1.0f / (Rf * mx(Ann + cr + qd, 1e-10f));
      De[(2 * i + 1) * K + c] = 1.0f / (Rf * mx(Ann - cr + qd, 1e-10f));
      ar[(2 * i) * K + c] = -b * (bq[0] + mt) - kdp;
      ar[(2 * i + 1) * K + c] = -b * (bq[0] - mt) - kdp;
    }
  }
  // limit rows: static sparse Jacobians
  for (int l = 0; l < nlim; ++l) {
    float diag = 0.0f, jv = 0.0f;
    for (int i = lim_ptr[l]; i < lim_ptr[l + 1]; ++i) {
      const int u = lim_dof[i];
      const float cu = __ldg(lim_coef + i);
      jv += cu * qv[u];
      for (int k = lim_ptr[l]; k < lim_ptr[l + 1]; ++k)
        diag += cu * __ldg(lim_coef + k) * Minv[u * nv + lim_dof[k]];
    }
    const float d = dl[l];
    const float Rf = fmaxf((1.0f - d) / fmaxf(d, 1e-4f), 1e-6f);
    Dl[l] = 1.0f / (Rf * mx(diag, 1e-10f));
    al[l] = -bl[l] * jv - kl[l] * d * lpos[l];
  }

  // ---- Newton iterations ----
  for (int v = 0; v < nv; ++v) x[v] = as[v];
  for (int it = 0; it < a.niter; ++it) {
    for (int u = 0; u < nv; ++u) {
      float s = 0.0f;
      for (int v = 0; v < nv; ++v) s += Mm[u * nv + v] * (x[v] - as[v]);
      Mx[u] = s;
      g[u] = s;
      for (int w = 0; w <= u; ++w) H[u * nv + w] = Mm[u * nv + w];
    }
    for (int c = 0; c < K; ++c) {
      float bx[6];
      C.dots(c, x, bx, &Jc);
      const float mus = mu3[c], mut = mu3[K + c], mur = mu3[2 * K + c];
      const float mu[5] = {mus, mus, mut, mur, mur};
      float Da[10], y[10];
      bool active = false;
      for (int i = 0; i < 5; ++i) {
        const float mt = mu[i] * bx[i + 1];
        const float r0 = bx[0] + mt - ar[(2 * i) * K + c];
        const float r1 = bx[0] - mt - ar[(2 * i + 1) * K + c];
        re[(2 * i) * K + c] = r0;
        re[(2 * i + 1) * K + c] = r1;
        Da[2 * i] = r0 < 0.0f ? De[(2 * i) * K + c] : 0.0f;
        Da[2 * i + 1] = r1 < 0.0f ? De[(2 * i + 1) * K + c] : 0.0f;
        y[2 * i] = Da[2 * i] * r0;
        y[2 * i + 1] = Da[2 * i + 1] * r1;
        active |= (r0 < 0.0f) || (r1 < 0.0f);
      }
      if (!active) continue;
      // gradient: Jᵀ (Da r) collapsed onto the base rows
      float Y0 = 0.0f, c0 = 0.0f;
      for (int k = 0; k < 10; ++k) {
        Y0 += y[k];
        c0 += Da[k];
      }
      float Z[5], ci[5], cii[5];
      for (int i = 0; i < 5; ++i) {
        Z[i] = mu[i] * (y[2 * i] - y[2 * i + 1]);
        ci[i] = mu[i] * (Da[2 * i] - Da[2 * i + 1]);
        cii[i] = mu[i] * mu[i] * (Da[2 * i] + Da[2 * i + 1]);
      }
      for (int v = 0; v < nv; ++v) {
        if (C.dm(c, v) == 0.0f) continue;
        float s = Jc[v] * Y0, P = c0 * Jc[v];
        for (int i = 0; i < 5; ++i) {
          const float jt = Jc[(i + 1) * nv + v];
          s += jt * Z[i];
          P += ci[i] * jt;
          PQ[(i + 1) * nv + v] = ci[i] * Jc[v] + cii[i] * jt;
        }
        g[v] += s;
        PQ[v] = P;
      }
      // H += Jᵀ Da J: lower triangle over the slot's chain dofs
      for (int u = 0; u < nv; ++u) {
        if (C.dm(c, u) == 0.0f) continue;
        const float jn = Jc[u];
        float jt[5];
        for (int i = 0; i < 5; ++i) jt[i] = Jc[(i + 1) * nv + u];
        for (int w = 0; w <= u; ++w) {
          if (C.dm(c, w) == 0.0f) continue;
          float h = jn * PQ[w];
          for (int i = 0; i < 5; ++i) h += jt[i] * PQ[(i + 1) * nv + w];
          H[u * nv + w] += h;
        }
      }
    }
    for (int l = 0; l < nlim; ++l) {
      float s = 0.0f;
      for (int i = lim_ptr[l]; i < lim_ptr[l + 1]; ++i)
        s += __ldg(lim_coef + i) * x[lim_dof[i]];
      const float r = s - al[l];
      rl[l] = r;
      if (!(r < 0.0f)) continue;
      const float D = Dl[l];
      for (int i = lim_ptr[l]; i < lim_ptr[l + 1]; ++i) {
        const int u = lim_dof[i];
        const float cu = __ldg(lim_coef + i);
        g[u] += cu * D * r;
        for (int k = lim_ptr[l]; k < lim_ptr[l + 1]; ++k) {
          const int v = lim_dof[k];
          if (v <= u) H[u * nv + v] += cu * __ldg(lim_coef + k) * D;
        }
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
      for (int v = 0; v < nv; ++v) s += Mm[u * nv + v] * p[v];
      pMp += p[u] * s;
      b0 += p[u] * Mx[u];
    }
    float dphi[LS_MAX];
#pragma unroll
    for (int t = 0; t < LS_MAX; ++t) dphi[t] = b0 + grid[t] * pMp;
    for (int c = 0; c < K; ++c) {
      float bp[6];
      C.dots(c, p, bp, nullptr);
      const float mus = mu3[c], mut = mu3[K + c], mur = mu3[2 * K + c];
      const float mu[5] = {mus, mus, mut, mur, mur};
      for (int k = 0; k < 10; ++k) {
        const float mt = mu[k / 2] * bp[k / 2 + 1];
        const float jp = (k & 1) ? bp[0] - mt : bp[0] + mt;
        const float r = re[k * K + c];
        if (r >= 0.0f && r + tmax * jp >= 0.0f) continue;  // never active
        const float DJ = De[k * K + c] * jp;
#pragma unroll
        for (int t = 0; t < LS_MAX; ++t)
          dphi[t] += DJ * fminf(r + grid[t] * jp, 0.0f);
      }
    }
    for (int l = 0; l < nlim; ++l) {
      float jp = 0.0f;
      for (int i = lim_ptr[l]; i < lim_ptr[l + 1]; ++i)
        jp += __ldg(lim_coef + i) * p[lim_dof[i]];
      const float r = rl[l];
      if (r >= 0.0f && r + tmax * jp >= 0.0f) continue;
      const float DJ = Dl[l] * jp;
#pragma unroll
      for (int t = 0; t < LS_MAX; ++t)
        dphi[t] += DJ * fminf(r + grid[t] * jp, 0.0f);
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

  // ---- final forces, per-slot normal force, qfrc_constraint = Jᵀ f ----
  for (int v = 0; v < nv; ++v) qfc[v] = 0.0f;
  for (int c = 0; c < K; ++c) {
    float bx[6];
    C.dots(c, x, bx, &Jc);
    const float mus = mu3[c], mut = mu3[K + c], mur = mu3[2 * K + c];
    const float mu[5] = {mus, mus, mut, mur, mur};
    float f[10], fs = 0.0f;
    for (int k = 0; k < 10; ++k) {
      const float mt = mu[k / 2] * bx[k / 2 + 1];
      const float r = ((k & 1) ? bx[0] - mt : bx[0] + mt) - ar[k * K + c];
      f[k] = r < 0.0f ? fmaxf(-De[k * K + c] * r, 0.0f) : 0.0f;
      fs += f[k];
    }
    fslot[c] = fs;
    if (fs == 0.0f) continue;
    float Z[5];
    for (int i = 0; i < 5; ++i) Z[i] = mu[i] * (f[2 * i] - f[2 * i + 1]);
    for (int v = 0; v < nv; ++v) {
      if (C.dm(c, v) == 0.0f) continue;
      float s = Jc[v] * fs;
      for (int i = 0; i < 5; ++i) s += Jc[(i + 1) * nv + v] * Z[i];
      qfc[v] += s;
    }
  }
  for (int l = 0; l < nlim; ++l) {
    float s = 0.0f;
    for (int i = lim_ptr[l]; i < lim_ptr[l + 1]; ++i)
      s += __ldg(lim_coef + i) * x[lim_dof[i]];
    const float r = s - al[l];
    const float fl = r < 0.0f ? fmaxf(-Dl[l] * r, 0.0f) : 0.0f;
    for (int i = lim_ptr[l]; i < lim_ptr[l + 1]; ++i)
      qfc[lim_dof[i]] += __ldg(lim_coef + i) * fl;
  }

  // ---- implicit-damping Euler: (M + h diag(damping)) dv = h qfrc ----
  for (int u = 0; u < nv; ++u)
    for (int w = 0; w <= u; ++w)
      H[u * nv + w] = Mm[u * nv + w] + (u == w ? __ldg(a.hd + u) : 0.0f);
  chol(H, nv);
  for (int v = 0; v < nv; ++v) tmp[v] = qf[v] + qfc[v];
  chol_solve(H, nv, tmp);
  const float h = __ldg(a.dt);
  for (int v = 0; v < nv; ++v) {
    qacc[v] = x[v];
    qvn[v] = qv[v] + h * tmp[v];
  }
}

}  // namespace

extern "C" int hm_solve(const float* M, const float* qf, const float* qv,
                        const float* cdof, const float* rel, const float* nrm,
                        const float* dist, const float* mu3,
                        const float* dmask, const float* kc, const float* bc,
                        const float* dc, const float* lpos, const float* kl,
                        const float* bl, const float* dl, const float* hd,
                        const float* dt, const int* lim_ptr,
                        const int* lim_dof, const float* lim_coef,
                        const float* grid, float* qacc, float* qvn,
                        float* fslot, float* qfc, float* scratch, int B,
                        int nv, int K, int nlim, int niter, int nls,
                        void* stream) {
  if (nls < 2 || nls > LS_MAX) return (int)cudaErrorInvalidValue;
  SolveArgs a{M,    qf,   qv,   cdof,  rel,     nrm,      dist,    mu3,
              dmask, kc,  bc,   dc,    lpos,    kl,       bl,      dl,
              hd,   dt,   lim_ptr, lim_dof, lim_coef, grid,  qacc,  qvn,
              fslot, qfc, scratch, B,   nv,      K,        nlim,    niter,
              nls};
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  solve_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
