// Kernel B3: Newton constraint solve on explicit rows + implicit-damping
// Euler, one warp per environment, the environment's working set in
// shared memory.
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
// moves ~1 KB per env and needs ~10 kFLOP per env, so at B = 1024 its
// bound is well under a microsecond (bytes); on the humanoid's 694
// selection-free rows it reads J once (51 MB at B = 1024, ~15 us). What
// bounds this kernel is the serial chain inside one environment: three
// Cholesky factorizations and their solves per iteration's worth of
// dependent shared-memory round trips, and passes over the rows whose
// loads the few warps of an SM barely hide (tools/solver_phases.py
// prints the cycles of each phase).
//
// What the design does about it (the earlier one-thread-per-env kernel
// put 8 blocks on 132 SMs and walked batch-last global memory):
// - one warp per env, `envs` warps per block (up to 4, fewer when one
//   env's working set is large), so B = 1024 is 1024 warps;
// - batch-first inputs read in place at their strides, once each, M and
//   J into shared memory by asynchronous copies (cp.async, all of a
//   lane's in flight at once): an env's M, J and row data are contiguous
//   as the twin lays them out, so the warp's loads coalesce; an input
//   shared by the batch (the Swimmer's static J, its shared b) has stride
//   0, and a transposed view (the Swimmer's M) is read as it is; no
//   layout copies;
// - the env's working set lives in dynamic shared memory, carved by
//   `make_layout` (mirrored by fused_solver.euler_smem_bytes): M, the
//   factor / Hessian, J staged once (row stride nv | 1, so that lanes on
//   neighbouring rows hit distinct banks), D, aref and r per row, a work
//   area for L⁻¹, the active rows' coefficients, J p and f, six
//   nv-vectors and the active-row list;
// - lanes spread each phase: over rows for J x, J p, the residuals,
//   diag(J M⁻¹ Jᵀ), D, aref and the forces (active rows compacted in row
//   order with __ballot_sync); over dofs for the gradient and Jᵀ f; over
//   the lower-triangle entries of H, each summed over the active rows in
//   order; over the rows of a column for the Cholesky and the solves
//   (common.cuh warp_chol, warp_chol_solve, warp_tri_inv and their
//   two-rows-a-lane forms); over (row, grid point)
//   pairs for the line search, two rows at a time;
// - nv up to 64: R = 1 (nv <= 32) or R = 2 matrix rows per lane in the
//   factorizations and solves, a template parameter;
// - L⁻¹ is formed once (tri_inv), so diag(J M⁻¹ Jᵀ)_i = |L⁻¹ J_iᵀ|²
//   is a sum of independent products per row instead of a substitution;
// - inactive rows skip the gradient and Hessian, and rows inactive
//   everywhere on the grid skip the line search (r + t J p is linear in
//   t: a row is active somewhere iff it is at t = 0 or at the grid end);
// - every sum runs in a fixed order (row order, then a fixed warp
//   butterfly), with no atomics, so two launches on the same inputs give
//   the same bits;
// - a NaN input stays NaN (`mx` keeps it, and a row with a NaN residual
//   counts as active, as the twin's Da r does), so the step's divergence
//   guard sees a diverged env; other envs are untouched.

#include "common.cuh"

using namespace hm;

namespace {

constexpr int LS_MAX = 16;   // capacity of the line-search grid
constexpr int NV_MAX = 64;   // two matrix rows per lane
constexpr int ENVS_MAX = 8;  // warps per block

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// One env's region of dynamic shared memory, offsets in floats.
struct Layout {
  int ld;  // row stride of M, H, L⁻¹ and J (odd)
  int Mm, H, Js, De, ar, re, W, vec, act, env;
};

__host__ __device__ inline Layout make_layout(int nv, int ne) {
  Layout L;
  L.ld = nv | 1;
  int o = 0;
  L.Mm = o;
  o += nv * L.ld;
  L.H = o;
  o += nv * L.ld;
  L.Js = o;
  o += ne * L.ld;
  L.De = o;
  o += ne;
  L.ar = o;
  o += ne;
  L.re = o;
  o += ne;
  // L⁻¹ in the setup; (Da, Da r) of the active rows; J p; f
  const int w = nv * L.ld > 2 * ne ? nv * L.ld : 2 * ne;
  L.W = o;
  o += w;
  L.vec = o;
  o += 6 * nv;
  L.act = o;
  o += ne;
  L.env = round_up(o, 4);
  return L;
}

struct EulerArgs {
  const float *M, *qf, *qv, *J, *pos, *k, *b, *d, *hd, *dt, *grid;
  float *qacc, *qvn, *f, *qfc;
  // the inputs' strides in floats, batch first (0: shared by the batch)
  int sM[3], sqf[2], sqv[2], sJ[3], spos[2], sk[2], sb[2], sd[2];
  int B, nv, ne, niter, nls, envs;
};

template <int R>
__global__ void __launch_bounds__(32 * ENVS_MAX) euler_kernel(EulerArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, nv = a.nv, ne = a.ne, nls = a.nls;
  const Layout lay = make_layout(nv, ne);
  const int ld = lay.ld;
  const int wid = threadIdx.x >> 5, lane = lane_id();
  const int e = blockIdx.x * a.envs + wid;
  if (e >= B) return;  // the ragged last block; no block barrier follows

  float* S = reinterpret_cast<float*>(smem) + wid * lay.env;
  float *Mm = S + lay.Mm, *H = S + lay.H, *Js = S + lay.Js,
        *De = S + lay.De, *ar = S + lay.ar, *re = S + lay.re,
        *W = S + lay.W;
  float *AS = S + lay.vec, *X = AS + nv, *P = AS + 2 * nv,
        *QV = AS + 3 * nv, *QF = AS + 4 * nv, *INV = AS + 5 * nv;
  int* act = reinterpret_cast<int*>(S + lay.act);
  const size_t eb = (size_t)e;
  const float *gpos = a.pos + eb * a.spos[0], *gk = a.k + eb * a.sk[0],
              *gb = a.b + eb * a.sb[0], *gd = a.d + eb * a.sd[0];
  const unsigned below = (1u << lane) - 1u;

  // ---- load the env's inputs once ----
  // a matrix (n rows of nv) at strides (s1, s2) into rows of stride ld,
  // by asynchronous copies, all of a lane's in flight at once
  auto stage = [&](const float* g, int n, int s1, int s2, float* dst) {
    int r = lane / nv, c = lane % nv;
    for (int i = lane; i < n * nv; i += 32) {
      cp_async4(dst + r * ld + c, g + r * s1 + c * s2);
      c += 32;
      while (c >= nv) {
        c -= nv;
        ++r;
      }
    }
  };
  {
    stage(a.M + eb * a.sM[0], nv, a.sM[1], a.sM[2], Mm);
    stage(a.J + eb * a.sJ[0], ne, a.sJ[1], a.sJ[2], Js);
    for (int v = lane; v < nv; v += 32) {
      QV[v] = __ldg(a.qv + eb * a.sqv[0] + v * a.sqv[1]);
      QF[v] = __ldg(a.qf + eb * a.sqf[0] + v * a.sqf[1]);
    }
    cp_async_wait();
    __syncwarp();
    for (int i = lane; i < nv * ld; i += 32) H[i] = Mm[i];
  }
  __syncwarp();

  // ---- Cholesky of M (in H), unconstrained acceleration, L⁻¹ ----
  chol<R>(H, nv, ld, INV);
  {
    float as[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int u = lane + 32 * q;
      as[q] = u < nv ? QF[u] : 0.0f;
    }
    chol_solve<R>(H, INV, nv, ld, as);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int u = lane + 32 * q;
      if (u < nv) {
        AS[u] = as[q];
        X[u] = as[q];
      }
    }
  }
  const float* Li = W;
  tri_inv<R>(H, INV, nv, ld, W);

  // ---- lanes over rows: diag(J M⁻¹ Jᵀ) = |L⁻¹ Jᵢᵀ|², D and aref ----
  for (int i = lane; i < ne; i += 32) {
    const float* ji = Js + i * ld;
    const float jv = sum4(0, nv, [&](int u) { return ji[u] * QV[u]; });
    int k0 = nv;  // the row's first nonzero: y_k = 0 for k below it
#pragma unroll 4
    for (int u = nv - 1; u >= 0; --u) k0 = ji[u] != 0.0f ? u : k0;
    float diag = 0.0f;
    for (int k = k0; k < nv; ++k) {
      const float* lk = Li + k * ld;
      const float y = sum4(k0, k + 1, [&](int u) { return lk[u] * ji[u]; });
      diag += y * y;
    }
    const float d = __ldg(gd + i * a.sd[1]);
    const float Rf = fmaxf((1.0f - d) / fmaxf(d, 1e-4f), 1e-6f);
    De[i] = 1.0f / (Rf * mx(diag, 1e-10f));
    ar[i] = -__ldg(gb + i * a.sb[1]) * jv -
            __ldg(gk + i * a.sk[1]) * d * __ldg(gpos + i * a.spos[1]);
  }
  __syncwarp();

  // H's lower-triangle entries: entry tt is (u, w), w <= u
  const int ntri = nv * (nv + 1) / 2;
  auto tri = [](int tt, int& u, int& w) {
    u = (int)((sqrtf(8.0f * tt + 1.0f) - 1.0f) * 0.5f);
    while (u * (u + 1) / 2 > tt) --u;
    while ((u + 1) * (u + 2) / 2 <= tt) ++u;
    w = tt - u * (u + 1) / 2;
  };

  // line-search lanes: two rows at a time (half), 16 grid points (t)
  const int t = lane & 15, half = lane >> 4;
  const float gt = __ldg(a.grid + min(t, nls - 1));
  const float gnext = __shfl_sync(FULL_MASK, gt, (lane + 1) & 31);
  // r + t jp is linear in t: a row is active somewhere on the grid iff it
  // is at t = 0 or at the last grid point
  const float tmax = __ldg(a.grid + nls - 1);

  // ---- Newton iterations ----
  for (int it = 0; it < a.niter; ++it) {
    // lanes over rows: residuals, active set, (Da, Da r) per active row
    int nact = 0;
    for (int base = 0; base < ne; base += 32) {
      const int i = base + lane;
      bool active = false;
      float Da = 0.0f, Dr = 0.0f;
      if (i < ne) {
        const float* ji = Js + i * ld;
        float s = 0.0f;
        for (int u = 0; u < nv; ++u) s += ji[u] * X[u];
        const float r = s - ar[i];
        re[i] = r;
        Da = r < 0.0f ? De[i] : 0.0f;
        Dr = Da * r;
        // a NaN residual counts: its Da r is NaN, as in the twin
        active = !(r >= 0.0f);
      }
      const unsigned mask = __ballot_sync(FULL_MASK, active);
      if (active) {
        const int j = nact + __popc(mask & below);
        act[j] = i;
        W[2 * j] = Da;
        W[2 * j + 1] = Dr;
      }
      nact += __popc(mask);
    }
    __syncwarp();

    // lanes over dofs: M (x - a_smooth) and the gradient, in registers
    float mxu[R], gu[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int u = lane + 32 * q;
      mxu[q] = gu[q] = 0.0f;
      if (u < nv) {
        const float* mu = Mm + u * ld;
        mxu[q] = sum4(0, nv, [&](int v) { return mu[v] * (X[v] - AS[v]); });
        gu[q] = mxu[q];
#pragma unroll 4
        for (int j = 0; j < nact; ++j)
          gu[q] += Js[act[j] * ld + u] * W[2 * j + 1];
      }
    }
    // H = M + Jᵀ Da J, lanes over the lower triangle, each entry summed
    // over the active rows in order
    for (int tt = lane; tt < ntri; tt += 32) {
      int u, w;
      tri(tt, u, w);
      float h = Mm[u * ld + w];
#pragma unroll 4
      for (int j = 0; j < nact; ++j) {
        const float* ji = Js + act[j] * ld;
        h += W[2 * j] * ji[u] * ji[w];
      }
      H[u * ld + w] = h;
    }
    __syncwarp();
    chol<R>(H, nv, ld, INV);
    float pu[R];
#pragma unroll
    for (int q = 0; q < R; ++q) pu[q] = gu[q];
    chol_solve<R>(H, INV, nv, ld, pu);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int u = lane + 32 * q;
      pu[q] = -pu[q];
      if (u < nv) P[u] = pu[q];
    }
    __syncwarp();

    // ---- line search on the fixed grid ----
    float pmp = 0.0f, pmx = 0.0f;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int u = lane + 32 * q;
      if (u < nv) {
        const float* mu = Mm + u * ld;
        pmp += pu[q] * sum4(0, nv, [&](int v) { return mu[v] * P[v]; });
        pmx += pu[q] * mxu[q];
      }
    }
    const float pMp = warp_sum(pmp), b0 = warp_sum(pmx);
    // lanes over rows: J p, and the rows active somewhere on the grid
    int nls_rows = 0;
    for (int base = 0; base < ne; base += 32) {
      const int i = base + lane;
      bool any = false;
      if (i < ne) {
        const float* ji = Js + i * ld;
        float jp = 0.0f;
        for (int u = 0; u < nv; ++u) jp += ji[u] * P[u];
        W[i] = jp;
        const float r = re[i];
        any = !(r >= 0.0f && r + tmax * jp >= 0.0f);
      }
      const unsigned mask = __ballot_sync(FULL_MASK, any);
      if (any) act[nls_rows + __popc(mask & below)] = i;
      nls_rows += __popc(mask);
    }
    __syncwarp();
    // lanes over (row, grid point): lane t of each half sums its rows
    float acc = 0.0f;
    for (int j = half; j < nls_rows; j += 2) {
      const int i = act[j];
      const float r = re[i], jp = W[i];
      acc += De[i] * jp * fminf(r + gt * jp, 0.0f);
    }
    const float dphi =
        (b0 + gt * pMp) + (acc + __shfl_xor_sync(FULL_MASK, acc, 16));
    // piecewise-linear monotone dphi: interpolate the last sign crossing,
    // else the grid's end if dphi is still negative there, else 0
    const float hi = __shfl_sync(FULL_MASK, dphi, (lane + 1) & 31);
    const bool crossing = lane + 1 < nls && dphi < 0.0f && hi >= 0.0f;
    const unsigned cm = __ballot_sync(FULL_MASK, crossing);
    const float frac = clipf(dphi / fminf(dphi - hi, -1e-12f), 0.0f, 1.0f);
    const float at = gt + frac * (gnext - gt);
    const float last = __shfl_sync(FULL_MASK, dphi, nls - 1);
    const float across = __shfl_sync(FULL_MASK, at, cm ? 31 - __clz(cm) : 0);
    const float alpha = cm ? across : (last < 0.0f ? tmax : 0.0f);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int u = lane + 32 * q;
      if (u < nv) X[u] += alpha * pu[q];
    }
    __syncwarp();
  }

  // ---- final forces, qfrc_constraint = Jᵀ f ----
  int nload = 0;
  for (int base = 0; base < ne; base += 32) {
    const int i = base + lane;
    bool loaded = false;
    float fi = 0.0f;
    if (i < ne) {
      const float* ji = Js + i * ld;
      float s = 0.0f;
      for (int u = 0; u < nv; ++u) s += ji[u] * X[u];
      const float r = s - ar[i];
      fi = r >= 0.0f ? 0.0f : mx(-De[i] * r, 0.0f);
      a.f[eb * ne + i] = fi;
      loaded = !(fi == 0.0f);
    }
    const unsigned mask = __ballot_sync(FULL_MASK, loaded);
    if (loaded) {
      const int j = nload + __popc(mask & below);
      act[j] = i;
      W[j] = fi;
    }
    nload += __popc(mask);
  }
  __syncwarp();
  float qc[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int u = lane + 32 * q;
    qc[q] = 0.0f;
    if (u < nv) {
      for (int j = 0; j < nload; ++j) qc[q] += Js[act[j] * ld + u] * W[j];
      a.qfc[eb * nv + u] = qc[q];
    }
  }

  // ---- implicit-damping Euler: (M + diag(hd)) dv = dt qfrc ----
  for (int tt = lane; tt < ntri; tt += 32) {
    int u, w;
    tri(tt, u, w);
    H[u * ld + w] = Mm[u * ld + w] + (u == w ? __ldg(a.hd + u) : 0.0f);
  }
  __syncwarp();
  chol<R>(H, nv, ld, INV);
  float dv[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int u = lane + 32 * q;
    dv[q] = u < nv ? QF[u] + qc[q] : 0.0f;
  }
  chol_solve<R>(H, INV, nv, ld, dv);
  const float h = __ldg(a.dt);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int u = lane + 32 * q;
    if (u < nv) {
      a.qacc[eb * nv + u] = X[u];
      a.qvn[eb * nv + u] = QV[u] + h * dv[q];
    }
  }
}

const void* kernel_for(int nv) {
  return nv <= 32 ? (const void*)euler_kernel<1> : (const void*)euler_kernel<2>;
}

int check_shape(int nv, int ne, int nls, int envs, int smem) {
  if (nls < 2 || nls > LS_MAX || nv < 1 || nv > NV_MAX || ne < 0 ||
      envs < 1 || envs > ENVS_MAX)
    return (int)cudaErrorInvalidValue;
  if (smem != 4 * envs * make_layout(nv, ne).env)
    return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel_for(nv), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// Batch-first inputs M (B, nv, nv), qf / qv (B, nv), J (B, ne, nv),
// pos / k / b / d (B, ne) at any strides, given in floats in `st`
// (18 values: M's three, qf's two, qv's two, J's three, then two each
// for pos, k, b, d; a stride of 0 repeats the data); outputs contiguous
// (B, nv) / (B, ne). smem: dynamic shared memory of one block,
// fused_solver.euler_smem_bytes(nv, ne, envs); checked against
// make_layout.
extern "C" int hm_solve_euler(const float* M, const float* qf,
                              const float* qv, const float* J,
                              const float* pos, const float* k,
                              const float* b, const float* d,
                              const float* hd, const float* dt,
                              const float* grid, float* qacc, float* qvn,
                              float* f, float* qfc, const int* st, int B,
                              int nv, int ne, int niter, int nls, int envs,
                              int smem, void* stream) {
  const int err = check_shape(nv, ne, nls, envs, smem);
  if (err != 0) return err;
  if (B <= 0) return 0;
  EulerArgs a{M, qf, qv, J, pos, k, b, d, hd, dt, grid, qacc, qvn, f, qfc};
  int* dst[] = {a.sM, a.sqf, a.sqv, a.sJ, a.spos, a.sk, a.sb, a.sd};
  const int rank[] = {3, 2, 2, 3, 2, 2, 2, 2};
  for (int x = 0, o = 0; x < 8; ++x)
    for (int r = 0; r < rank[x]; ++r) dst[x][r] = st[o++];
  a.B = B;
  a.nv = nv;
  a.ne = ne;
  a.niter = niter;
  a.nls = nls;
  a.envs = envs;
  const int blocks = (B + envs - 1) / envs;
  if (nv <= 32)
    euler_kernel<1><<<blocks, 32 * envs, smem, (cudaStream_t)stream>>>(a);
  else
    euler_kernel<2><<<blocks, 32 * envs, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Occupancy of the kernel at this block shape: out[0] blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] registers per
// thread, out[2] local (spill) bytes per thread.
extern "C" int hm_solve_euler_occupancy(int nv, int ne, int envs, int smem,
                                        int* out) {
  int err = check_shape(nv, ne, LS_MAX, envs, smem);
  if (err != 0) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], kernel_for(nv), 32 * envs, smem);
  if (err != 0) return err;
  cudaFuncAttributes fa;
  err = (int)cudaFuncGetAttributes(&fa, kernel_for(nv));
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  return err;
}
