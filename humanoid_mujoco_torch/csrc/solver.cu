// Kernel B2: contact rows + Newton contact solve + implicit-damping Euler,
// one warp per environment, the environment's working set in shared
// memory.
//
// Replaces the TPU kernel humanoid_mujoco_tpu/physics/pallas_solver.py
// `_rows_kernel` + `_solve_core_pyramid` (launched by
// `fused_rows_batched`). Per environment: the branch-free tangent frame
// of every contact slot; the six base Jacobian rows per slot
// [Jn, Jt1, Jt2, Js, Jr1, Jr2] from cdof × rel over the slot's chain dofs
// (the chain mask, ±1 or 0: static (K, nv), or per env (B, K, nv) after
// the step's top-k contact selection, the TPU kernel's
// `dmask_static=False` branch); the condim-6 pyramid Newton
// solve factorized on those base rows (Cholesky of M, diag(J M⁻¹ Jᵀ) and
// the Gram cross terms from y = L⁻¹ Jᵀ, D and aref from the impedance,
// then `niter` iterations of active set, gradient, H = M + Jᵀ Da J,
// Cholesky, search direction and the line search on the grid
// {0} ∪ logspace(-3, log10 4, 15) with sign-crossing interpolation); the
// per-slot normal force; qfrc_constraint = Jᵀ f; and the Euler update
// (M + h diag(damping)) dv = h (qfrc_smooth + qfrc_c). Constants as in
// the TPU kernel: Cholesky clamp 1e-12, 1e-9 norm guard, 1e-10 on
// diag(J M⁻¹ Jᵀ), 1e-4 / 1e-6 in D.
//
// What bounds it on the H100: at B = 1024 on stand states it moves
// ~6.4 MB of inputs and outputs and the algorithm needs ~0.26 MFLOP per
// env (chip_smoke.solve_cost counts it from the twin's active sets), so
// the card's bound is ~4 us, set by operations. What bounds this kernel
// is the serial chain inside one environment: 10 Cholesky factorizations
// of 18 columns and 9 pairs of 18-step triangular solves, each step a
// shuffle, a reciprocal square root and a shared-memory round trip that
// the next step waits for (~400 cycles a column), and around them ~30
// passes over slots, dofs or matrix entries whose shared-memory loads
// the 8 warps of an SM barely hide (tools/solver_phases.py prints the
// cycles of each phase).
//
// What the design does about it (the earlier one-thread-per-env kernel
// put 8 blocks on 132 SMs and kept every intermediate in global scratch):
// - one warp per env, `envs` warps per block (4 on the humanoid), so
//   B = 1024 is 1024 warps over all SMs, all resident at once (2 blocks
//   of ~107 KB per SM);
// - the env's working set lives in dynamic shared memory, carved by
//   `make_layout` (mirrored by fused_solver.solver_smem_bytes): M, the
//   factor / Hessian, the six base rows of every slot compressed over
//   its chain dofs (6 x 376 floats on the humanoid), D, aref and the
//   residuals of the 670 pyramid edges, and a work area for L⁻¹, the
//   active slots' coefficients and the line search's J p. Inputs are
//   read from the batch-last arrays once; nothing per env is left in
//   global memory;
// - lanes spread each phase: over slots for the rows, the Gram terms, the
//   residuals and the active set (compacted in slot order with
//   __ballot_sync); over dofs for the gradient; over the lower-triangle
//   entries of H, each lane holding its entries in registers while the
//   active slots stream past; over the rows of a column for the Cholesky
//   and the solves (common.cuh warp_chol / warp_chol_solve); over
//   (edge, grid point) pairs for the line search, two edges at a time;
// - L⁻¹ is formed once (warp_tri_inv, a lane per column), so that each
//   slot's y = L⁻¹ Jᵀ over its ≤ 9 chain dofs is a sum of independent
//   products, six rows at once, instead of a dependent substitution; the
//   explicit M⁻¹ columns of the earlier kernel are gone;
// - every sum runs in a fixed order (slot order, then a fixed warp
//   butterfly), with no atomics, so two launches on the same inputs give
//   the same bits, and plans and the simulation see the same arithmetic;
// - fp32 on the CUDA cores: the matrices are 18 x 18 per env, far below a
//   tensor-core tile, and TF32 would keep ~3 digits where the solve
//   needs fp32;
// - a NaN input stays NaN (`mx` keeps it, and a slot with a NaN residual
//   counts as touched, as the twin's Da r does; a non-finite qvel or
//   smooth force makes the env's smooth force NaN at load, since the
//   sparse chains would skip a dof on no slot's chain), so the step's
//   divergence guard sees a diverged env; other envs are untouched.
//
// The per-env mask (template flag PE). The static path reads the mask
// compressed on the host (slot offsets, chain dofs, signs) into tables
// every warp of a block shares. A per-env mask (K, nv) per env arrives
// dense and batch-last like the other contact inputs; the warp compacts
// its env's chains into the same three tables in its own region of
// shared memory, slot by slot: lanes over dofs, a ballot of the nonzero
// entries, positions by prefix counts, in ascending dof order, so that
// every later phase runs the static path's code on them (a per-env
// launch on a broadcast static mask gives the static launch's bits).
// The region holds C chain entries, a bound the host computes once per
// model: the sum of its K longest slot chains, so any K of its slots
// fit. An env whose mask exceeds it gets empty chains and a NaN smooth
// force (the divergence guard flags it) instead of overrunning.
//
// nv above 32 (template parameter R): R = 2 matrix rows per lane in the
// Cholesky, the solves and L⁻¹ (common.cuh `chol<R>`, `chol_solve<R>`,
// `tri_inv<R>`, as kernel B3), the per-dof phases loop over a lane's R
// dofs, and H's lower triangle is summed in passes of 544 entries (17 a
// lane in registers, as at R = 1), the active slots streamed once a
// pass: two passes at nv 36, four at the cap of 64. R = 1 keeps one pass
// and the arithmetic of the nv <= 32 kernel.

#include "common.cuh"

using namespace hm;

namespace {

constexpr int LS_MAX = 16;  // capacity of the line-search grid
constexpr int NV_MAX = 64;  // two matrix rows per lane above 32 dofs
// lower-triangle entries of H a lane holds in registers in one pass over
// the active slots: one pass covers nv <= 32, R = 2 takes up to four
constexpr int TRI_LANE = (32 * 33 / 2 + 31) / 32;
constexpr int TRI_PASS = 32 * TRI_LANE;
constexpr int ENVS_MAX = 8;  // warps per block
constexpr int NCO = 17;     // gradient / Hessian coefficients of a slot
// offsets within one active slot's NCO coefficients
constexpr int CO_Y0 = 0, CO_Z = 1, CO_C0 = 6, CO_CI = 7, CO_CII = 12;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Dynamic shared memory of one block: the static tables (with a static
// mask: slot offsets into the compressed rows, each compressed entry's
// dof, each (slot, dof) position in its slot's chain or -1; always the
// lower-triangle (u, w) pairs), then one region of `env` floats per
// warp. With a per-env mask (`pe`) the first three tables and the chain
// signs live in the env's region instead, C entries long (the model's
// bound on any K slots' chains).
struct Layout {
  int ld;           // row stride of the nv x nv matrices (odd)
  int ntri;         // lower-triangle entries
  int dof_at, pos_at, tri_at, table_bytes;  // byte offsets of the tables
  int Mm, H, Jb, De, ar, re, mu, W, Dl, al, rl, vec, act;  // floats
  int sg, so, sd, sp, env;  // the per-env chain tables, floats
};

__host__ __device__ inline Layout make_layout(int nv, int K, int nlim, int C,
                                              bool pe) {
  Layout L;
  L.ld = nv | 1;
  L.ntri = nv * (nv + 1) / 2;
  L.dof_at = pe ? 0 : 4 * (K + 1);
  L.pos_at = L.dof_at + (pe ? 0 : C);
  L.tri_at = round_up(L.pos_at + (pe ? 0 : K * nv), 2);
  L.table_bytes = round_up(L.tri_at + 2 * L.ntri, 16);
  int o = 0;
  L.Mm = o;
  o += nv * L.ld;
  L.H = o;
  o += nv * L.ld;
  L.Jb = o;
  o += 6 * C;
  L.De = o;
  o += 10 * K;
  L.ar = o;
  o += 10 * K;
  L.re = o;
  o += 10 * K;
  L.mu = o;
  o += 3 * K;
  int w = NCO * K;                        // active slots' coefficients
  if (10 * K + nlim > w) w = 10 * K + nlim;  // the line search's J p
  if (nv * L.ld > w) w = nv * L.ld;       // L⁻¹ of M in the setup
  if (6 * nv > w) w = 6 * nv;             // cdof while the rows are built
  L.W = o;
  o += w;
  L.Dl = o;
  o += nlim;
  L.al = o;
  o += nlim;
  L.rl = o;
  o += nlim;
  L.vec = o;
  o += 6 * nv;
  L.act = o;
  o += K;
  L.sg = L.so = L.sd = L.sp = o;
  if (pe) {
    L.sg = o;  // chain signs
    o += C;
    L.so = o;  // slot offsets
    o += K + 1;
    L.sd = o;  // chain dofs, bytes
    o += (C + 3) / 4;
    L.sp = o;  // (slot, dof) positions, bytes
    o += (K * nv + 3) / 4;
  }
  L.env = round_up(o, 4);
  return L;
}

struct SolveArgs {
  const float *M, *qf, *qv, *cdof, *rel, *nrm, *dist, *mu3, *kc, *bc, *dc,
      *lpos, *kl, *bl, *dl, *hd, *dt;
  // the static mask compressed (ptr, dof, sign), or the per-env mask
  // (K, nv) batch-last
  const int *slot_ptr, *slot_dof;
  const float *slot_sgn, *dmask;
  // limit rows: CSR (ptr, dof, coef) with each entry's row, and the
  // Hessian's pairs of entries of one row, dof_k <= dof_i: the lower-
  // triangle index of (dof_i, dof_k), the row and c_i c_k
  const int *lim_ptr, *lim_dof, *lim_row;
  const float* lim_coef;
  const int *pair_tri, *pair_row;
  const float *pair_coef, *grid;
  float *qacc, *qvn, *fslot, *qfc;
  int B, nv, K, nlim, C, npair, niter, nls, envs;
};

// R matrix rows per lane in the factorizations and solves (1: nv <= 32,
// 2: nv <= 64); PE: a per-env mask, compacted by the warp
template <int R, bool PE>
__global__ void __launch_bounds__(32 * ENVS_MAX)
    solve_kernel(SolveArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, nv = a.nv, K = a.K, nlim = a.nlim, C = a.C;
  const Layout lay = make_layout(nv, K, nlim, C, PE);
  const int ld = lay.ld;
  int* soff = reinterpret_cast<int*>(smem);
  unsigned char* sdof = smem + lay.dof_at;
  signed char* spos = reinterpret_cast<signed char*>(smem + lay.pos_at);
  unsigned short* tri =
      reinterpret_cast<unsigned short*>(smem + lay.tri_at);

  // ---- the block's static tables ----
  if constexpr (!PE) {
    for (int i = threadIdx.x; i <= K; i += blockDim.x)
      soff[i] = __ldg(a.slot_ptr + i);
    for (int i = threadIdx.x; i < C; i += blockDim.x)
      sdof[i] = (unsigned char)__ldg(a.slot_dof + i);
    for (int i = threadIdx.x; i < K * nv; i += blockDim.x) spos[i] = -1;
  }
  for (int t = threadIdx.x; t < lay.ntri; t += blockDim.x) {
    int u = 0;
    while ((u + 1) * (u + 2) / 2 <= t) ++u;
    tri[t] = (unsigned short)((u << 8) | (t - u * (u + 1) / 2));
  }
  __syncthreads();
  if constexpr (!PE) {
    for (int c = threadIdx.x; c < K; c += blockDim.x)
      for (int j = soff[c]; j < soff[c + 1]; ++j)
        spos[c * nv + sdof[j]] = (signed char)(j - soff[c]);
  }
  __syncthreads();

  const int wid = threadIdx.x >> 5, lane = lane_id();
  const int e = blockIdx.x * a.envs + wid;
  if (e >= B) return;  // the ragged last block; no block barrier follows

  float* S = reinterpret_cast<float*>(smem + lay.table_bytes) + wid * lay.env;
  float *Mm = S + lay.Mm, *H = S + lay.H, *Jb = S + lay.Jb,
        *De = S + lay.De, *ar = S + lay.ar, *re = S + lay.re,
        *mu = S + lay.mu, *W = S + lay.W, *Dl = S + lay.Dl,
        *al = S + lay.al, *rl = S + lay.rl;
  float *AS = S + lay.vec, *X = AS + nv, *P = AS + 2 * nv,
        *QV = AS + 3 * nv, *QF = AS + 4 * nv, *INV = AS + 5 * nv;
  int* act = reinterpret_cast<int*>(S + lay.act);
  float* sg = S + lay.sg;
  if constexpr (PE) {
    soff = reinterpret_cast<int*>(S + lay.so);
    sdof = reinterpret_cast<unsigned char*>(S + lay.sd);
    spos = reinterpret_cast<signed char*>(S + lay.sp);
  }
  const int* lim_ptr = a.lim_ptr;
  const int* lim_dof = a.lim_dof;
  const float* lim_coef = a.lim_coef;
  const int nnz = __ldg(lim_ptr + nlim);
  auto in = [&](const float* p, int i) { return __ldg(p + (size_t)i * B + e); };
  const unsigned below = (1u << lane) - 1u;

  // b[a] = J_a(slot c) · x for the six base rows, over the chain dofs in
  // ascending order
  auto dots = [&](int c, const float* x, float b[6]) {
#pragma unroll
    for (int r = 0; r < 6; ++r) b[r] = 0.0f;
    for (int j = soff[c]; j < soff[c + 1]; ++j) {
      const float xv = x[sdof[j]];
#pragma unroll
      for (int r = 0; r < 6; ++r) b[r] += Jb[r * C + j] * xv;
    }
  };
  auto mu5 = [&](int c, float m[5]) {
    m[0] = m[1] = mu[c];
    m[2] = mu[K + c];
    m[3] = m[4] = mu[2 * K + c];
  };

  // ---- load the env's inputs once ----
  for (int i = lane; i < nv * nv; i += 32) {
    const float v = in(a.M, i);
    Mm[(i / nv) * ld + i % nv] = v;
    H[(i / nv) * ld + i % nv] = v;
  }
  for (int i = lane; i < 6 * nv; i += 32) W[i] = in(a.cdof, i);
  for (int v = lane; v < nv; v += 32) {
    QV[v] = in(a.qv, v);
    QF[v] = in(a.qf, v);
  }
  for (int i = lane; i < 3 * K; i += 32) mu[i] = in(a.mu3, i);
  {
    // a non-finite qvel or smooth force poisons the whole env (as the
    // twin's dense products do), also where the bad dof is on no slot's
    // chain and no limit row: its qacc turns NaN, so the step flags it
    bool bad = false;
    for (int v = lane; v < nv; v += 32)
      bad |= !(isfinite(QV[v]) && isfinite(QF[v]));
    if (__ballot_sync(FULL_MASK, bad))
      for (int v = lane; v < nv; v += 32) QF[v] = __int_as_float(0x7fc00000);
  }
  if constexpr (PE) {
    // the env's slot chains from its mask, slot by slot: lanes over dofs
    // (R a lane), a ballot of the nonzero entries, their positions by
    // prefix counts in ascending dof order, as the static layout. An env
    // whose chains exceed the C entries sized for it (a mask that is not
    // K slots of the model's) gets empty chains and a NaN smooth force,
    // so that the step's divergence guard flags it.
    int off = 0;
    for (int c = 0; c < K; ++c) {
      const int start = off;
      if (lane == 0) soff[c] = start;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int v = lane + 32 * q;
        const float mv = v < nv ? in(a.dmask, c * nv + v) : 0.0f;
        const unsigned bits = __ballot_sync(FULL_MASK, mv != 0.0f);
        const int pos = off + __popc(bits & below);
        if (v < nv)
          spos[c * nv + v] = mv != 0.0f ? (signed char)(pos - start) : -1;
        if (mv != 0.0f && pos < C) {
          sdof[pos] = (unsigned char)v;
          sg[pos] = mv;
        }
        off += __popc(bits);
      }
    }
    if (off > C) {
      for (int i = lane; i < K * nv; i += 32) spos[i] = -1;
      for (int c = lane; c < K; c += 32) soff[c] = 0;
      for (int v = lane; v < nv; v += 32) QF[v] = __int_as_float(0x7fc00000);
      off = 0;
    }
    if (lane == 0) soff[K] = off;
  }
  __syncwarp();

  // ---- lanes over slots: tangent frame and the six base rows ----
  for (int c = lane; c < K; c += 32) {
    const V3 n{in(a.nrm, c), in(a.nrm, K + c), in(a.nrm, 2 * K + c)};
    const V3 r{in(a.rel, c), in(a.rel, K + c), in(a.rel, 2 * K + c)};
    const bool up = fabsf(n.z) > 0.9f;
    const float rx = up ? 1.0f : 0.0f, rz = up ? 0.0f : 1.0f;
    V3 t1{-rz * n.y, rz * n.x - rx * n.z, rx * n.y};
    t1 = t1 * (1.0f / mx(sqrtf(dot(t1, t1)), 1e-9f));
    const V3 t2 = cross(n, t1);
    for (int j = soff[c]; j < soff[c + 1]; ++j) {
      const int v = sdof[j];
      const float s = PE ? sg[j] : __ldg(a.slot_sgn + j);
      const V3 w{W[6 * v], W[6 * v + 1], W[6 * v + 2]};
      const V3 l{W[6 * v + 3], W[6 * v + 4], W[6 * v + 5]};
      // point jacobian: cdof_lin + cdof_ang × rel, signed by the chain
      const V3 jp = (l + cross(w, r)) * s;
      const V3 ja = w * s;
      Jb[j] = dot(jp, n);
      Jb[C + j] = dot(jp, t1);
      Jb[2 * C + j] = dot(jp, t2);
      Jb[3 * C + j] = dot(ja, n);
      Jb[4 * C + j] = dot(ja, t1);
      Jb[5 * C + j] = dot(ja, t2);
    }
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
  float* Li = W;
  tri_inv<R>(H, INV, nv, ld, Li);

  // ---- lanes over slots: Gram terms by y = L⁻¹ Jᵀ, then D and aref ----
  // y_r(k) = sum over the chain dofs v <= k of L⁻¹(k, v) J_r(v): for all
  // six base rows at once, so |y_0|², y_0 · y_i and |y_i|² accumulate
  // row by row
  for (int c = lane; c < K; c += 32) {
    const int j0 = soff[c], j1 = soff[c + 1];
    const int k0 = j1 > j0 ? sdof[j0] : nv;
    float Ann = 0.0f, Ant[5] = {0.0f}, Att[5] = {0.0f};
    for (int k = k0; k < nv; ++k) {
      float y[6] = {0.0f};
      for (int j = j0; j < j1 && sdof[j] <= k; ++j) {
        const float li = Li[k * ld + sdof[j]];
#pragma unroll
        for (int r = 0; r < 6; ++r) y[r] += li * Jb[r * C + j];
      }
      Ann += y[0] * y[0];
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        Ant[i] += y[0] * y[i + 1];
        Att[i] += y[i + 1] * y[i + 1];
      }
    }
    float bq[6], m[5];
    dots(c, QV, bq);
    mu5(c, m);
    const float d = in(a.dc, c);
    const float Rf = fmaxf((1.0f - d) / fmaxf(d, 1e-4f), 1e-6f);
    const float kdp = in(a.kc, c) * d * in(a.dist, c), b = in(a.bc, c);
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const float cr = 2.0f * m[i] * Ant[i];
      const float qd = m[i] * m[i] * Att[i];
      const float mt = m[i] * bq[i + 1];
      De[(2 * i) * K + c] = 1.0f / (Rf * mx(Ann + cr + qd, 1e-10f));
      De[(2 * i + 1) * K + c] = 1.0f / (Rf * mx(Ann - cr + qd, 1e-10f));
      ar[(2 * i) * K + c] = -b * (bq[0] + mt) - kdp;
      ar[(2 * i + 1) * K + c] = -b * (bq[0] - mt) - kdp;
    }
  }
  // limit rows: static sparse Jacobians, diag by the same product
  for (int l = lane; l < nlim; l += 32) {
    const int i0 = __ldg(lim_ptr + l), i1 = __ldg(lim_ptr + l + 1);
    float jv = 0.0f, diag = 0.0f;
    for (int i = i0; i < i1; ++i)
      jv += __ldg(lim_coef + i) * QV[__ldg(lim_dof + i)];
    for (int k = 0; k < nv; ++k) {
      float y = 0.0f;
      for (int i = i0; i < i1; ++i) {
        const int u = __ldg(lim_dof + i);
        if (u <= k) y += Li[k * ld + u] * __ldg(lim_coef + i);
      }
      diag += y * y;
    }
    const float d = in(a.dl, l);
    const float Rf = fmaxf((1.0f - d) / fmaxf(d, 1e-4f), 1e-6f);
    Dl[l] = 1.0f / (Rf * mx(diag, 1e-10f));
    al[l] = -in(a.bl, l) * jv - in(a.kl, l) * d * in(a.lpos, l);
  }
  __syncwarp();

  // line-search lanes: two edges at a time (half), 16 grid points (t)
  const int t = lane & 15, half = lane >> 4;
  const int nls = a.nls;
  const float gt = __ldg(a.grid + min(t, nls - 1));
  const float gnext = __shfl_sync(FULL_MASK, gt, (lane + 1) & 31);
  // r + t jp is linear in t: a row is active somewhere on the grid iff it
  // is at t = 0 or at the last grid point
  const float tmax = __ldg(a.grid + nls - 1);
  // H's lower triangle in passes of TRI_PASS entries (one when R = 1)
  const int npass = R == 1 ? 1 : (lay.ntri + TRI_PASS - 1) / TRI_PASS;

  // ---- Newton iterations ----
  for (int it = 0; it < a.niter; ++it) {
    // lanes over slots: residuals, active set, per-slot coefficients
    int nact = 0;
    for (int base = 0; base < K; base += 32) {
      const int c = base + lane;
      bool touched = false;
      float co[NCO];
      if (c < K) {
        float bx[6], m[5], Da[10], y[10];
        dots(c, X, bx);
        mu5(c, m);
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          const float mt = m[i] * bx[i + 1];
          const float r0 = bx[0] + mt - ar[(2 * i) * K + c];
          const float r1 = bx[0] - mt - ar[(2 * i + 1) * K + c];
          re[(2 * i) * K + c] = r0;
          re[(2 * i + 1) * K + c] = r1;
          Da[2 * i] = r0 < 0.0f ? De[(2 * i) * K + c] : 0.0f;
          Da[2 * i + 1] = r1 < 0.0f ? De[(2 * i + 1) * K + c] : 0.0f;
          y[2 * i] = Da[2 * i] * r0;
          y[2 * i + 1] = Da[2 * i + 1] * r1;
          // a NaN residual counts: its Da r is NaN, as in the twin
          touched |= !(r0 >= 0.0f) || !(r1 >= 0.0f);
        }
        if (touched) {
          float Y0 = 0.0f, c0 = 0.0f;
#pragma unroll
          for (int k = 0; k < 10; ++k) {
            Y0 += y[k];
            c0 += Da[k];
          }
          co[CO_Y0] = Y0;
          co[CO_C0] = c0;
#pragma unroll
          for (int i = 0; i < 5; ++i) {
            co[CO_Z + i] = m[i] * (y[2 * i] - y[2 * i + 1]);
            co[CO_CI + i] = m[i] * (Da[2 * i] - Da[2 * i + 1]);
            co[CO_CII + i] = m[i] * m[i] * (Da[2 * i] + Da[2 * i + 1]);
          }
        }
      }
      const unsigned mask = __ballot_sync(FULL_MASK, touched);
      if (touched) {
        const int j = nact + __popc(mask & below);
        act[j] = c;
#pragma unroll
        for (int q = 0; q < NCO; ++q) W[j * NCO + q] = co[q];
      }
      nact += __popc(mask);
    }
    for (int l = lane; l < nlim; l += 32) {
      float s = 0.0f;
      for (int i = __ldg(lim_ptr + l); i < __ldg(lim_ptr + l + 1); ++i)
        s += __ldg(lim_coef + i) * X[__ldg(lim_dof + i)];
      rl[l] = s - al[l];
    }
    __syncwarp();

    // lanes over dofs: M (x - a_smooth) and the gradient, in registers.
    // The slot loops are branch-free (a slot off the dof's chain reads
    // its first entry and adds nothing), so that the loads of several
    // slots are in flight at once; the sums stay in slot order.
    float mxu[R], gu[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int u = lane + 32 * q;
      mxu[q] = gu[q] = 0.0f;
      if (u < nv) {
        float mq = 0.0f;
        for (int v = 0; v < nv; ++v) mq += Mm[u * ld + v] * (X[v] - AS[v]);
        float g = mq;
#pragma unroll 4
        for (int j = 0; j < nact; ++j) {
          const int c = act[j];
          const int p = spos[c * nv + u];
          const float* co = W + j * NCO;
          const int o = soff[c] + max(p, 0);
          float s = Jb[o] * co[CO_Y0];
#pragma unroll
          for (int i = 0; i < 5; ++i) s += Jb[(i + 1) * C + o] * co[CO_Z + i];
          if (p >= 0) g += s;
        }
        for (int i = 0; i < nnz; ++i) {
          const int l = __ldg(a.lim_row + i);
          const float r = rl[l];
          if (__ldg(lim_dof + i) == u && r < 0.0f)
            g += __ldg(lim_coef + i) * Dl[l] * r;
        }
        mxu[q] = mq;
        gu[q] = g;
      }
    }
    // H = M + Jᵀ Da J, lanes over the lower triangle: in each pass lane l
    // holds entries l, l + 32, ... of the pass in registers and takes the
    // active slots in order, so that a slot's coefficients are read once
    // a pass; then the limit rows
    for (int pass = 0; pass < npass; ++pass) {
      const int t0 = pass * TRI_PASS;
      const int nr = (lay.ntri - t0 - lane + 31) / 32;
      float hacc[TRI_LANE];
#pragma unroll
      for (int r = 0; r < TRI_LANE; ++r) {
        if (r < nr) {
          const int tt = t0 + lane + 32 * r;
          hacc[r] = Mm[(tri[tt] >> 8) * ld + (tri[tt] & 255)];
        }
      }
      for (int j = 0; j < nact; ++j) {
        const int c = act[j];
        const float* co = W + j * NCO;
        const signed char* pc = spos + c * nv;
        const int o = soff[c];
        float ci[5], cii[5];
        const float c0 = co[CO_C0];
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          ci[i] = co[CO_CI + i];
          cii[i] = co[CO_CII + i];
        }
#pragma unroll
        for (int r = 0; r < TRI_LANE; ++r) {
          if (r >= nr) break;
          const int tt = t0 + lane + 32 * r;
          const int qu = pc[tri[tt] >> 8], qw = pc[tri[tt] & 255];
          if ((qu | qw) < 0) continue;
          const int ou = o + qu, ow = o + qw;
          const float jnw = Jb[ow];
          float jtw[5];
          float P0 = c0 * jnw;
#pragma unroll
          for (int i = 0; i < 5; ++i) {
            jtw[i] = Jb[(i + 1) * C + ow];
            P0 += ci[i] * jtw[i];
          }
          float hh = Jb[ou] * P0;
#pragma unroll
          for (int i = 0; i < 5; ++i)
            hh += Jb[(i + 1) * C + ou] * (ci[i] * jnw + cii[i] * jtw[i]);
          hacc[r] += hh;
        }
      }
#pragma unroll
      for (int r = 0; r < TRI_LANE; ++r) {
        if (r < nr) {
          const int tt = t0 + lane + 32 * r;
          H[(tri[tt] >> 8) * ld + (tri[tt] & 255)] = hacc[r];
        }
      }
    }
    for (int p = 0; p < a.npair; ++p) {
      const int tt = __ldg(a.pair_tri + p), l = __ldg(a.pair_row + p);
      if ((tt & 31) == lane && rl[l] < 0.0f)
        H[(tri[tt] >> 8) * ld + (tri[tt] & 255)] +=
            __ldg(a.pair_coef + p) * Dl[l];
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
    float mpu[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int u = lane + 32 * q;
      mpu[q] = 0.0f;
      if (u < nv)
        for (int v = 0; v < nv; ++v) mpu[q] += Mm[u * ld + v] * P[v];
    }
    float pmp = pu[0] * mpu[0], pmx = pu[0] * mxu[0];
#pragma unroll
    for (int q = 1; q < R; ++q) {
      pmp += pu[q] * mpu[q];
      pmx += pu[q] * mxu[q];
    }
    const float pMp = warp_sum(pmp), b0 = warp_sum(pmx);
    // lanes over slots: J p per edge, and the slots with an edge that is
    // active somewhere on the grid
    int nls_slots = 0;
    for (int base = 0; base < K; base += 32) {
      const int c = base + lane;
      bool any = false;
      if (c < K) {
        float bp[6], m[5];
        dots(c, P, bp);
        mu5(c, m);
#pragma unroll
        for (int k = 0; k < 10; ++k) {
          const float mt = m[k / 2] * bp[k / 2 + 1];
          const float jp = (k & 1) ? bp[0] - mt : bp[0] + mt;
          W[k * K + c] = jp;
          const float r = re[k * K + c];
          any |= !(r >= 0.0f && r + tmax * jp >= 0.0f);
        }
      }
      const unsigned mask = __ballot_sync(FULL_MASK, any);
      if (any) act[nls_slots + __popc(mask & below)] = c;
      nls_slots += __popc(mask);
    }
    for (int l = lane; l < nlim; l += 32) {
      float jp = 0.0f;
      for (int i = __ldg(lim_ptr + l); i < __ldg(lim_ptr + l + 1); ++i)
        jp += __ldg(lim_coef + i) * P[__ldg(lim_dof + i)];
      W[10 * K + l] = jp;
    }
    __syncwarp();
    // lanes over (edge, grid point): lane t of each half sums its edges
    float acc = 0.0f;
    for (int j = 0; j < nls_slots; ++j) {
      const int c = act[j];
      for (int k = half; k < 10; k += 2) {
        const float r = re[k * K + c], jp = W[k * K + c];
        if (r >= 0.0f && r + tmax * jp >= 0.0f) continue;  // never active
        const float DJ = De[k * K + c] * jp;
        acc += DJ * fminf(r + gt * jp, 0.0f);
      }
    }
    for (int l = half; l < nlim; l += 2) {
      const float r = rl[l], jp = W[10 * K + l];
      if (r >= 0.0f && r + tmax * jp >= 0.0f) continue;
      const float DJ = Dl[l] * jp;
      acc += DJ * fminf(r + gt * jp, 0.0f);
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
      if (u < nv) X[u] += alpha * P[u];
    }
    __syncwarp();
  }

  // ---- final forces, per-slot normal force, qfrc_constraint = Jᵀ f ----
  int nload = 0;
  for (int base = 0; base < K; base += 32) {
    const int c = base + lane;
    bool loaded = false;
    float fs = 0.0f, Z[5];
    if (c < K) {
      float bx[6], m[5], f[10];
      dots(c, X, bx);
      mu5(c, m);
#pragma unroll
      for (int k = 0; k < 10; ++k) {
        const float mt = m[k / 2] * bx[k / 2 + 1];
        const float r = ((k & 1) ? bx[0] - mt : bx[0] + mt) - ar[k * K + c];
        f[k] = r < 0.0f ? fmaxf(-De[k * K + c] * r, 0.0f) : 0.0f;
        fs += f[k];
      }
      a.fslot[(size_t)c * B + e] = fs;
      loaded = !(fs == 0.0f);
#pragma unroll
      for (int i = 0; i < 5; ++i) Z[i] = m[i] * (f[2 * i] - f[2 * i + 1]);
    }
    const unsigned mask = __ballot_sync(FULL_MASK, loaded);
    if (loaded) {
      const int j = nload + __popc(mask & below);
      act[j] = c;
      W[6 * j] = fs;
#pragma unroll
      for (int i = 0; i < 5; ++i) W[6 * j + 1 + i] = Z[i];
    }
    nload += __popc(mask);
  }
  for (int l = lane; l < nlim; l += 32) {
    float s = 0.0f;
    for (int i = __ldg(lim_ptr + l); i < __ldg(lim_ptr + l + 1); ++i)
      s += __ldg(lim_coef + i) * X[__ldg(lim_dof + i)];
    const float r = s - al[l];
    rl[l] = r < 0.0f ? fmaxf(-Dl[l] * r, 0.0f) : 0.0f;
  }
  __syncwarp();
  float qc[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int u = lane + 32 * q;
    qc[q] = 0.0f;
    if (u < nv) {
      float s_ = 0.0f;
      for (int j = 0; j < nload; ++j) {
        const int c = act[j];
        const int p = spos[c * nv + u];
        if (p < 0) continue;
        const int o = soff[c] + p;
        float s = Jb[o] * W[6 * j];
#pragma unroll
        for (int i = 0; i < 5; ++i) s += Jb[(i + 1) * C + o] * W[6 * j + 1 + i];
        s_ += s;
      }
      for (int l = 0; l < nlim; ++l)
        for (int i = __ldg(lim_ptr + l); i < __ldg(lim_ptr + l + 1); ++i)
          if (__ldg(lim_dof + i) == u) s_ += __ldg(lim_coef + i) * rl[l];
      qc[q] = s_;
      a.qfc[(size_t)u * B + e] = s_;
    }
  }

  // ---- implicit-damping Euler: (M + h diag(damping)) dv = h qfrc ----
  for (int tt = lane; tt < lay.ntri; tt += 32) {
    const int u = tri[tt] >> 8, w = tri[tt] & 255;
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
      a.qacc[(size_t)u * B + e] = X[u];
      a.qvn[(size_t)u * B + e] = QV[u] + h * dv[q];
    }
  }
}

const void* kernel_for(int nv, int pe) {
  if (nv <= 32)
    return pe ? (const void*)solve_kernel<1, true>
              : (const void*)solve_kernel<1, false>;
  return pe ? (const void*)solve_kernel<2, true>
            : (const void*)solve_kernel<2, false>;
}

int check_shape(int nv, int K, int nlim, int C, int nls, int envs, int pe,
                int smem) {
  if (nls < 2 || nls > LS_MAX || nv < 1 || nv > NV_MAX || envs < 1 ||
      envs > ENVS_MAX || K < 0 || nlim < 0 || C < 0 || (pe && C > K * nv))
    return (int)cudaErrorInvalidValue;
  const Layout lay = make_layout(nv, K, nlim, C, pe != 0);
  if (smem != lay.table_bytes + 4 * envs * lay.env)
    return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel_for(nv, pe), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// smem: dynamic shared memory of one block, fused_solver.
// solver_smem_bytes(nv, K, nlim, C, envs, per_env); checked against
// make_layout. per_env: dmask is the (K, nv) x B per-env mask and C the
// bound on one env's chain entries; else slot_ptr / slot_dof / slot_sgn
// are the static mask compressed, C its entries.
extern "C" int hm_solve(const float* M, const float* qf, const float* qv,
                        const float* cdof, const float* rel, const float* nrm,
                        const float* dist, const float* mu3, const float* kc,
                        const float* bc, const float* dc, const float* lpos,
                        const float* kl, const float* bl, const float* dl,
                        const float* hd, const float* dt, const int* slot_ptr,
                        const int* slot_dof, const float* slot_sgn,
                        const float* dmask, const int* lim_ptr,
                        const int* lim_dof, const int* lim_row,
                        const float* lim_coef, const int* pair_tri,
                        const int* pair_row, const float* pair_coef,
                        const float* grid, float* qacc, float* qvn,
                        float* fslot, float* qfc, int B, int nv, int K,
                        int nlim, int C, int npair, int niter, int nls,
                        int envs, int per_env, int smem, void* stream) {
  const int err = check_shape(nv, K, nlim, C, nls, envs, per_env, smem);
  if (err != 0) return err;
  if (B <= 0) return 0;
  SolveArgs a{M,        qf,       qv,       cdof,     rel,       nrm,
              dist,     mu3,      kc,       bc,       dc,        lpos,
              kl,       bl,       dl,       hd,       dt,        slot_ptr,
              slot_dof, slot_sgn, dmask,    lim_ptr,  lim_dof,   lim_row,
              lim_coef, pair_tri, pair_row, pair_coef, grid,     qacc,
              qvn,      fslot,    qfc,      B,        nv,        K,
              nlim,     C,        npair,    niter,    nls,       envs};
  const int blocks = (B + envs - 1) / envs;
  cudaStream_t s = (cudaStream_t)stream;
  if (nv <= 32) {
    if (per_env)
      solve_kernel<1, true><<<blocks, 32 * envs, smem, s>>>(a);
    else
      solve_kernel<1, false><<<blocks, 32 * envs, smem, s>>>(a);
  } else {
    if (per_env)
      solve_kernel<2, true><<<blocks, 32 * envs, smem, s>>>(a);
    else
      solve_kernel<2, false><<<blocks, 32 * envs, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// Occupancy of the kernel at this block shape: out[0] blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] registers per
// thread, out[2] local (spill) bytes per thread.
extern "C" int hm_solve_occupancy(int nv, int K, int nlim, int C, int envs,
                                  int per_env, int smem, int* out) {
  int err = check_shape(nv, K, nlim, C, LS_MAX, envs, per_env, smem);
  if (err != 0) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], kernel_for(nv, per_env), 32 * envs, smem);
  if (err != 0) return err;
  cudaFuncAttributes fa;
  err = (int)cudaFuncGetAttributes(&fa, kernel_for(nv, per_env));
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  return err;
}
