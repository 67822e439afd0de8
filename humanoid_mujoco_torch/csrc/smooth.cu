// Kernel B1: the smooth stage of one step of a model in the kernel family
// (free / hinge / slide joints, spheres on a heightfield), one warp per
// environment, the environment's working set in shared memory.
//
// Replaces the TPU kernel humanoid_mujoco_tpu/physics/pallas_smooth.py
// `_smooth_kernel` (launched by `smooth_batched`). Per environment it
// computes forward kinematics down the tree, the COMs and the spatial
// anchor, the cdof motion subspaces, the composite-rigid-body mass matrix
// (with armature), the RNEA bias (gravity trick, qacc = 0), actuation,
// passive springs and damping, optional per-body wrenches, sphere-vs-
// heightfield and sphere-sphere collision, the raw contact rows (rel,
// normal, dist, friction, k, b, d), the joint-limit row data and the
// StepInfo observables: the 22 outputs of fused_smooth.NAMES. The
// free-joint rotational spring is computed here too (the TPU kernel left
// it to XLA because Mosaic has no atan2).
//
// What bounds it on the H100: at B = 1024 on the humanoid it moves
// ~6.8 MB (each input read once, ~1,620 output floats per env written
// once) and does ~20 kFLOP per env, so the card's bound is ~2 us, set by
// bytes. What bounds this kernel is the dependent chain inside one
// environment: the tree is walked down (kinematics, velocities,
// accelerations) and up (composite inertias, forces) one depth level at
// a time, and every level waits on the one before it; between the walks
// lie passes over dofs, bodies, matrix entries and contact slots, each a
// few shared-memory round trips deep (tools/solver_phases.py prints the
// cycles of each phase).
//
// What the design does about it (the earlier one-thread-per-env kernel
// put 8 blocks of 128 threads on 132 SMs and kept every intermediate in
// batch-last global scratch):
// - one warp per env, `envs` warps per block (8 on the humanoid), so
//   B = 1024 is 1024 warps over all SMs, all resident at once;
// - the block stages the model's int table and the nine float parameter
//   packs (the heightfield among them) into shared memory once, and each
//   warp its env's inputs, all by asynchronous copies (cp.async), every
//   copy of a thread in flight at once; a pack with a nonzero env stride
//   is staged per env instead (the RL slice's per-env parameters: the
//   wrapper passes stride 0 for every pack today);
// - the env's working set lives in dynamic shared memory, carved by
//   `make_layout` (mirrored by fused_smooth.smooth_smem_bytes): its
//   inputs, every output staged in its batch-last order, and the
//   intermediates (joint anchors, inertias, composite inertias, body
//   velocities, accelerations and forces, cdof_dot, the CRB force of
//   each dof, sphere centres);
// - batch-first inputs (qpos, qvel, ctrl, xfrc) are read in place at
//   their strides, once each: the wrapper copies nothing;
// - lanes spread each phase: one depth level a round with lanes over
//   (body, component) for the kinematics and the four tree passes (the
//   host's level and child tables, read as 16-byte records per level
//   slot, joint and dof, so that a lane finds its body, parent, dofs,
//   children and joints in one or two loads instead of a chain of
//   lookups); lanes over dofs for cdof, cdof_dot,
//   the CRB force and qfrc_smooth; over bodies for COMs, inertias,
//   forces and observables; over the structurally nonzero lower-triangle
//   entries of M (a host list); over spheres, then floor slots and pair
//   slots apart (no divergence between the two), for collision; over
//   limit rows and actuators;
// - the outputs leave batch-last, as B2 reads them: after a block
//   barrier consecutive threads take consecutive envs of the block, so
//   8 envs fill a 32-byte sector per element (the env stride in shared
//   memory is 4 mod 32 floats, so those reads hit distinct banks);
// - fp32 on the CUDA cores: the matrices are 18 x 18 per env, far below
//   a tensor-core tile, and TF32 would keep ~3 digits;
// - every sum runs in a fixed order (a parent sums its children in the
//   table's order, the COM sums a fixed warp butterfly), with no
//   atomics, so two launches on the same inputs give the same bits; a
//   NaN input stays in its env (`mx` keeps it), whose warp touches no
//   other env's memory.

#include "common.cuh"

using namespace hm;

namespace {

constexpr int ENVS_MAX = 8;  // warps per block
constexpr int NPACK = 9;     // float parameter packs (fused_smooth._pack_params)
constexpr int NOUT = 12;     // output arrays (fused_smooth._smooth_launch_args)

enum { P_BODY = 0, P_JOINT, P_DOF, P_QSPR, P_ACT, P_SPH, P_SITE, P_MISC, P_HF };
enum {
  Y_M = 0, Y_QFS, Y_CDOF, Y_REL, Y_NRM, Y_MU3, Y_CKBD, Y_LIMD, Y_IPACK,
  Y_SITEX, Y_VEC6, Y_ACTF
};

// int-table layout, built by fused_smooth._int_table: the counts, then
// the offsets of the arrays, each a multiple of 4 ints (16 bytes) so that
// a record is one vector load. Records, per level slot (in level order):
// {body, parent, d0, d1, c0, c1, j0, j1} with the body's dofs at
// BDOF[d0:d1], its children at CH_IDX[c0:c1] and its joints at
// BODY_JIDX[j0:j1]; per joint {type, qadr, vadr, body}; per dof {joint,
// type, body, index in the joint, qadr, a0, a1, 0} with its actuators at
// DOF_AIDX[a0:a1]; per actuator {type, qadr, vadr, 0}; per limit row pair
// {joint, qadr}; per M entry (u << 16) | w.
enum {
  H_NQ = 0, H_NV, H_NU, H_NBODY, H_NJNT, H_NSPH, H_NPAIR, H_NSITE, H_NLIM,
  H_NHROW, H_NHCOL, H_HAS_FLOOR, H_K, H_NLVL, H_NMNZ,
  O_LVL_PTR = 16, O_LVL_REC, O_BDOF, O_CH_IDX, O_BODY_JIDX, O_JNT_REC,
  O_DOF_REC, O_DOF_AIDX, O_ACT_REC, O_SPH_BODY, O_SPH_FLOOR, O_PAIR_A,
  O_PAIR_B, O_SITE_BODY, O_LIM_REC, O_MNZ,
  HEADER = 48
};
enum { J_FREE = 0, J_SLIDE = 2, J_HINGE = 3 };
enum { A_MOTOR = 0 };

// pack strides (fused_smooth._pack_params)
constexpr int BP = 18;  // bodyp: pos3 quat4 ipos3 iquat4 inertia3 mass1
constexpr int JP = 10;  // jointp: pos3 axis3 stiffness1 range2 margin1
constexpr int AP = 7;   // actp: gear kp kv ctrlrange2 forcerange2
constexpr int SP = 7;   // sphp: pos3 radius friction3

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The sizes a launch needs (fused_smooth.smooth_dims).
struct Dims {
  int nq, nv, nu, nbody, njnt, nsph, npair, nsite, nlim, K, ntab;
  int psize[NPACK];    // floats per pack
  int pstride[NPACK];  // floats between two envs' packs (0: shared)
};

// The block's dynamic shared memory, offsets in floats: the int table,
// the shared packs, then `envs` env regions of `env` floats each.
struct Layout {
  int poff[NPACK];  // shared pack: from the block's start; per-env pack:
                    // within the env region
  int blk;          // floats before the first env region
  int q, v, c, xf;  // inputs: qpos, qvel, ctrl, the wrench per body
  int o[NOUT + 1];  // staged outputs, output k at o[k] .. o[k + 1]
  int xanc, inr, ic, cv, ca, cdd, fw, cen;
  int env;          // env stride, 4 mod 32
};

__host__ __device__ inline Layout make_layout(const Dims& d) {
  Layout L;
  int o = round_up(d.ntab, 4);
  for (int k = 0; k < NPACK; ++k) {
    L.poff[k] = o;
    if (d.pstride[k] == 0) o += d.psize[k];
  }
  L.blk = round_up(o, 4);
  o = 0;
  L.q = o;
  o += d.nq;
  L.v = o;
  o += d.nv;
  L.c = o;
  o += d.nu;
  L.xf = o;
  o += 6 * d.nbody;
  const int osz[NOUT] = {d.nv * d.nv, d.nv,     6 * d.nv,     3 * d.K,
                         3 * d.K,     3 * d.K,  4 * d.K,      4 * d.nlim,
                         13 * d.nbody, 3 * d.nsite, 6,        d.nu};
  for (int k = 0; k < NOUT; ++k) {
    L.o[k] = o;
    o += osz[k];
  }
  L.o[NOUT] = o;
  L.xanc = o;
  o += 3 * d.njnt;
  L.inr = o;
  o += 10 * d.nbody;
  L.ic = o;
  o += 10 * d.nbody;
  L.cv = o;
  o += 6 * d.nbody;
  L.ca = o;
  o += 6 * d.nbody;
  L.cdd = o;
  o += 6 * d.nv;
  L.fw = o;
  o += 6 * d.nv;
  L.cen = o;
  o += 3 * d.nsph;
  for (int k = 0; k < NPACK; ++k)
    if (d.pstride[k] != 0) {
      L.poff[k] = o;
      o += d.psize[k];
    }
  L.env = round_up(o + 28, 32) - 28;
  return L;
}

struct SmoothArgs {
  const float *qpos, *qvel, *ctrl, *xfrc;
  const float* pack[NPACK];
  const int* tab;
  float* out[NOUT];
  // the inputs' strides in floats, batch first
  int sq[2], sv[2], sc[2], sx[3];
  Dims d;
  Layout lay;
  int B, envs, has_xfrc;
};

struct S6 {
  V3 a, l;  // [angular; linear]
};

__device__ __forceinline__ S6 ld6(const float* v) {
  return {{v[0], v[1], v[2]}, {v[3], v[4], v[5]}};
}
__device__ __forceinline__ void put3(float* p, V3 a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}
__device__ __forceinline__ void put4(float* p, Q4 q) {
  p[0] = q.w;
  p[1] = q.x;
  p[2] = q.y;
  p[3] = q.z;
}
__device__ __forceinline__ void put6(float* p, S6 s) {
  put3(p, s.a);
  put3(p + 3, s.l);
}
__device__ __forceinline__ float dot6(S6 a, S6 b) {
  return dot(a.a, b.a) + dot(a.l, b.l);
}

// 10-component spatial inertia [A sym6 | h3 | m] applied to [w; v]
__device__ __forceinline__ S6 inert_apply(const float* I, S6 s) {
  const V3 w = s.a, v = s.l;
  const V3 h{I[6], I[7], I[8]};
  const V3 ang{I[0] * w.x + I[3] * w.y + I[4] * w.z,
               I[3] * w.x + I[1] * w.y + I[5] * w.z,
               I[4] * w.x + I[5] * w.y + I[2] * w.z};
  return {ang + cross(h, v), v * I[9] - cross(h, w)};
}

__device__ __forceinline__ S6 motion_cross(S6 v, S6 m) {
  return {cross(v.a, m.a), cross(v.l, m.a) + cross(v.a, m.l)};
}
__device__ __forceinline__ S6 force_cross(S6 v, S6 f) {
  return {cross(v.a, f.a) + cross(v.l, f.l), cross(v.a, f.l)};
}

struct HField {
  const float* H;  // in shared memory
  int nr, nc;
  float hx, hy, z0, cx, cy;
  // floor height at (x, y): an indexed 4-corner bilinear read, the same
  // value as collision.hfield_height's tent-weight sum (same clamp)
  __device__ float height(float x, float y) const {
    float gx = (x + hx) / (2.0f * hx) * (float)(nc - 1);
    float gy = (y + hy) / (2.0f * hy) * (float)(nr - 1);
    gx = fminf(fmaxf(gx, 0.0f), cx);
    gy = fminf(fmaxf(gy, 0.0f), cy);
    const int ix = min(max((int)floorf(gx), 0), nc - 2);
    const int iy = min(max((int)floorf(gy), 0), nr - 2);
    const float fx = gx - (float)ix, fy = gy - (float)iy;
    const float* r0 = H + iy * nc + ix;
    const float* r1 = r0 + nc;
    const float h0 = (1.0f - fx) * r0[0] + fx * r0[1];
    const float h1 = (1.0f - fx) * r1[0] + fx * r1[1];
    return z0 + (1.0f - fy) * h0 + fy * h1;
  }
};

__device__ __forceinline__ int4 rec4(const int* p) {
  return *reinterpret_cast<const int4*>(p);
}

__global__ void __launch_bounds__(32 * ENVS_MAX)
    smooth_kernel(const SmoothArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dims& d = a.d;
  const Layout& lay = a.lay;
  const int B = a.B, tid = threadIdx.x, nthr = blockDim.x;
  const int wid = tid >> 5, lane = lane_id();
  const int e0 = blockIdx.x * a.envs;
  const int e = e0 + wid;
  int* T = reinterpret_cast<int*>(smem);
  float* F0 = reinterpret_cast<float*>(smem);
  float* S = F0 + lay.blk + wid * lay.env;

  // ---- stage the block's table and shared packs, the env's inputs ----
  // asynchronous copies (cp.async), all of a thread's in flight at once
  for (int i = tid; i < d.ntab; i += nthr)
    cp_async4(F0 + i, reinterpret_cast<const float*>(a.tab) + i);
#pragma unroll
  for (int k = 0; k < NPACK; ++k)
    if (d.pstride[k] == 0)
      for (int i = tid; i < d.psize[k]; i += nthr)
        cp_async4(F0 + lay.poff[k] + i, a.pack[k] + i);
  if (e < B) {
    const size_t eb = (size_t)e;
#pragma unroll
    for (int k = 0; k < NPACK; ++k)
      if (d.pstride[k] != 0)
        for (int i = lane; i < d.psize[k]; i += 32)
          cp_async4(S + lay.poff[k] + i, a.pack[k] + eb * d.pstride[k] + i);
    for (int i = lane; i < d.nq; i += 32)
      cp_async4(S + lay.q + i, a.qpos + eb * a.sq[0] + (size_t)i * a.sq[1]);
    for (int i = lane; i < d.nv; i += 32)
      cp_async4(S + lay.v + i, a.qvel + eb * a.sv[0] + (size_t)i * a.sv[1]);
    for (int i = lane; i < d.nu; i += 32)
      cp_async4(S + lay.c + i, a.ctrl + eb * a.sc[0] + (size_t)i * a.sc[1]);
    if (a.has_xfrc)
      for (int i = lane; i < 6 * d.nbody; i += 32)
        cp_async4(S + lay.xf + i, a.xfrc + eb * a.sx[0] +
                                      (size_t)(i / 6) * a.sx[1] +
                                      (size_t)(i % 6) * a.sx[2]);
  }
  cp_async_wait();
  __syncthreads();

  if (e < B) {
    const int nv = d.nv, nu = d.nu, nbody = d.nbody, nsph = d.nsph,
              npair = d.npair, nsite = d.nsite, nlim = d.nlim, K = d.K;
    const int* lvl_ptr = T + T[O_LVL_PTR];
    const int* lvl_rec = T + T[O_LVL_REC];
    const int* bdof = T + T[O_BDOF];
    const int* ch_idx = T + T[O_CH_IDX];
    const int* body_jidx = T + T[O_BODY_JIDX];
    const int* jnt_rec = T + T[O_JNT_REC];
    const int* dof_rec = T + T[O_DOF_REC];
    const int* dof_aidx = T + T[O_DOF_AIDX];
    const int* act_rec = T + T[O_ACT_REC];
    const int* sph_body = T + T[O_SPH_BODY];
    const int* sph_floor = T + T[O_SPH_FLOOR];
    const int* pair_a = T + T[O_PAIR_A];
    const int* pair_b = T + T[O_PAIR_B];
    const int* site_body = T + T[O_SITE_BODY];
    const int* lim_rec = T + T[O_LIM_REC];
    const int* mnz = T + T[O_MNZ];
    const int nlvl = T[H_NLVL], nmnz = T[H_NMNZ];

    const float* P[NPACK];
#pragma unroll
    for (int k = 0; k < NPACK; ++k)
      P[k] = (d.pstride[k] != 0 ? S : F0) + lay.poff[k];
    const float *bodyp = P[P_BODY], *jointp = P[P_JOINT], *dofp = P[P_DOF],
                *qspr = P[P_QSPR], *actp = P[P_ACT], *sphp = P[P_SPH],
                *sitep = P[P_SITE], *misc = P[P_MISC];
    const V3 grav = ld3(misc, 0);
    const float so_tc = misc[9], so_dr = misc[10], so_dmin = misc[11],
                so_dmax = misc[12], so_w = misc[13];
    const float li_tc = misc[14], li_dr = misc[15], li_dmin = misc[16],
                li_dmax = misc[17], li_w = misc[18];
    const float dt = misc[19];

    const float *Q = S + lay.q, *V = S + lay.v, *C = S + lay.c;
    float* WS = S + lay.xf;
    float *yM = S + lay.o[Y_M], *yQF = S + lay.o[Y_QFS],
          *CD = S + lay.o[Y_CDOF], *yREL = S + lay.o[Y_REL],
          *yNRM = S + lay.o[Y_NRM], *yMU = S + lay.o[Y_MU3],
          *yCK = S + lay.o[Y_CKBD], *yLIM = S + lay.o[Y_LIMD],
          *IP = S + lay.o[Y_IPACK], *ySITE = S + lay.o[Y_SITEX],
          *yV6 = S + lay.o[Y_VEC6], *yACT = S + lay.o[Y_ACTF];
    float *XANC = S + lay.xanc, *INR = S + lay.inr, *IC = S + lay.ic,
          *CV = S + lay.cv, *CA = S + lay.ca, *CDD = S + lay.cdd,
          *FW = S + lay.fw, *CEN = S + lay.cen;
    // IP, per body (13): xpos 0-2, xquat 3-6, xipos 7-9, COM velocity
    // 10-12, the observables' pack, also read as the kinematics

    // ---- limit rows and actuator forces (from the inputs alone) ----
    for (int i = lane; i < nv * nv; i += 32) yM[i] = 0.0f;
    for (int r = lane; r < nlim; r += 32) {
      const int j = lim_rec[2 * (r >> 1)];
      const float q = Q[lim_rec[2 * (r >> 1) + 1]];
      const float* jp = jointp + j * JP;
      const float pos = (r & 1) ? jp[8] - jp[9] - q : q - jp[7] - jp[9];
      const float dd = impedance(-pos, li_dmin, li_dmax, li_w);
      float kk, bb;
      solref_kb(li_tc, li_dr, li_dmax, dd, dt, kk, bb);
      yLIM[r] = pos;
      yLIM[nlim + r] = kk;
      yLIM[2 * nlim + r] = bb;
      yLIM[3 * nlim + r] = dd;
    }
    for (int i = lane; i < nu; i += 32) {
      const int4 ar = rec4(act_rec + 4 * i);
      const float* ap = actp + i * AP;
      const float c = clipf(C[i], ap[3], ap[4]);
      const float force =
          ar.x == A_MOTOR ? c : ap[1] * (c - Q[ar.y]) - ap[2] * V[ar.z];
      yACT[i] = ap[0] * clipf(force, ap[5], ap[6]);
    }

    // ---- forward kinematics and COMs, one depth level a round ----
    float pm = 0.0f, px = 0.0f, py = 0.0f, pz = 0.0f;
    for (int L = 0; L < nlvl; ++L) {
      for (int i = lvl_ptr[L] + lane; i < lvl_ptr[L + 1]; i += 32) {
        const int4 r0 = rec4(lvl_rec + 8 * i), r1 = rec4(lvl_rec + 8 * i + 4);
        const int b = r0.x, p = r0.y;
        const float* bp = bodyp + b * BP;
        V3 pos = ld3(bp, 0);
        Q4 quat = ld4(bp, 3);
        if (p >= 0) {
          const Q4 qp = ld4(IP, 13 * p + 3);
          pos = ld3(IP, 13 * p) + qrot(qp, pos);
          quat = qmul(qp, quat);
        }
        for (int jj = r1.z; jj < r1.w; ++jj) {
          const int j = body_jidx[jj];
          const int4 jr = rec4(jnt_rec + 4 * j);
          const float* jp = jointp + j * JP;
          if (jr.x == J_FREE) {
            pos = ld3(Q, jr.y);
            quat = qnormalize(ld4(Q, jr.y + 3));
            put3(XANC + 3 * j, pos);
          } else {
            const V3 off = ld3(jp, 0), ax = ld3(jp, 3);
            const V3 aw = pos + qrot(quat, off);
            put3(XANC + 3 * j, aw);
            if (jr.x == J_HINGE) {
              float sh, ch;
              sincosf(0.5f * Q[jr.y], &sh, &ch);
              quat = qmul(quat, {ch, ax.x * sh, ax.y * sh, ax.z * sh});
              pos = aw - qrot(quat, off);
            } else {  // SLIDE
              pos = pos + qrot(quat, ax * Q[jr.y]);
            }
          }
        }
        const V3 xi = pos + qrot(quat, ld3(bp, 7));
        put3(IP + 13 * b, pos);
        put4(IP + 13 * b + 3, quat);
        put3(IP + 13 * b + 7, xi);
        const float mass = bp[17];
        pm += mass;
        px += xi.x * mass;
        py += xi.y * mass;
        pz += xi.z * mass;
      }
      __syncwarp();
    }
    const float inv_mass = 1.0f / fmaxf(warp_sum(pm), 1e-12f);
    const V3 anc = V3{warp_sum(px), warp_sum(py), warp_sum(pz)} * inv_mass;

    // ---- cdof, spatial inertias about the anchor ----
    for (int v = lane; v < nv; v += 32) {
      const int4 dr = rec4(dof_rec + 8 * v);  // joint, type, body, index
      const int j = dr.x, k = dr.w;
      const Q4 qb = ld4(IP, 13 * dr.z + 3);
      const V3 arm = anc - ld3(XANC, 3 * j);
      const V3 z{0.0f, 0.0f, 0.0f};
      S6 s;
      if (dr.y == J_FREE) {
        if (k < 3) {
          s = {z, {k == 0 ? 1.0f : 0.0f, k == 1 ? 1.0f : 0.0f,
                   k == 2 ? 1.0f : 0.0f}};
        } else {
          V3 c0, c1, c2;
          qcols(qb, c0, c1, c2);
          const V3 c = k == 3 ? c0 : (k == 4 ? c1 : c2);
          s = {c, cross(c, arm)};
        }
      } else {
        const V3 ax = qrot(qb, ld3(jointp, j * JP + 3));
        s = dr.y == J_HINGE ? S6{ax, cross(ax, arm)} : S6{z, ax};
      }
      put6(CD + 6 * v, s);
    }
    for (int b = lane; b < nbody; b += 32) {
      const float* bp = bodyp + b * BP;
      const float mass = bp[17];
      const V3 I3 = ld3(bp, 14);
      V3 r0, r1, r2;
      qcols(qmul(ld4(IP, 13 * b + 3), ld4(bp, 10)), r0, r1, r2);
      const V3 c = ld3(IP, 13 * b + 7) - anc;
      const float cc = dot(c, c);
      const float v10[10] = {
          I3.x * r0.x * r0.x + I3.y * r1.x * r1.x + I3.z * r2.x * r2.x +
              mass * (cc - c.x * c.x),
          I3.x * r0.y * r0.y + I3.y * r1.y * r1.y + I3.z * r2.y * r2.y +
              mass * (cc - c.y * c.y),
          I3.x * r0.z * r0.z + I3.y * r1.z * r1.z + I3.z * r2.z * r2.z +
              mass * (cc - c.z * c.z),
          I3.x * r0.x * r0.y + I3.y * r1.x * r1.y + I3.z * r2.x * r2.y -
              mass * c.x * c.y,
          I3.x * r0.x * r0.z + I3.y * r1.x * r1.z + I3.z * r2.x * r2.z -
              mass * c.x * c.z,
          I3.x * r0.y * r0.z + I3.y * r1.y * r1.z + I3.z * r2.y * r2.z -
              mass * c.y * c.z,
          mass * c.x, mass * c.y, mass * c.z, mass};
#pragma unroll
      for (int k = 0; k < 10; ++k) {
        INR[10 * b + k] = v10[k];
        IC[10 * b + k] = v10[k];
      }
    }
    __syncwarp();

    // ---- composite inertias up the tree, then M ----
    for (int L = nlvl - 2; L >= 0; --L) {
      const int i0 = lvl_ptr[L], n = 10 * (lvl_ptr[L + 1] - i0);
      for (int t = lane; t < n; t += 32) {
        const int i = i0 + t / 10, k = t % 10;
        const int b = lvl_rec[8 * i];
        const int4 r1 = rec4(lvl_rec + 8 * i + 4);
        float s = IC[10 * b + k];
#pragma unroll 4
        for (int h = r1.x; h < r1.y; ++h) s += IC[10 * ch_idx[h] + k];
        IC[10 * b + k] = s;
      }
      __syncwarp();
    }
    for (int v = lane; v < nv; v += 32)
      put6(FW + 6 * v,
           inert_apply(IC + 10 * dof_rec[8 * v + 2], ld6(CD + 6 * v)));
    __syncwarp();
    // entry (u, w): u's body is w's or an ancestor of it, so
    // M_uw = cdof_u · Ic[body of w] cdof_w
    for (int t = lane; t < nmnz; t += 32) {
      const int u = mnz[t] >> 16, w = mnz[t] & 0xffff;
      float val = dot6(ld6(CD + 6 * u), ld6(FW + 6 * w));
      if (u == w) val += dofp[2 * u];
      yM[u * nv + w] = val;
      yM[w * nv + u] = val;
    }

    // ---- body velocities, cdof_dot, accelerations down the tree ----
    for (int L = 0; L < nlvl; ++L) {
      const int i0 = lvl_ptr[L], n = 6 * (lvl_ptr[L + 1] - i0);
      for (int t = lane; t < n; t += 32) {
        const int i = i0 + t / 6, k = t % 6;
        const int4 r0 = rec4(lvl_rec + 8 * i);
        float s = r0.y < 0 ? 0.0f : CV[6 * r0.y + k];
#pragma unroll 4
        for (int h = r0.z; h < r0.w; ++h) {
          const int v = bdof[h];
          s += CD[6 * v + k] * V[v];
        }
        CV[6 * r0.x + k] = s;
      }
      __syncwarp();
    }
    for (int v = lane; v < nv; v += 32) {
      const int4 dr = rec4(dof_rec + 8 * v);
      const S6 zero{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
      put6(CDD + 6 * v,
           dr.y == J_FREE && dr.w < 3
               ? zero
               : motion_cross(ld6(CV + 6 * dr.z), ld6(CD + 6 * v)));
    }
    __syncwarp();
    for (int L = 0; L < nlvl; ++L) {
      const int i0 = lvl_ptr[L], n = 6 * (lvl_ptr[L + 1] - i0);
      for (int t = lane; t < n; t += 32) {
        const int i = i0 + t / 6, k = t % 6;
        const int4 r0 = rec4(lvl_rec + 8 * i);
        float s = r0.y >= 0 ? CA[6 * r0.y + k]
                            : (k < 3 ? 0.0f
                                     : -(k == 3 ? grav.x
                                                : (k == 4 ? grav.y : grav.z)));
#pragma unroll 4
        for (int h = r0.z; h < r0.w; ++h) {
          const int v = bdof[h];
          s += CDD[6 * v + k] * V[v];
        }
        CA[6 * r0.x + k] = s;
      }
      __syncwarp();
    }

    // ---- body forces less the wrenches, up the tree; qfrc_smooth ----
    for (int b = lane; b < nbody; b += 32) {
      const float* I = INR + 10 * b;
      const S6 vb = ld6(CV + 6 * b);
      const S6 Iv = inert_apply(I, vb);
      const S6 fa = inert_apply(I, ld6(CA + 6 * b));
      const S6 fc = force_cross(vb, Iv);
      S6 f{fa.a + fc.a, fa.l + fc.l};
      if (a.has_xfrc) {
        const V3 f3 = ld3(WS, 6 * b), t3 = ld3(WS, 6 * b + 3);
        f.a = f.a - (t3 + cross(ld3(IP, 13 * b + 7) - anc, f3));
        f.l = f.l - f3;
      }
      put6(CA + 6 * b, f);
    }
    __syncwarp();
    for (int L = nlvl - 2; L >= 0; --L) {
      const int i0 = lvl_ptr[L], n = 6 * (lvl_ptr[L + 1] - i0);
      for (int t = lane; t < n; t += 32) {
        const int i = i0 + t / 6, k = t % 6;
        const int b = lvl_rec[8 * i];
        const int4 r1 = rec4(lvl_rec + 8 * i + 4);
        float s = CA[6 * b + k];
#pragma unroll 4
        for (int h = r1.x; h < r1.y; ++h) s += CA[6 * ch_idx[h] + k];
        CA[6 * b + k] = s;
      }
      __syncwarp();
    }
    for (int v = lane; v < nv; v += 32) {
      const int4 dr = rec4(dof_rec + 8 * v), d2 = rec4(dof_rec + 8 * v + 4);
      const int j = dr.x, k = dr.w, qa = d2.x;
      const float stiff = jointp[j * JP + 6];
      float f = -dofp[2 * v + 1] * V[v] -
                dot6(ld6(CD + 6 * v), ld6(CA + 6 * dr.z));
      for (int h = d2.y; h < d2.z; ++h) f += yACT[dof_aidx[h]];
      if (dr.y != J_FREE) {
        f -= stiff * (Q[qa] - qspr[qa]);
      } else if (k < 3) {
        f -= stiff * (Q[qa + k] - qspr[qa + k]);
      } else {
        // rotational spring: -k quat_sub(q, q_spring) = -k log(conj(qs) q)
        const Q4 qs = ld4(qspr, qa + 3);
        Q4 dq = qmul({qs.w, -qs.x, -qs.y, -qs.z}, ld4(Q, qa + 3));
        if (dq.w < 0.0f) dq = {-dq.w, -dq.x, -dq.y, -dq.z};
        const float w = clipf(dq.w, -1.0f, 1.0f);
        const float vn =
            sqrtf(dq.x * dq.x + dq.y * dq.y + dq.z * dq.z + 1e-20f);
        const float scale = 2.0f * atan2f(vn, w) / vn;
        f -= stiff * (k == 3 ? dq.x : (k == 4 ? dq.y : dq.z)) * scale;
      }
      yQF[v] = f;
    }

    // ---- collision: sphere centres, floor slots, pair slots ----
    for (int i = lane; i < nsph; i += 32) {
      const int b = sph_body[i];
      put3(CEN + 3 * i, ld3(IP, 13 * b) + qrot(ld4(IP, 13 * b + 3),
                                                ld3(sphp, i * SP)));
    }
    __syncwarp();
    auto slot = [&](int c, V3 pos, V3 n, float dist, float mus, float mut,
                    float mur) {
      const V3 r = pos - anc;
      yREL[c] = r.x;
      yREL[K + c] = r.y;
      yREL[2 * K + c] = r.z;
      yNRM[c] = n.x;
      yNRM[K + c] = n.y;
      yNRM[2 * K + c] = n.z;
      yMU[c] = mus;
      yMU[K + c] = mut;
      yMU[2 * K + c] = mur;
      const float dd = impedance(-dist, so_dmin, so_dmax, so_w);
      float kk, bb;
      solref_kb(so_tc, so_dr, so_dmax, dd, dt, kk, bb);
      yCK[c] = dist;
      yCK[K + c] = kk;
      yCK[2 * K + c] = bb;
      yCK[3 * K + c] = dd;
    };
    {
      const int nr = T[H_NHROW], nc = T[H_NHCOL];
      const HField hf{P[P_HF], nr, nc, misc[7], misc[8], misc[3],
                      (float)((double)nc - 1.000001),
                      (float)((double)nr - 1.000001)};
      const float eps = 1e-3f;
      const bool has_floor = T[H_HAS_FLOOR] != 0;
      for (int c = lane; c < nsph; c += 32) {
        const V3 ce = ld3(CEN, 3 * c);
        const float* sp = sphp + c * SP;
        if (has_floor) {
          const float h0 = hf.height(ce.x, ce.y);
          const float hpx = hf.height(ce.x + eps, ce.y);
          const float hmx = hf.height(ce.x - eps, ce.y);
          const float hpy = hf.height(ce.x, ce.y + eps);
          const float hmy = hf.height(ce.x, ce.y - eps);
          V3 n{-(hpx - hmx) / (2.0f * eps), -(hpy - hmy) / (2.0f * eps),
               1.0f};
          n = n * (1.0f / sqrtf(dot(n, n)));
          const float draw = ce.z - sp[3] - h0;
          slot(c, ce - n * (sp[3] + 0.5f * draw), n,
               sph_floor[c] ? draw : 1e9f, fmaxf(sp[4], misc[4]),
               fmaxf(sp[5], misc[5]), fmaxf(sp[6], misc[6]));
        } else {
          slot(c, ce, {0.0f, 0.0f, 1.0f}, 1e9f, sp[4], sp[5], sp[6]);
        }
      }
    }
    for (int i = lane; i < npair; i += 32) {
      const int ia = pair_a[i], ib = pair_b[i];
      const V3 ca = ld3(CEN, 3 * ia), delta = ld3(CEN, 3 * ib) - ca;
      const float dn = sqrtf(dot(delta, delta));
      const V3 n = delta * (1.0f / mx(dn, 1e-9f));
      const float* sa = sphp + ia * SP;
      const float* sb = sphp + ib * SP;
      const float dist = dn - (sa[3] + sb[3]);
      slot(nsph + i, ca + n * (sa[3] + 0.5f * dist), n, dist,
           fmaxf(sa[4], sb[4]), fmaxf(sa[5], sb[5]), fmaxf(sa[6], sb[6]));
    }

    // ---- observables: body COM velocities, sites, anchor, COM velocity ----
    float vx = 0.0f, vy = 0.0f, vz = 0.0f;
    for (int b = lane; b < nbody; b += 32) {
      const S6 vb = ld6(CV + 6 * b);
      const V3 bcv = vb.l + cross(vb.a, ld3(IP, 13 * b + 7) - anc);
      put3(IP + 13 * b + 10, bcv);
      const float mass = bodyp[b * BP + 17];
      vx += bcv.x * mass;
      vy += bcv.y * mass;
      vz += bcv.z * mass;
    }
    for (int i = lane; i < nsite; i += 32) {
      const int b = site_body[i];
      put3(ySITE + 3 * i, ld3(IP, 13 * b) + qrot(ld4(IP, 13 * b + 3),
                                                 ld3(sitep, 3 * i)));
    }
    const V3 com_vel =
        V3{warp_sum(vx), warp_sum(vy), warp_sum(vz)} * inv_mass;
    if (lane == 0) {
      put3(yV6, anc);
      put3(yV6 + 3, com_vel);
    }
  }
  __syncthreads();

  // ---- the staged outputs leave batch-last, the whole block at once ----
  {
    const int j = tid % a.envs, i0 = tid / a.envs, step = nthr / a.envs;
    if (e0 + j < B) {
      const float* src = F0 + lay.blk + j * lay.env;
#pragma unroll
      for (int k = 0; k < NOUT; ++k) {
        float* g = a.out[k] + e0 + j;
        const int o = lay.o[k], n = lay.o[k + 1] - o;
        for (int i = i0; i < n; i += step) g[(size_t)i * B] = src[o + i];
      }
    }
  }
}

// ---- host side: shapes, the launch and the occupancy query ----

// meta: fused_smooth._smooth_meta, an int32 host array (see there)
constexpr int META_PSIZE = HEADER, META_PSTRIDE = HEADER + NPACK,
              META_STRIDES = HEADER + 2 * NPACK, META_NTAB = META_STRIDES + 9,
              META_HAS_XFRC = META_NTAB + 1;

Dims dims_of(const int* meta) {
  Dims d;
  d.nq = meta[H_NQ];
  d.nv = meta[H_NV];
  d.nu = meta[H_NU];
  d.nbody = meta[H_NBODY];
  d.njnt = meta[H_NJNT];
  d.nsph = meta[H_NSPH];
  d.npair = meta[H_NPAIR];
  d.nsite = meta[H_NSITE];
  d.nlim = meta[H_NLIM];
  d.K = meta[H_K];
  d.ntab = meta[META_NTAB];
  for (int k = 0; k < NPACK; ++k) {
    d.psize[k] = meta[META_PSIZE + k];
    d.pstride[k] = meta[META_PSTRIDE + k];
  }
  return d;
}

int check_shape(const Dims& d, int envs, int smem) {
  if (envs < 1 || envs > ENVS_MAX || d.nv < 1 || d.nbody < 1 ||
      d.nv >= 32768 || d.K != d.nsph + d.npair)
    return (int)cudaErrorInvalidValue;
  const Layout lay = make_layout(d);
  if (smem != 4 * (lay.blk + envs * lay.env)) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      smooth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// Batch-first inputs qpos (B, nq), qvel (B, nv), ctrl (B, nu) and, when
// meta says so, xfrc (B, nbody, 6), read at the strides in meta; the nine
// packs (shared, or per env at the strides in meta); the int table; the
// twelve outputs batch-last, contiguous (M, qfrc_smooth, cdof, rel, nrm,
// mu3, the slot rows, the limit rows, the body observables, sites, anchor
// and COM velocity, actuator forces: fused_smooth._smooth_launch_args).
// smem: dynamic shared memory of one block, fused_smooth.smooth_smem_bytes;
// checked against make_layout.
extern "C" int hm_smooth(const float* qpos, const float* qvel,
                         const float* ctrl, const float* xfrc,
                         const float* bodyp, const float* jointp,
                         const float* dofp, const float* qspr,
                         const float* actp, const float* sphp,
                         const float* sitep, const float* misc,
                         const float* hf, const int* tab, float* M,
                         float* qfs, float* cdof, float* rel, float* nrm,
                         float* mu3, float* ckbd, float* limd, float* ipack,
                         float* sitex, float* vec6, float* actf,
                         const int* meta, int B, int envs, int smem,
                         void* stream) {
  SmoothArgs a;
  a.d = dims_of(meta);
  const int err = check_shape(a.d, envs, smem);
  if (err != 0) return err;
  if (B <= 0) return 0;
  a.lay = make_layout(a.d);
  a.qpos = qpos;
  a.qvel = qvel;
  a.ctrl = ctrl;
  a.xfrc = xfrc;
  const float* packs[NPACK] = {bodyp, jointp, dofp, qspr, actp,
                               sphp,  sitep,  misc, hf};
  float* outs[NOUT] = {M,    qfs,   cdof,  rel,   nrm,  mu3,
                       ckbd, limd,  ipack, sitex, vec6, actf};
  for (int k = 0; k < NPACK; ++k) a.pack[k] = packs[k];
  for (int k = 0; k < NOUT; ++k) a.out[k] = outs[k];
  a.tab = tab;
  const int* st = meta + META_STRIDES;
  a.sq[0] = st[0];
  a.sq[1] = st[1];
  a.sv[0] = st[2];
  a.sv[1] = st[3];
  a.sc[0] = st[4];
  a.sc[1] = st[5];
  a.sx[0] = st[6];
  a.sx[1] = st[7];
  a.sx[2] = st[8];
  a.B = B;
  a.envs = envs;
  a.has_xfrc = meta[META_HAS_XFRC];
  const int blocks = (B + envs - 1) / envs;
  smooth_kernel<<<blocks, 32 * envs, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Occupancy of the kernel at this block shape: out[0] blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] registers per
// thread, out[2] local (spill) bytes per thread.
extern "C" int hm_smooth_occupancy(const int* meta, int envs, int smem,
                                   int* out) {
  int err = check_shape(dims_of(meta), envs, smem);
  if (err != 0) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], smooth_kernel, 32 * envs, smem);
  if (err != 0) return err;
  cudaFuncAttributes fa;
  err = (int)cudaFuncGetAttributes(&fa, smooth_kernel);
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  return err;
}
