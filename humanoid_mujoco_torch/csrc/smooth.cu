// Kernel B1: the smooth stage of one humanoid step, one thread per env.
//
// Replaces the TPU kernel humanoid_mujoco_tpu/physics/pallas_smooth.py
// `_smooth_kernel` (launched by `smooth_batched`). Per environment it
// computes forward kinematics down the free/hinge/slide tree, the cdof
// motion subspaces, the composite-rigid-body mass matrix, the RNEA bias
// (gravity trick, qacc = 0), actuation, passive springs and damping,
// optional per-body wrenches, sphere-vs-heightfield and sphere-sphere
// collision, the raw contact rows (rel, normal, dist, friction, k, b, d),
// the joint-limit row data and the StepInfo observables. The free-joint
// rotational spring is computed here too (the TPU kernel left it to XLA
// because Mosaic has no atan2).
//
// What bounds it on the H100: at B = 1024 the kernel moves ~6.8 MB and
// does ~20 kFLOP per env, so the memory floor is ~2 us and the FLOP floor
// under 1 us; in practice it is latency bound. One thread per env gives
// only ceil(B/128) blocks (8 at B = 1024, of 132 SMs), and each thread
// runs a long dependent chain through a tree.
//
// What the design does about it: the design is the simple one. The
// model structure (tree, joint types, slot tables) lives in a small
// int32 table on the device that every thread reads at the same address
// (a broadcast); the float parameters come as the nine packs of
// `_pack_params`, shared across the batch. Per-env arrays, outputs and
// scratch are batch-last, so every load and store of a warp is one
// coalesced 128-byte line. The heightfield lookup is an indexed 4-corner
// bilinear read instead of the TPU's tent-weight sum over the grid.
// Using more than one thread per env is later work.

#include "common.cuh"

using namespace hm;

namespace {

// int-table layout, built by fused_smooth._int_table
enum {
  H_NQ = 0, H_NV, H_NU, H_NBODY, H_NJNT, H_NSPH, H_NPAIR, H_NSITE, H_NLIM,
  H_NHROW, H_NHCOL, H_HAS_FLOOR, H_K,
  O_BODY_PARENT = 16, O_BODY_JPTR, O_BODY_JIDX, O_JNT_TYPE, O_JNT_BODY,
  O_JNT_QADR, O_JNT_VADR, O_DOF_BODY, O_BODY_DOF, O_ACT_JNT, O_ACT_TYPE,
  O_SPH_BODY, O_SPH_FLOOR, O_PAIR_A, O_PAIR_B, O_SITE_BODY, O_LIM_JNT,
};
enum { J_FREE = 0, J_SLIDE = 2, J_HINGE = 3 };
enum { A_MOTOR = 0 };

// pack strides (fused_smooth._pack_params)
constexpr int BP = 18;  // bodyp: pos3 quat4 ipos3 iquat4 inertia3 mass1
constexpr int JP = 10;  // jointp: pos3 axis3 stiffness1 range2 margin1
constexpr int AP = 7;   // actp: gear kp kv ctrlrange2 forcerange2
constexpr int SP = 7;   // sphp: pos3 radius friction3

struct SmoothArgs {
  const float *qpos, *qvel, *ctrl, *xfrc;
  const float *bodyp, *jointp, *dofp, *qspr, *actp, *sphp, *sitep, *misc,
      *hf;
  const int* tab;
  float *M, *qfs, *cdof, *rel, *nrm, *mu3, *ckbd, *limd, *ipack, *sitex,
      *vec6, *actf, *scratch;
  int B, has_xfrc;
};

struct S6 {
  V3 a, l;  // [angular; linear]
};

__device__ __forceinline__ S6 ld6(const Out& v, int i) {
  return {ld3(v, i), ld3(v, i + 3)};
}
__device__ __forceinline__ void st6(const Out& v, int i, S6 s) {
  st3(v, i, s.a);
  st3(v, i + 3, s.l);
}

// 10-component spatial inertia [A sym6 | h3 | m] applied to [w; v]
__device__ __forceinline__ S6 inert_apply(const Out& I, int o, S6 s) {
  float A0 = I[o], A1 = I[o + 1], A2 = I[o + 2], A3 = I[o + 3],
        A4 = I[o + 4], A5 = I[o + 5];
  V3 h{I[o + 6], I[o + 7], I[o + 8]};
  float m = I[o + 9];
  V3 w = s.a, v = s.l;
  V3 ang{A0 * w.x + A3 * w.y + A4 * w.z, A3 * w.x + A1 * w.y + A5 * w.z,
         A4 * w.x + A5 * w.y + A2 * w.z};
  return {ang + cross(h, v), v * m - cross(h, w)};
}

__device__ __forceinline__ S6 motion_cross(S6 v, S6 m) {
  return {cross(v.a, m.a), cross(v.l, m.a) + cross(v.a, m.l)};
}
__device__ __forceinline__ S6 force_cross(S6 v, S6 f) {
  return {cross(v.a, f.a) + cross(v.l, f.l), cross(v.a, f.l)};
}

struct HField {
  const float* H;
  int nr, nc;
  float hx, hy, z0, cx, cy;
  // floor height at (x, y): indexed 4-corner bilinear read, the same value
  // as collision.hfield_height's tent-weight sum (same clamp)
  __device__ float height(float x, float y) const {
    float gx = (x + hx) / (2.0f * hx) * (float)(nc - 1);
    float gy = (y + hy) / (2.0f * hy) * (float)(nr - 1);
    gx = fminf(fmaxf(gx, 0.0f), cx);
    gy = fminf(fmaxf(gy, 0.0f), cy);
    int ix = min(max((int)floorf(gx), 0), nc - 2);
    int iy = min(max((int)floorf(gy), 0), nr - 2);
    float fx = gx - (float)ix, fy = gy - (float)iy;
    const float* r0 = H + iy * nc + ix;
    const float* r1 = r0 + nc;
    float h0 = (1.0f - fx) * __ldg(r0) + fx * __ldg(r0 + 1);
    float h1 = (1.0f - fx) * __ldg(r1) + fx * __ldg(r1 + 1);
    return z0 + (1.0f - fy) * h0 + fy * h1;
  }
};

__global__ void __launch_bounds__(128) smooth_kernel(SmoothArgs a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int B = a.B;
  if (e >= B) return;
  const int* T = a.tab;
  const int nq = T[H_NQ], nv = T[H_NV], nu = T[H_NU], nbody = T[H_NBODY],
            njnt = T[H_NJNT], nsph = T[H_NSPH], npair = T[H_NPAIR],
            nsite = T[H_NSITE], nlim = T[H_NLIM], K = T[H_K];
  const int* body_parent = T + T[O_BODY_PARENT];
  const int* body_jptr = T + T[O_BODY_JPTR];
  const int* body_jidx = T + T[O_BODY_JIDX];
  const int* jnt_type = T + T[O_JNT_TYPE];
  const int* jnt_body = T + T[O_JNT_BODY];
  const int* jnt_qadr = T + T[O_JNT_QADR];
  const int* jnt_vadr = T + T[O_JNT_VADR];
  const int* dof_body = T + T[O_DOF_BODY];
  const int* body_dof = T + T[O_BODY_DOF];
  const int* act_jnt = T + T[O_ACT_JNT];
  const int* act_type = T + T[O_ACT_TYPE];
  const int* sph_body = T + T[O_SPH_BODY];
  const int* sph_floor = T + T[O_SPH_FLOOR];
  const int* pair_a = T + T[O_PAIR_A];
  const int* pair_b = T + T[O_PAIR_B];
  const int* site_body = T + T[O_SITE_BODY];
  const int* lim_jnt = T + T[O_LIM_JNT];
  (void)nq;

  const float *bodyp = a.bodyp, *jointp = a.jointp, *dofp = a.dofp,
              *qspr = a.qspr, *actp = a.actp, *sphp = a.sphp,
              *sitep = a.sitep, *misc = a.misc;
  const V3 grav = pv3(misc, 0);
  const float floor_z = pf(misc, 3);
  const float floor_fr = pf(misc, 4), floor_tor = pf(misc, 5),
              floor_roll = pf(misc, 6);
  const float so_tc = pf(misc, 9), so_dr = pf(misc, 10),
              so_dmin = pf(misc, 11), so_dmax = pf(misc, 12),
              so_w = pf(misc, 13);
  const float li_tc = pf(misc, 14), li_dr = pf(misc, 15),
              li_dmin = pf(misc, 16), li_dmax = pf(misc, 17),
              li_w = pf(misc, 18);
  const float dt = pf(misc, 19);

  const In qpos{a.qpos + e, B}, qvel{a.qvel + e, B}, ctrl{a.ctrl + e, B};
  const Out M{a.M + e, B}, qfs{a.qfs + e, B}, cdof{a.cdof + e, B},
      rel{a.rel + e, B}, nrm{a.nrm + e, B}, mu3{a.mu3 + e, B},
      ckbd{a.ckbd + e, B}, limd{a.limd + e, B}, ipack{a.ipack + e, B},
      sitex{a.sitex + e, B}, vec6{a.vec6 + e, B}, actf{a.actf + e, B};

  Carver cv{a.scratch + e, B, 0};
  const Out xpos = cv.take(3 * nbody), xquat = cv.take(4 * nbody),
            xanc = cv.take(3 * njnt), xipos = cv.take(3 * nbody),
            inert = cv.take(10 * nbody), Ic = cv.take(10 * nbody),
            cvel = cv.take(6 * nbody), cacc = cv.take(6 * nbody),
            cdd = cv.take(6 * nv), cen = cv.take(3 * nsph),
            ws = cv.take(6 * nbody);

  // ---- forward kinematics (engine.fwd_position) ----
  for (int b = 0; b < nbody; ++b) {
    const int p = body_parent[b];
    V3 pos = pv3(bodyp, b * BP);
    Q4 quat = pq4(bodyp, b * BP + 3);
    if (p >= 0) {
      Q4 qp = ld4(xquat, 4 * p);
      pos = ld3(xpos, 3 * p) + qrot(qp, pos);
      quat = qmul(qp, quat);
    }
    for (int jj = body_jptr[b]; jj < body_jptr[b + 1]; ++jj) {
      const int j = body_jidx[jj];
      const int qadr = jnt_qadr[j];
      const V3 jp = pv3(jointp, j * JP), ax = pv3(jointp, j * JP + 3);
      if (jnt_type[j] == J_FREE) {
        pos = {qpos[qadr], qpos[qadr + 1], qpos[qadr + 2]};
        quat = qnormalize({qpos[qadr + 3], qpos[qadr + 4], qpos[qadr + 5],
                           qpos[qadr + 6]});
        st3(xanc, 3 * j, pos);
      } else {
        const V3 aw = pos + qrot(quat, jp);
        st3(xanc, 3 * j, aw);
        if (jnt_type[j] == J_HINGE) {
          float half = 0.5f * qpos[qadr];
          float sh = sinf(half), ch = cosf(half);
          quat = qmul(quat, {ch, ax.x * sh, ax.y * sh, ax.z * sh});
          pos = aw - qrot(quat, jp);
        } else {  // SLIDE
          pos = pos + qrot(quat, ax * qpos[qadr]);
        }
      }
    }
    st3(xpos, 3 * b, pos);
    st4(xquat, 4 * b, quat);
  }

  // ---- COMs and the spatial anchor (whole-model COM) ----
  float total_mass = 0.0f;
  V3 anc{0.0f, 0.0f, 0.0f};
  for (int b = 0; b < nbody; ++b) {
    const float mass = pf(bodyp, b * BP + 17);
    const V3 xi = ld3(xpos, 3 * b) + qrot(ld4(xquat, 4 * b),
                                         pv3(bodyp, b * BP + 7));
    st3(xipos, 3 * b, xi);
    total_mass += mass;
    anc = anc + xi * mass;
  }
  const float inv_mass = 1.0f / fmaxf(total_mass, 1e-12f);
  anc = anc * inv_mass;

  // ---- cdof (engine._compute_cdof) ----
  for (int j = 0; j < njnt; ++j) {
    const int b = jnt_body[j], v0 = jnt_vadr[j];
    const Q4 qb = ld4(xquat, 4 * b);
    const V3 arm = anc - ld3(xanc, 3 * j);
    const V3 z{0.0f, 0.0f, 0.0f};
    if (jnt_type[j] == J_FREE) {
      V3 c[3];
      qcols(qb, c[0], c[1], c[2]);
      for (int k = 0; k < 3; ++k) {
        const V3 ek{k == 0 ? 1.0f : 0.0f, k == 1 ? 1.0f : 0.0f,
                    k == 2 ? 1.0f : 0.0f};
        st6(cdof, 6 * (v0 + k), {z, ek});
        st6(cdof, 6 * (v0 + 3 + k), {c[k], cross(c[k], arm)});
      }
    } else {
      const V3 ax = qrot(qb, pv3(jointp, j * JP + 3));
      if (jnt_type[j] == J_HINGE)
        st6(cdof, 6 * v0, {ax, cross(ax, arm)});
      else
        st6(cdof, 6 * v0, {z, ax});
    }
  }

  // ---- spatial inertias about the anchor, 10-component form ----
  for (int b = 0; b < nbody; ++b) {
    const float mass = pf(bodyp, b * BP + 17);
    const V3 I3 = pv3(bodyp, b * BP + 14);
    V3 r0, r1, r2;
    qcols(qmul(ld4(xquat, 4 * b), pq4(bodyp, b * BP + 10)), r0, r1, r2);
    const float Ixx = I3.x * r0.x * r0.x + I3.y * r1.x * r1.x +
                      I3.z * r2.x * r2.x;
    const float Iyy = I3.x * r0.y * r0.y + I3.y * r1.y * r1.y +
                      I3.z * r2.y * r2.y;
    const float Izz = I3.x * r0.z * r0.z + I3.y * r1.z * r1.z +
                      I3.z * r2.z * r2.z;
    const float Ixy = I3.x * r0.x * r0.y + I3.y * r1.x * r1.y +
                      I3.z * r2.x * r2.y;
    const float Ixz = I3.x * r0.x * r0.z + I3.y * r1.x * r1.z +
                      I3.z * r2.x * r2.z;
    const float Iyz = I3.x * r0.y * r0.z + I3.y * r1.y * r1.z +
                      I3.z * r2.y * r2.z;
    const V3 c = ld3(xipos, 3 * b) - anc;
    const float cc = dot(c, c);
    const float v10[10] = {Ixx + mass * (cc - c.x * c.x),
                           Iyy + mass * (cc - c.y * c.y),
                           Izz + mass * (cc - c.z * c.z),
                           Ixy - mass * c.x * c.y,
                           Ixz - mass * c.x * c.z,
                           Iyz - mass * c.y * c.z,
                           mass * c.x, mass * c.y, mass * c.z, mass};
    for (int k = 0; k < 10; ++k) {
      inert[10 * b + k] = v10[k];
      Ic[10 * b + k] = v10[k];
    }
  }

  // ---- mass matrix from composite inertias ----
  for (int b = nbody - 1; b > 0; --b) {
    const int p = body_parent[b];
    if (p >= 0)
      for (int k = 0; k < 10; ++k) Ic[10 * p + k] += Ic[10 * b + k];
  }
  for (int w = 0; w < nv; ++w) {
    const int bw = dof_body[w];
    const S6 F = inert_apply(Ic, 10 * bw, ld6(cdof, 6 * w));
    for (int u = 0; u <= w; ++u) {
      float val = 0.0f;
      if (body_dof[bw * nv + u]) {
        const S6 cu = ld6(cdof, 6 * u);
        val = dot(cu.a, F.a) + dot(cu.l, F.l);
      }
      M[u * nv + w] = val;
      M[w * nv + u] = val;
    }
  }
  for (int v = 0; v < nv; ++v) M[v * nv + v] += pf(dofp, 2 * v);

  // ---- body velocities, cdof_dot, accelerations (engine.fwd_velocity,
  //      engine.rnea_bias) ----
  for (int b = 0; b < nbody; ++b) {
    const int p = body_parent[b];
    S6 v6 = p < 0 ? S6{{0, 0, 0}, {0, 0, 0}} : ld6(cvel, 6 * p);
    for (int jj = body_jptr[b]; jj < body_jptr[b + 1]; ++jj) {
      const int j = body_jidx[jj];
      const int v0 = jnt_vadr[j], nvj = jnt_type[j] == J_FREE ? 6 : 1;
      for (int k = v0; k < v0 + nvj; ++k) {
        const S6 c = ld6(cdof, 6 * k);
        const float q = qvel[k];
        v6 = {v6.a + c.a * q, v6.l + c.l * q};
      }
    }
    st6(cvel, 6 * b, v6);
  }
  for (int j = 0; j < njnt; ++j) {
    const int b = jnt_body[j], v0 = jnt_vadr[j];
    const bool free_j = jnt_type[j] == J_FREE;
    const int nvj = free_j ? 6 : 1;
    const S6 vb = ld6(cvel, 6 * b);
    for (int k = v0; k < v0 + nvj; ++k) {
      S6 d = (free_j && k < v0 + 3) ? S6{{0, 0, 0}, {0, 0, 0}}
                                    : motion_cross(vb, ld6(cdof, 6 * k));
      st6(cdd, 6 * k, d);
    }
  }
  for (int b = 0; b < nbody; ++b) {
    const int p = body_parent[b];
    S6 a6 = p < 0 ? S6{{0, 0, 0}, grav * -1.0f} : ld6(cacc, 6 * p);
    for (int jj = body_jptr[b]; jj < body_jptr[b + 1]; ++jj) {
      const int j = body_jidx[jj];
      const int v0 = jnt_vadr[j], nvj = jnt_type[j] == J_FREE ? 6 : 1;
      for (int k = v0; k < v0 + nvj; ++k) {
        const S6 c = ld6(cdd, 6 * k);
        const float q = qvel[k];
        a6 = {a6.a + c.a * q, a6.l + c.l * q};
      }
    }
    st6(cacc, 6 * b, a6);
  }
  // body forces f = I a + v ×* I v, overwriting cacc (all of it is read)
  for (int b = 0; b < nbody; ++b) {
    const S6 vb = ld6(cvel, 6 * b);
    const S6 Iv = inert_apply(inert, 10 * b, vb);
    const S6 f = inert_apply(inert, 10 * b, ld6(cacc, 6 * b));
    const S6 fc = force_cross(vb, Iv);
    st6(cacc, 6 * b, {f.a + fc.a, f.l + fc.l});
  }
  for (int b = nbody - 1; b > 0; --b) {
    const int p = body_parent[b];
    if (p >= 0)
      for (int k = 0; k < 6; ++k) cacc[6 * p + k] += cacc[6 * b + k];
  }
  // qfrc_smooth = actuation + passive - bias (+ xfrc)
  for (int k = 0; k < nv; ++k) {
    const S6 c = ld6(cdof, 6 * k), f = ld6(cacc, 6 * dof_body[k]);
    qfs[k] = -pf(dofp, 2 * k + 1) * qvel[k] - (dot(c.a, f.a) + dot(c.l, f.l));
  }

  // ---- actuation (engine.actuation) ----
  for (int i = 0; i < nu; ++i) {
    const int j = act_jnt[i];
    const int qadr = jnt_qadr[j], vadr = jnt_vadr[j];
    const float* ap = actp + i * AP;
    const float c = clipf(ctrl[i], pf(ap, 3), pf(ap, 4));
    float force = act_type[i] == A_MOTOR
                      ? c
                      : pf(ap, 1) * (c - qpos[qadr]) - pf(ap, 2) * qvel[vadr];
    force = clipf(force, pf(ap, 5), pf(ap, 6));
    const float tq = pf(ap, 0) * force;
    qfs[vadr] += tq;
    actf[i] = tq;
  }

  // ---- joint springs (engine.passive_force) ----
  for (int j = 0; j < njnt; ++j) {
    const int qadr = jnt_qadr[j], vadr = jnt_vadr[j];
    const float stiff = pf(jointp, j * JP + 6);
    if (jnt_type[j] != J_FREE) {
      qfs[vadr] -= stiff * (qpos[qadr] - pf(qspr, qadr));
      continue;
    }
    for (int k = 0; k < 3; ++k)
      qfs[vadr + k] -= stiff * (qpos[qadr + k] - pf(qspr, qadr + k));
    // rotational spring: -k quat_sub(q, q_spring) = -k log(conj(qs) ⊗ q)
    const Q4 qs = pq4(qspr, qadr + 3);
    Q4 d = qmul({qs.w, -qs.x, -qs.y, -qs.z},
                {qpos[qadr + 3], qpos[qadr + 4], qpos[qadr + 5],
                 qpos[qadr + 6]});
    if (d.w < 0.0f) d = {-d.w, -d.x, -d.y, -d.z};
    const float w = clipf(d.w, -1.0f, 1.0f);
    const float vn = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z + 1e-20f);
    const float scale = 2.0f * atan2f(vn, w) / vn;
    qfs[vadr + 3] -= stiff * d.x * scale;
    qfs[vadr + 4] -= stiff * d.y * scale;
    qfs[vadr + 5] -= stiff * d.z * scale;
  }

  // ---- external wrenches at body COMs (engine.xfrc_to_qfrc) ----
  if (a.has_xfrc) {
    const In xfrc{a.xfrc + e, B};
    for (int b = 0; b < nbody; ++b) {
      const V3 f3 = ld3(xfrc, 6 * b), t3 = ld3(xfrc, 6 * b + 3);
      st6(ws, 6 * b, {t3 + cross(ld3(xipos, 3 * b) - anc, f3), f3});
    }
    for (int b = nbody - 1; b > 0; --b) {
      const int p = body_parent[b];
      if (p >= 0)
        for (int k = 0; k < 6; ++k) ws[6 * p + k] += ws[6 * b + k];
    }
    for (int k = 0; k < nv; ++k) {
      const S6 c = ld6(cdof, 6 * k), w6 = ld6(ws, 6 * dof_body[k]);
      qfs[k] += dot(c.a, w6.a) + dot(c.l, w6.l);
    }
  }

  // ---- collision: sphere-vs-floor, then sphere-sphere slots ----
  for (int i = 0; i < nsph; ++i) {
    const int b = sph_body[i];
    st3(cen, 3 * i,
        ld3(xpos, 3 * b) + qrot(ld4(xquat, 4 * b), pv3(sphp, i * SP)));
  }
  const int nr = T[H_NHROW], nc = T[H_NHCOL];
  const HField hf{a.hf, nr, nc, pf(misc, 7), pf(misc, 8), floor_z,
                  (float)((double)nc - 1.000001), (float)((double)nr - 1.000001)};
  const float eps = 1e-3f;
  for (int c = 0; c < K; ++c) {
    V3 pos, n;
    float dist, mus, mut, mur;
    if (c < nsph) {
      const V3 ce = ld3(cen, 3 * c);
      const float rad = pf(sphp, c * SP + 3);
      if (T[H_HAS_FLOOR]) {
        const float h0 = hf.height(ce.x, ce.y);
        const float hpx = hf.height(ce.x + eps, ce.y);
        const float hmx = hf.height(ce.x - eps, ce.y);
        const float hpy = hf.height(ce.x, ce.y + eps);
        const float hmy = hf.height(ce.x, ce.y - eps);
        n = {-(hpx - hmx) / (2.0f * eps), -(hpy - hmy) / (2.0f * eps), 1.0f};
        n = n * (1.0f / sqrtf(dot(n, n)));
        const float draw = ce.z - rad - h0;
        pos = ce - n * (rad + 0.5f * draw);
        dist = sph_floor[c] ? draw : 1e9f;
        mus = fmaxf(pf(sphp, c * SP + 4), floor_fr);
        mut = fmaxf(pf(sphp, c * SP + 5), floor_tor);
        mur = fmaxf(pf(sphp, c * SP + 6), floor_roll);
      } else {
        pos = ce;
        n = {0.0f, 0.0f, 1.0f};
        dist = 1e9f;
        mus = pf(sphp, c * SP + 4);
        mut = pf(sphp, c * SP + 5);
        mur = pf(sphp, c * SP + 6);
      }
    } else {
      const int ia = pair_a[c - nsph], ib = pair_b[c - nsph];
      const V3 ca = ld3(cen, 3 * ia), cb = ld3(cen, 3 * ib);
      const V3 delta = cb - ca;
      const float dn = sqrtf(dot(delta, delta));
      n = delta * (1.0f / mx(dn, 1e-9f));
      const float ra = pf(sphp, ia * SP + 3), rb = pf(sphp, ib * SP + 3);
      dist = dn - (ra + rb);
      pos = ca + n * (ra + 0.5f * dist);
      mus = fmaxf(pf(sphp, ia * SP + 4), pf(sphp, ib * SP + 4));
      mut = fmaxf(pf(sphp, ia * SP + 5), pf(sphp, ib * SP + 5));
      mur = fmaxf(pf(sphp, ia * SP + 6), pf(sphp, ib * SP + 6));
    }
    const V3 r = pos - anc;
    rel[c] = r.x;
    rel[K + c] = r.y;
    rel[2 * K + c] = r.z;
    nrm[c] = n.x;
    nrm[K + c] = n.y;
    nrm[2 * K + c] = n.z;
    mu3[c] = mus;
    mu3[K + c] = mut;
    mu3[2 * K + c] = mur;
    const float d = impedance(-dist, so_dmin, so_dmax, so_w);
    float kk, bb;
    solref_kb(so_tc, so_dr, so_dmax, d, dt, kk, bb);
    ckbd[c] = dist;
    ckbd[K + c] = kk;
    ckbd[2 * K + c] = bb;
    ckbd[3 * K + c] = d;
  }

  // ---- joint-limit rows (solver.limit_rows_data order) ----
  for (int l = 0; l < nlim / 2; ++l) {
    const int j = lim_jnt[l];
    const float q = qpos[jnt_qadr[j]];
    const float lo = pf(jointp, j * JP + 7), hi = pf(jointp, j * JP + 8),
                mg = pf(jointp, j * JP + 9);
    const float pos2[2] = {q - lo - mg, hi - mg - q};
    for (int s = 0; s < 2; ++s) {
      const int row = 2 * l + s;
      const float d = impedance(-pos2[s], li_dmin, li_dmax, li_w);
      float kk, bb;
      solref_kb(li_tc, li_dr, li_dmax, d, dt, kk, bb);
      limd[row] = pos2[s];
      limd[nlim + row] = kk;
      limd[2 * nlim + row] = bb;
      limd[3 * nlim + row] = d;
    }
  }

  // ---- observables: [xpos | xquat | xipos | body COM velocity] ----
  V3 com_vel{0.0f, 0.0f, 0.0f};
  for (int b = 0; b < nbody; ++b) {
    const V3 xi = ld3(xipos, 3 * b);
    const S6 vb = ld6(cvel, 6 * b);
    const V3 bcv = vb.l + cross(vb.a, xi - anc);
    st3(ipack, 13 * b, ld3(xpos, 3 * b));
    st4(ipack, 13 * b + 3, ld4(xquat, 4 * b));
    st3(ipack, 13 * b + 7, xi);
    st3(ipack, 13 * b + 10, bcv);
    com_vel = com_vel + bcv * pf(bodyp, b * BP + 17);
  }
  for (int i = 0; i < nsite; ++i) {
    const int b = site_body[i];
    st3(sitex, 3 * i,
        ld3(xpos, 3 * b) + qrot(ld4(xquat, 4 * b), pv3(sitep, 3 * i)));
  }
  st3(vec6, 0, anc);
  st3(vec6, 3, com_vel * inv_mass);
}

}  // namespace

extern "C" int hm_smooth(const float* qpos, const float* qvel,
                         const float* ctrl, const float* xfrc, int has_xfrc,
                         const float* bodyp, const float* jointp,
                         const float* dofp, const float* qspr,
                         const float* actp, const float* sphp,
                         const float* sitep, const float* misc,
                         const float* hf, const int* tab, float* M, float* qfs,
                         float* cdof, float* rel, float* nrm, float* mu3,
                         float* ckbd, float* limd, float* ipack, float* sitex,
                         float* vec6, float* actf, float* scratch, int B,
                         void* stream) {
  SmoothArgs a{qpos,  qvel, ctrl,  xfrc,  bodyp,  jointp, dofp,    qspr,
               actp,  sphp, sitep, misc,  hf,     tab,    M,       qfs,
               cdof,  rel,  nrm,   mu3,   ckbd,   limd,   ipack,   sitex,
               vec6,  actf, scratch, B,   has_xfrc};
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  smooth_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
