// The models whose step K2 (csrc/line_search.cu, the line search) and K9
// (csrc/rollout.cu, the open-loop rollout) take, shared by both. A model is a
// struct: its sizes (NX, NE, NU; QI, the quaternion's index in x or -1), the
// constants of its step that a scenario computes once from the model's
// parameters (VALUES of them, written by load), and the step itself, in the
// order of the operations of its plain PyTorch model. The step is two parts:
// `drive`, what depends on the inputs u alone (D values: the SRBs' v̇ and
// ω̇ or moment, the attitude model's u itself), and `advance`, the rest,
// which takes x and the drive; `step` is drive then advance, the same
// operations in the same order, so that K2's bits do not depend on the split
// and K9 can compute every knot's drive off its serial chain:
// - QuatSrbMidpoint<NF> (models/srb.py quat_srb_dynamics_fleet): x = [p, q,
//   v, ω], the quaternion at 3; the moment Σ rᵢ×fᵢ + c×(m_c·g_body), the
//   adjugate inverse of the inertia, gravity through the frozen rotation; no
//   gyroscopic term, the trunk mass in the CoM moment; the midpoint rule;
// - EulerSrb<NF, FORWARD> (euler_srb_dynamics_fleet, the convex baseline):
//   x = [rpy, p, ω_world, v_world], no quaternion; the yaw-only rpy rate,
//   Rz(yaw)·I⁻¹·Rzᵀ from cos and sin of the yaw at every evaluation,
//   Σ rᵢ×fᵢ and v̇ = Σf/m + g; the midpoint rule, or forward Euler
//   (FORWARD: the golden convex fixture);
// - AttitudeMidpoint (models/attitude.py attitude_dynamics_fleet,
//   falling_cat): x = [q, ω], the quaternion at 0, u a body torque;
//   q̇ = ½G(q)ω, ω̇ = I⁻¹(u − ω×Iω) with the gyroscopic term; the midpoint
//   rule.
// Each is a template over Ops, how its step rounds the terms of a cross
// product and takes a sine and a cosine:
// - Separate (K2): each product rounded, then the difference; sincos, one
//   range reduction for both. K2's outputs keep the bits of its first design
//   with these (chip_smoke.py --k2-baseline);
// - AsTorch (K9): as PyTorch's CUDA kernels compute the plain model on the
//   card: a term a_j·b_k − a_k·b_j as fma(a_j, b_k, −(a_k·b_j))
//   (torch.linalg.cross), the sine and the cosine apart (torch.sin,
//   torch.cos). Built with -fmad=false, a step then equals the plain
//   version's bit for bit (K8, csrc/expansions.cu, found the same ops).
// Where the plain version's matrix products multiply by a structural zero or
// one (Rz's, the Euler SRB's gravity row), the step leaves the product out,
// which moves no finite value.
//
// The parameters are read through the kernel's input table (batch_last.cuh
// In: a row and a batch stride each, so that the batch-first parameters of
// params_to_fleet are read in place), six entries from `prm` on in the order
// of enum Param (null where a model has none of them).
//
// Compiles with nvcc and, against tests/cuda_emulation.h, as plain C++.
#pragma once

#ifndef __CUDACC__
#include <cmath>
#endif

#include "batch_last.cuh"

namespace {

// The model's parameters in a kernel's input table, from its first on: the
// quaternion SRB's all six, (n_feet, 3), (3, 3), (1), (3), (1), (3, 3); the
// Euler SRB's feet, inertia and mass; the attitude model's inertia.
enum Param { P_FOOT, P_INERTIA, P_MASS, P_COM_OFFSET, P_COM_MASS, P_ROT, PARAMS };

// One scenario's rows of a slot (shared memory, or a thread's own array):
// row i at p[i], an offset the compiler folds into the load.
template <typename T>
struct Sm {
  const T* p;
  __device__ __forceinline__ T operator[](int i) const { return p[i]; }
};

// Each product rounded, then the difference; sincos (K2).
struct Separate {
  template <typename T>
  __device__ __forceinline__ static T cross_term(T a, T b, T c, T d) {
    return a * b - c * d;
  }
  template <typename T>
  __device__ __forceinline__ static void sin_cos(T x, T& s, T& c) {
#ifdef __CUDACC__
    sincos(x, &s, &c);
#else
    s = std::sin(x), c = std::cos(x);
#endif
  }
};

// As PyTorch's CUDA kernels compute the plain model (K9): a·b − c·d as
// fma(a, b, −(c·d)), the sine and the cosine apart.
struct AsTorch {
  template <typename T>
  __device__ __forceinline__ static T cross_term(T a, T b, T c, T d) {
#ifdef __CUDACC__
    if constexpr (sizeof(T) == 4)
      return __fmaf_rn(a, b, -(c * d));
    else
      return __fma_rn(a, b, -(c * d));
#else
    return std::fma(a, b, -(c * d));
#endif
  }
  template <typename T>
  __device__ __forceinline__ static void sin_cos(T x, T& s, T& c) {
#ifndef __CUDACC__
    using std::cos;
    using std::sin;
#endif
    s = sin(x);
    c = cos(x);
  }
};

// ½·G(q)·ω, G = [[−x, −y, −z], [w, −z, y], [z, w, −x], [−y, x, w]]
template <typename T>
__device__ __forceinline__ void quat_rate(const T* q, const T* w, T* out) {
  out[0] = T(0.5) * ((-q[1] * w[0] + -q[2] * w[1]) + -q[3] * w[2]);
  out[1] = T(0.5) * ((q[0] * w[0] + -q[3] * w[1]) + q[2] * w[2]);
  out[2] = T(0.5) * ((q[3] * w[0] + q[0] * w[1]) + -q[1] * w[2]);
  out[3] = T(0.5) * ((-q[2] * w[0] + q[1] * w[1]) + q[0] * w[2]);
}

// The sum of the forces and the moment Σ rᵢ × fᵢ of NF feet (r: the feet,
// 3 values each), in the plain version's order.
template <typename Ops, typename T, int NF>
__device__ __forceinline__ void force_and_moment(const T* u, const Sm<T>& r_, T* force,
                                                 T* moment) {
#pragma unroll
  for (int c = 0; c < 3; ++c) force[c] = u[c];
#pragma unroll
  for (int f = 1; f < NF; ++f)
#pragma unroll
    for (int c = 0; c < 3; ++c) force[c] = force[c] + u[3 * f + c];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const T r[3] = {r_[3 * f], r_[3 * f + 1], r_[3 * f + 2]};
    const T* F = u + 3 * f;
    const T t0 = Ops::cross_term(r[1], F[2], r[2], F[1]),
            t1 = Ops::cross_term(r[2], F[0], r[0], F[2]),
            t2 = Ops::cross_term(r[0], F[1], r[1], F[0]);
    if (f == 0) {
      moment[0] = t0, moment[1] = t1, moment[2] = t2;
    } else {
      moment[0] = moment[0] + t0, moment[1] = moment[1] + t1, moment[2] = moment[2] + t2;
    }
  }
}

// The quaternion SRB under the midpoint rule (models/srb.py
// quat_srb_dynamics_fleet): x = [p 3, q 4 (w first), v 3, ω 3], body frame.
// Its constants, by index: the feet (3·NF), the inverse inertia (9), g_body
// (3), the CoM moment c × (m_c·g_body) (3), the mass.
template <int NF, typename Ops>
struct QuatSrbMidpoint {
  static constexpr int NX = 13, NE = 12, NU = 3 * NF, QI = 3, VALUES = 3 * NF + 16, D = 6;

  // Every parameter is read before the inverse's divisions, whose slow
  // paths would otherwise hold back the loads after them.
  template <typename T>
  __device__ static void load(const In<T>* prm, long long b, T* m) {
    const Col<T> foot = column(prm[P_FOOT], b), com = column(prm[P_COM_OFFSET], b),
                 rot = column(prm[P_ROT], b);
    for (int i = 0; i < 3 * NF; ++i) m[i] = foot[i];
    const T r6 = rot[6], r7 = rot[7], r8 = rot[8], c0 = com[0], c1 = com[1], c2 = com[2];
    const T com_mass = column(prm[P_COM_MASS], b)[0], mass = column(prm[P_MASS], b)[0];
    T* inv = m + 3 * NF;
    inverse3(column(prm[P_INERTIA], b), inv);
    // Rᵀ g_world
    const T g_body[3] = {T(-GRAVITY) * r6, T(-GRAVITY) * r7, T(-GRAVITY) * r8};
    const T mg[3] = {com_mass * g_body[0], com_mass * g_body[1], com_mass * g_body[2]};
    T* rest = inv + 9;
#pragma unroll
    for (int c = 0; c < 3; ++c) rest[c] = g_body[c];
    rest[3] = Ops::cross_term(c1, mg[2], c2, mg[1]);
    rest[4] = Ops::cross_term(c2, mg[0], c0, mg[2]);
    rest[5] = Ops::cross_term(c0, mg[1], c1, mg[0]);
    rest[6] = mass;
  }

  // The drive d = [v̇, ω̇]: the forces set them alone, so both evaluations of
  // f share them. m: the scenario's constants.
  template <typename T>
  __device__ static void drive(const T* u, const Sm<T>& m, T* d) {
    constexpr int INV = 3 * NF, G_BODY = INV + 9, COM = G_BODY + 3, MASS = COM + 3;
    T force[3], moment[3];
    force_and_moment<Ops, T, NF>(u, m, force, moment);
#pragma unroll
    for (int c = 0; c < 3; ++c) moment[c] = moment[c] + m[COM + c];
    const T mass = m[MASS];
#pragma unroll
    for (int c = 0; c < 3; ++c) d[c] = force[c] / mass + m[G_BODY + c];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      d[3 + r] = (m[INV + 3 * r] * moment[0] + m[INV + 3 * r + 1] * moment[1]) +
                 m[INV + 3 * r + 2] * moment[2];
  }

  // x ← x + h·f(x + ½h·f(x, u), u) of the drive d.
  template <typename T>
  __device__ static void advance(T* x, const T* d, const Sm<T>&, T h) {
    const T* v_dot = d;
    const T* w_dot = d + 3;
    const T half_h = T(0.5) * h;
    T q_dot[4], q_m[4], w_m[3], v_m[3];
    quat_rate(x + 3, x + 10, q_dot);
#pragma unroll
    for (int i = 0; i < 4; ++i) q_m[i] = x[3 + i] + half_h * q_dot[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v_m[c] = x[7 + c] + half_h * v_dot[c];
      w_m[c] = x[10 + c] + half_h * w_dot[c];
    }
    quat_rate(q_m, w_m, q_dot);
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = x[c] + h * v_m[c];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[3 + i] = x[3 + i] + h * q_dot[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[7 + c] = x[7 + c] + h * v_dot[c];
      x[10 + c] = x[10 + c] + h * w_dot[c];
    }
  }

  template <typename T>
  __device__ static void step(T* x, const T* u, const Sm<T>& m, T h) {
    T d[D];
    drive(u, m, d);
    advance(x, d, m, h);
  }
};

// The Euler SRB of the convex baseline (models/srb.py
// euler_srb_dynamics_fleet): x = [rpy 3, p 3, ω 3, v 3], world frame, no
// quaternion (the error state is the state); by the midpoint rule, or with
// FORWARD by forward Euler, x ← x + h·f(x, u). Its constants: the feet
// (3·NF), the inverse inertia (9), the mass.
template <int NF, bool FORWARD, typename Ops>
struct EulerSrb {
  static constexpr int NX = 12, NE = 12, NU = 3 * NF, QI = -1, VALUES = 3 * NF + 10, D = 6;

  template <typename T>
  __device__ static void load(const In<T>* prm, long long b, T* m) {
    const Col<T> foot = column(prm[P_FOOT], b);
    for (int i = 0; i < 3 * NF; ++i) m[i] = foot[i];
    const T mass = column(prm[P_MASS], b)[0];  // read before the inverse's divisions
    inverse3(column(prm[P_INERTIA], b), m + 3 * NF);
    m[3 * NF + 9] = mass;
  }

  // ẋ at x: the rpy rate of the yaw-only map, v, ω̇ = (Rz·I⁻¹·Rzᵀ)·moment,
  // and v̇ (given: neither it nor the moment depends on x). Rz = [[c, −s, 0],
  // [s, c, 0], [0, 0, 1]] at the yaw.
  template <typename T>
  __device__ static void rate(const T* x, const T* v_dot, const T* moment, const Sm<T>& m,
                              T* xd) {
    constexpr int INV = 3 * NF;
    T c, s;
    Ops::sin_cos(x[2], s, c);
    xd[0] = c * x[6] + s * x[7];
    xd[1] = -s * x[6] + c * x[7];
    xd[2] = x[8];
#pragma unroll
    for (int i = 0; i < 3; ++i) xd[3 + i] = x[9 + i];
    // row by row: row r of Rz·I⁻¹, then of (Rz·I⁻¹)·Rzᵀ, then ω̇[r]
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      T RI[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        RI[k] = r == 0   ? c * m[INV + k] + -s * m[INV + 3 + k]
                : r == 1 ? s * m[INV + k] + c * m[INV + 3 + k]
                         : m[INV + 6 + k];
      const T w0 = RI[0] * c + RI[1] * -s, w1 = RI[0] * s + RI[1] * c, w2 = RI[2];
      xd[6 + r] = (w0 * moment[0] + w1 * moment[1]) + w2 * moment[2];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) xd[9 + i] = v_dot[i];
  }

  // The drive d = [v̇, moment]: neither depends on x.
  template <typename T>
  __device__ static void drive(const T* u, const Sm<T>& m, T* d) {
    T force[3];
    force_and_moment<Ops, T, NF>(u, m, force, d + 3);
    const T mass = m[3 * NF + 9];
#pragma unroll
    for (int c = 0; c < 3; ++c) d[c] = force[c] / mass + (c == 2 ? T(-GRAVITY) : T(0));
  }

  template <typename T>
  __device__ static void advance(T* x, const T* d, const Sm<T>& m, T h) {
    const T* v_dot = d;
    const T* moment = d + 3;
    T xd[NX];
    rate(x, v_dot, moment, m, xd);
    if constexpr (!FORWARD) {
      const T half_h = T(0.5) * h;
      T x_m[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) x_m[i] = x[i] + half_h * xd[i];
      rate(x_m, v_dot, moment, m, xd);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x[i] + h * xd[i];
  }

  template <typename T>
  __device__ static void step(T* x, const T* u, const Sm<T>& m, T h) {
    T d[D];
    drive(u, m, d);
    advance(x, d, m, h);
  }
};

// The attitude model of falling_cat under the midpoint rule
// (models/attitude.py attitude_dynamics_fleet): x = [q 4 (w first), ω 3], u
// a body torque. Its constants: the inertia (9), its inverse (9).
template <typename Ops>
struct AttitudeMidpoint {
  static constexpr int NX = 7, NE = 6, NU = 3, QI = 0, VALUES = 18, D = 3;

  template <typename T>
  __device__ static void load(const In<T>* prm, long long b, T* m) {
    const Col<T> inertia = column(prm[P_INERTIA], b);
    for (int i = 0; i < 9; ++i) m[i] = inertia[i];
    inverse3(inertia, m + 9);
  }

  // ẋ = [½G(q)ω, I⁻¹(u − ω × Iω)]
  template <typename T>
  __device__ static void rate(const T* x, const T* u, const Sm<T>& m, T* xd) {
    quat_rate(x, x + 4, xd);
    const T* w = x + 4;
    T Iw[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) Iw[r] = (m[3 * r] * w[0] + m[3 * r + 1] * w[1]) + m[3 * r + 2] * w[2];
    const T moment[3] = {u[0] - Ops::cross_term(w[1], Iw[2], w[2], Iw[1]),
                         u[1] - Ops::cross_term(w[2], Iw[0], w[0], Iw[2]),
                         u[2] - Ops::cross_term(w[0], Iw[1], w[1], Iw[0])};
#pragma unroll
    for (int r = 0; r < 3; ++r)
      xd[4 + r] = (m[9 + 3 * r] * moment[0] + m[9 + 3 * r + 1] * moment[1]) +
                  m[9 + 3 * r + 2] * moment[2];
  }

  // The step depends on x throughout: the drive is u itself.
  template <typename T>
  __device__ static void drive(const T* u, const Sm<T>&, T* d) {
#pragma unroll
    for (int i = 0; i < NU; ++i) d[i] = u[i];
  }

  template <typename T>
  __device__ static void advance(T* x, const T* d, const Sm<T>& m, T h) {
    T xd[NX], x_m[NX];
    rate(x, d, m, xd);
    const T half_h = T(0.5) * h;
#pragma unroll
    for (int i = 0; i < NX; ++i) x_m[i] = x[i] + half_h * xd[i];
    rate(x_m, d, m, xd);
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x[i] + h * xd[i];
  }

  template <typename T>
  __device__ static void step(T* x, const T* u, const Sm<T>& m, T h) {
    T d[D];
    drive(u, m, d);
    advance(x, d, m, h);
  }
};

// The instantiations K2 and K9 have, and their tags in this order
// (line_search_tags, rollout_tags).
enum Model { QUAT_SRB_MIDPOINT, EULER_SRB_MIDPOINT, EULER_SRB_EULER, ATTITUDE_MIDPOINT, MODELS };
constexpr const char* TAGS = "quat_srb_midpoint euler_srb_midpoint euler_srb_euler attitude_midpoint";

// The SRBs with Ops, as families over their feet
template <typename Ops>
struct Quat {
  template <int NF>
  using Family = QuatSrbMidpoint<NF, Ops>;
};
template <bool FORWARD, typename Ops>
struct Euler {
  template <int NF>
  using Family = EulerSrb<NF, FORWARD, Ops>;
};

template <template <int> class Family, typename Fn>
int with_feet(int n_feet, Fn& fn) {
  switch (n_feet) {
    case 1: return fn.template run<Family<1>>();
    case 2: return fn.template run<Family<2>>();
    case 3: return fn.template run<Family<3>>();
    case 4: return fn.template run<Family<4>>();
  }
  return -1;
}

// fn.template run<M>() with M the model of instantiation `model` (enum Model)
// at n_feet feet (1 for the attitude model), stepped with Ops; -1 where there
// is none.
template <typename Ops, typename Fn>
int with_model(int model, int n_feet, Fn& fn) {
  switch (model) {
    case QUAT_SRB_MIDPOINT: return with_feet<Quat<Ops>::template Family>(n_feet, fn);
    case EULER_SRB_MIDPOINT: return with_feet<Euler<false, Ops>::template Family>(n_feet, fn);
    case EULER_SRB_EULER: return with_feet<Euler<true, Ops>::template Family>(n_feet, fn);
    case ATTITUDE_MIDPOINT: return n_feet == 1 ? fn.template run<AttitudeMidpoint<Ops>>() : -1;
  }
  return -1;
}

}  // namespace
