// K7 — the articulated plant, one control period of every scenario in one launch.
//
// Replaces the region XLA fused for the JAX package at
// quaternion_mpc_tpu/sim/articulated.py:283 (step: a lax.scan of n_sub calls of
// substep :203). There is no Pallas kernel for it; eager PyTorch would run
// each substep as thousands of small launches (the Lagrangian leg
// dynamics alone, differentiated by torch.func, is most of them).
//
// What it computes, for every scenario: n_sub semi-implicit Euler substeps of
// the torso single rigid body and four 3-DoF leg chains under zero-order-hold
// joint targets. Each substep:
// - foot kinematics: fk and its Jacobian per leg, world foot positions and
//   velocities through the torso's attitude;
// - contact: the terrain's contact geometry (flat, slope, or stairs with the
//   box-SDF face/tread sigmoid blend, chosen per scenario by the terrain
//   kind), a one-sided normal spring-damper on the penetration, and the
//   stick-slip friction (anchor spring + damper clamped to mu·fn, the anchor
//   dragged on slip, reset to the foot out of contact);
// - the PD + feedforward torque, clamped to ±tau_max;
// - the leg chains M(q)·q̈ = τ − c(q, q̇) + Jᵀ·f_body, leg gravity through the
//   true attitude: M in closed form by composite inertias (the links beyond
//   joint i moved as one body about joint i's axis), c by Newton-Euler at
//   q̈ = 0 with the base accelerating at −g; the 3x3 system by the adjugate
//   inverse, as the plain version's _inv3;
// - the torso: total force and moment of the contact forces at the feet, the
//   trunk's off-centre mass, the gyroscopic term, an optional external wrench;
// - the integration: velocities first, positions with the new velocities,
//   the quaternion renormalised.
// The plain version (sim/articulated.py, backend "plain") differentiates the
// leg Lagrangian with torch.func instead, so the two check each other.
//
// What bounds it on an H100: operations, in principle: FLOPS_PER_SUBSTEP a
// scenario (kernels/articulated.py, counted from this code: the four legs and
// the torso once each) against 49 state values in and out, 36 target values
// and 231 parameter values read once. In practice latency: every substep
// depends on the one before, so a scenario is a serial chain of n_sub
// substeps, and the CLI's B = 64 is 256 threads on a card of 132 SMs.
//
// Design: a lane per leg. Four consecutive lanes own one scenario (lane l of
// the group is leg l: FL, FR, RL, RR), so a warp holds 8 scenarios and a
// block of THREADS lanes THREADS / 4. Each lane keeps its leg's q, q̇ and
// contact anchor, its 9 joint targets and the torso's 13 state values in
// registers for the whole loop, and computes its leg alone: the foot
// kinematics and J, the contact force, the clamped torque, Jᵀf, M and c, the
// 3x3 solve and the leg's step (what the reference maps with
// jax.vmap(leg_acc)). A substep's chain is one leg, not four.
// The torso's sums over the legs (Σ f_body and Σ foot × f_body, 6 values)
// are a butterfly of __shfl_xor_sync over lane offsets 1 and 2 in the group:
// every lane ends with the same bits, (a0 + a1) + (a2 + a3), so each lane runs
// the torso's update itself and no lane waits for another at a barrier.
// The block's parameter rows (contiguous in device memory) are staged into
// shared memory once a launch by plain coalesced loads, transposed on the way
// so that a lane's leg values sit at stride THREADS (a warp reads 32
// consecutive slots) and a scenario's shared scalars at stride THREADS / 4
// (the four lanes of a scenario read one slot): no bank conflict in f32 or
// f64. A bulk copy (cp.async.bulk) cannot transpose, and one copy a launch
// has nothing to overlap with. The torso's inverse inertia is computed there
// too. The sines and cosines of q0, q1 and q1 + q2 are computed once a
// substep (sincos) and shared by the kinematics and the dynamics.
// Lanes past the last scenario compute on the block's last scenario, take
// part in every shuffle with the full mask and store nothing.
// Branches on the data (in contact, slipping, the stair face, the terrain's
// kind) are selects, as in the plain version, so a warp never diverges and
// the operation count is fixed.
//
// Layout (kernels/articulated.py builds it): per scenario one row of STATE
// values [pos 3, quat 4 (w first), vel 3, omega_body 3, q 12, dq 12, anchor 12],
// one row of TARGETS [q 12, dq 12, tau 12] and one row of PARAMS (offsets
// below); legs FL, FR, RL, RR, joints hip, thigh, calf.
//
// C interface (bound with ctypes): articulated_step_f32 / _f64 take the state,
// targets and params pointers, the output pointer, n_sub, B and a
// cudaStream_t, launch on that stream and return the CUDA error of the launch.
// articulated_widths(out) writes STATE, TARGETS and PARAMS, so the wrapper
// checks its layout against the one compiled.
//
// Built with -DK7_PHASE_CLOCKS (chip_smoke.py --kernels-only does), every lane
// sums the clock64() ticks of each phase of a substep (the torso's attitude;
// the leg's kinematics and contact; the leg dynamics; the shuffle sums; the
// torso's update), lane 0 of the middle block keeps them, and
// articulated_clocks(out) copies them to the host. -DK7_THREADS=n builds
// another block size (a multiple of 32) for measurement.
//
// The device code also compiles as plain C++ (no __CUDACC__) against
// tests/cuda_emulation.h; tests/test_torch_articulated_emulation.py holds it
// against the plain step that way, and counts its operations per phase
// through K7_STAMP.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define K7_RESTRICT __restrict__
#else
#include <cmath>
#define K7_RESTRICT
#endif

#ifndef K7_THREADS
#define K7_THREADS 64
#endif

namespace {

constexpr int LEGS = 4;
constexpr int THREADS = K7_THREADS;  // lanes a block
constexpr int SCENARIOS = THREADS / LEGS;  // scenarios a block
static_assert(THREADS % 32 == 0, "a block is whole warps");
constexpr unsigned FULL = 0xffffffffu;

// state row
constexpr int S_POS = 0, S_QUAT = 3, S_VEL = 7, S_OMEGA = 10, S_Q = 13, S_DQ = 25,
              S_ANCHOR = 37, STATE = 49;
// targets row
constexpr int T_Q = 0, T_DQ = 12, T_TAU = 24, TARGETS = 36;
// params row: torso, leg geometry (rho_fix: ox, oy, hip length, thigh, calf),
// link mass (leg, link), link CoM (leg, link, xyz) and inertia (leg, link, 3x3),
// terrain, contact, joint gains (leg, joint), torque limit, control period,
// external wrench (world force, body torque)
constexpr int P_MASS = 0, P_INERTIA = 1, P_COM_OFFSET = 10, P_COM_MASS = 13, P_RHO = 14,
              P_LINK_MASS = 34, P_LINK_COM = 46, P_LINK_INERTIA = 82, P_KIND = 190,
              P_GRADE = 191, P_RISE = 192, P_RUN = 193, P_CONTACT_KP = 194,
              P_CONTACT_KD = 195, P_CONTACT_KT = 196, P_CONTACT_KT_SPRING = 197, P_MU = 198,
              P_KP = 199, P_KD = 211, P_TAU_MAX = 223, P_DT = 224, P_EXT_FORCE = 225,
              P_EXT_TORQUE = 228, PARAMS = 231;

// Staged parameters in shared memory. First a leg's values, value v of lane
// slot t at [v * THREADS + t]: rho 5, link mass 3, link CoM 9, link inertia 27,
// kp 3, kd 3.
constexpr int G_RHO = 0, G_MASS = 5, G_COM = 8, G_INERTIA = 17, G_KP = 44, G_KD = 47,
              LEG_VALUES = 50;
// Then a scenario's scalars, value c of scenario s at
// [LEG_VALUES * THREADS + c * SCENARIOS + s]: the row's torso values (0-13),
// terrain and contact (14-22), torque limit, period and wrench (23-30), and the
// torso's inverse inertia (31-39), which the kernel computes.
constexpr int C_MASS = 0, C_INERTIA = 1, C_COM_OFFSET = 10, C_COM_MASS = 13, C_KIND = 14,
              C_GRADE = 15, C_RISE = 16, C_RUN = 17, C_CONTACT_KP = 18, C_CONTACT_KD = 19,
              C_CONTACT_KT = 20, C_CONTACT_KT_SPRING = 21, C_MU = 22, C_TAU_MAX = 23,
              C_DT = 24, C_EXT_FORCE = 25, C_EXT_TORQUE = 28, C_INERTIA_INV = 31, SCALARS = 40;
constexpr int STAGED = LEG_VALUES * THREADS + SCALARS * SCENARIOS;  // values a block
// staged_slot copies the row's three runs of scalars in order
static_assert(C_INERTIA - C_MASS == P_INERTIA - P_MASS &&
                  C_COM_OFFSET - C_MASS == P_COM_OFFSET - P_MASS &&
                  C_COM_MASS - C_MASS == P_COM_MASS - P_MASS && C_COM_MASS + 1 == C_KIND,
              "torso scalars");
static_assert(C_GRADE - C_KIND == P_GRADE - P_KIND && C_RISE - C_KIND == P_RISE - P_KIND &&
                  C_RUN - C_KIND == P_RUN - P_KIND &&
                  C_CONTACT_KP - C_KIND == P_CONTACT_KP - P_KIND &&
                  C_CONTACT_KD - C_KIND == P_CONTACT_KD - P_KIND &&
                  C_CONTACT_KT - C_KIND == P_CONTACT_KT - P_KIND &&
                  C_CONTACT_KT_SPRING - C_KIND == P_CONTACT_KT_SPRING - P_KIND &&
                  C_MU - C_KIND == P_MU - P_KIND && C_MU + 1 == C_TAU_MAX,
              "terrain and contact scalars");
static_assert(C_DT - C_TAU_MAX == P_DT - P_TAU_MAX &&
                  C_EXT_FORCE - C_TAU_MAX == P_EXT_FORCE - P_TAU_MAX &&
                  C_EXT_TORQUE - C_TAU_MAX == P_EXT_TORQUE - P_TAU_MAX &&
                  C_INERTIA_INV - C_TAU_MAX == PARAMS - P_TAU_MAX && C_INERTIA_INV + 9 == SCALARS,
              "torque limit, period and wrench");

constexpr double GRAVITY = 9.81;
constexpr int SLOPE = 1, STAIRS = 2;

// The phases of a substep, for K7_STAMP.
constexpr int PH_ATTITUDE = 0, PH_CONTACT = 1, PH_DYNAMICS = 2, PH_SUMS = 3, PH_TORSO = 4,
              PHASES = 5;

}  // namespace

namespace {

template <typename T>
struct V3 {
  T x, y, z;
};
// 3x3 matrices, row-major
template <typename T>
struct M3 {
  T m[9];
};

}  // namespace

// K7_STAMP(phase, values...) ends a phase of the substep; `values` are what
// it hands on (its results and the next phase's inputs). The clocks build
// fences them on both sides of the clock read, so that the compiler computes
// a phase's results before its stamp and starts the next phase after it.
#ifdef K7_PHASE_CLOCKS
// per phase the clocks of lane 0 of the middle block over the launch, then
// the clocks of two stamps back to back
__device__ long long k7_phase_clocks[PHASES + 1];
namespace {
__device__ __forceinline__ void fence_one(float& v) { asm volatile("" : "+f"(v)); }
__device__ __forceinline__ void fence_one(double& v) { asm volatile("" : "+d"(v)); }
template <typename T>
__device__ __forceinline__ void fence_one(V3<T>& v) {
  fence_one(v.x), fence_one(v.y), fence_one(v.z);
}
template <typename T>
__device__ __forceinline__ void fence_one(M3<T>& a) {
  for (int e = 0; e < 9; ++e) fence_one(a.m[e]);
}
template <typename T, int N>
__device__ __forceinline__ void fence_one(T (&a)[N]) {
  for (int e = 0; e < N; ++e) fence_one(a[e]);
}
template <typename... A>
__device__ __forceinline__ void fence(A&... values) {
  (fence_one(values), ...);
}
}  // namespace
#define K7_STAMP(phase, ...)                  \
  do {                                        \
    fence(__VA_ARGS__);                       \
    const long long now_ = clock64();         \
    phase_spent_[phase] += now_ - phase_at_;  \
    phase_at_ = now_;                         \
    fence(__VA_ARGS__);                       \
  } while (0)
#endif
#ifndef K7_STAMP
#define K7_STAMP(phase, ...) \
  do {                       \
  } while (0)
#endif

namespace {

#ifdef __CUDACC__
__device__ __forceinline__ void k_sincos(float x, float& s, float& c) { sincosf(x, &s, &c); }
__device__ __forceinline__ void k_sincos(double x, double& s, double& c) { sincos(x, &s, &c); }
#else
inline void k_sincos(float x, float& s, float& c) {
  s = sinf(x);
  c = cosf(x);
}
inline void k_sincos(double x, double& s, double& c) {
  s = sin(x);
  c = cos(x);
}
#endif
__device__ __forceinline__ float k_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double k_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float k_exp(float x) { return expf(x); }
__device__ __forceinline__ double k_exp(double x) { return exp(x); }
__device__ __forceinline__ float k_floor(float x) { return floorf(x); }
__device__ __forceinline__ double k_floor(double x) { return floor(x); }

template <typename T>
__device__ __forceinline__ T k_max(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T k_min(T a, T b) { return a < b ? a : b; }

template <typename T>
__device__ __forceinline__ V3<T> add(V3<T> a, V3<T> b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
template <typename T>
__device__ __forceinline__ V3<T> sub(V3<T> a, V3<T> b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
template <typename T>
__device__ __forceinline__ V3<T> scale(T s, V3<T> a) { return {s * a.x, s * a.y, s * a.z}; }
template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

template <typename T>
__device__ __forceinline__ V3<T> mv(const M3<T>& a, V3<T> v) {
  return {a.m[0] * v.x + a.m[1] * v.y + a.m[2] * v.z, a.m[3] * v.x + a.m[4] * v.y + a.m[5] * v.z,
          a.m[6] * v.x + a.m[7] * v.y + a.m[8] * v.z};
}
template <typename T>
__device__ __forceinline__ V3<T> mtv(const M3<T>& a, V3<T> v) {  // aᵀ·v
  return {a.m[0] * v.x + a.m[3] * v.y + a.m[6] * v.z, a.m[1] * v.x + a.m[4] * v.y + a.m[7] * v.z,
          a.m[2] * v.x + a.m[5] * v.y + a.m[8] * v.z};
}

// The adjugate over the determinant, in plant._inv3's order.
template <typename T>
__device__ __forceinline__ M3<T> inv3(const M3<T>& A) {
  const T a = A.m[0], b = A.m[1], c = A.m[2], d = A.m[3], e = A.m[4], f = A.m[5], g = A.m[6],
          h = A.m[7], i = A.m[8];
  const T A11 = e * i - f * h, A12 = c * h - b * i, A13 = b * f - c * e;
  const T A21 = f * g - d * i, A22 = a * i - c * g, A23 = c * d - a * f;
  const T A31 = d * h - e * g, A32 = b * g - a * h, A33 = a * e - b * d;
  const T det = a * A11 + b * A21 + c * A31;
  return {{A11 / det, A12 / det, A13 / det, A21 / det, A22 / det, A23 / det, A31 / det, A32 / det,
           A33 / det}};
}

template <typename T>
__device__ __forceinline__ V3<T> load3(const T* K7_RESTRICT p) { return {p[0], p[1], p[2]}; }
// Three values `stride` apart (staged parameters).
template <typename T>
__device__ __forceinline__ V3<T> strided3(const T* p, int stride) {
  return {p[0], p[stride], p[2 * stride]};
}
template <typename T>
__device__ __forceinline__ M3<T> strided9(const T* p, int stride) {
  M3<T> a;
#pragma unroll
  for (int e = 0; e < 9; ++e) a.m[e] = p[e * stride];
  return a;
}

// Rx(roll)·Ry(pitch) from the angles' sines and cosines: the frame of a link
// after the hip roll and a (summed) pitch.
template <typename T>
__device__ __forceinline__ M3<T> roll_pitch(T s1, T c1, T s, T c) {
  const T zero = T(0);
  return {{c, zero, s, s1 * s, c1, -(s1 * c), -(c1 * s), s1, c1 * c}};
}

// A link's rotational inertia about its CoM (row-major, at stride THREADS in
// shared memory), turned from the link frame into the torso frame: R·I·Rᵀ.
template <typename T>
__device__ __forceinline__ M3<T> rotate_inertia(const M3<T>& R, const T* I) {
  M3<T> RI;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      RI.m[3 * i + j] = R.m[3 * i] * I[j * THREADS] + R.m[3 * i + 1] * I[(3 + j) * THREADS] +
                        R.m[3 * i + 2] * I[(6 + j) * THREADS];
  M3<T> out;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out.m[3 * i + j] =
          RI.m[3 * i] * R.m[3 * j] + RI.m[3 * i + 1] * R.m[3 * j + 1] + RI.m[3 * i + 2] * R.m[3 * j + 2];
  return out;
}

// The component of v along joint i's axis: x for the hip roll (i = 0), the
// rolled y axis (0, c1, s1) for the thigh and calf pitch.
template <typename T>
__device__ __forceinline__ T along_axis(int i, T s1, T c1, V3<T> v) {
  return i == 0 ? v.x : c1 * v.y + s1 * v.z;
}

// One leg chain's joint-space inertia M (3x3) and bias torque c = C(q, q̇)q̇ +
// ∇V, in closed form from the link parameters, all in the torso frame. The
// chain (kin.leg_dynamics): hip roll about z0 = x at o0 = (ox, oy, 0), thigh
// pitch about z1 = R0·y at o1 = o0 + R0·(0, d, 0), calf pitch about z2 = z1 at
// o2 = o1 + R1·(0, 0, −lt); link k has its CoM at c_k = o_k + R_k·com_k.
// The angles come as sines and cosines (q0; q1; q1 + q2), shared with the
// foot kinematics. `link` is the lane's staged leg parameters (stride
// THREADS). One pass over the links, each link's inertia turned into the
// torso frame once and its contributions added at once:
// - M: a unit acceleration of joint i moves links i..2 as one body about z_i
//   through o_i, so M_ji = Σ_{k>=i} z_j · [I_k z_i + m_k (c_k − o_j) × (z_i ×
//   (c_k − o_i))] for j <= i;
// - c: Newton-Euler at q̈ = 0, the base accelerating at −g (gravity's
//   torque): the forward pass gives each link's force F_k = m_k a_k and moment
//   N_k = I_k ω̇_k + ω_k × I_k ω_k about its CoM, and joint i carries
//   c_i = z_i · Σ_{k>=i} [N_k + (c_k − o_i) × F_k].
template <typename T>
__device__ __forceinline__ void leg_dynamics(T s1, T c1, T s2, T c2, T s23, T c23, const T dq[3],
                                             T ox, T oy, T d, T lt, const T* link, V3<T> g_body,
                                             M3<T>& M, V3<T>& c_out) {
  const T zero = T(0);
  const V3<T> z1 = {zero, c1, s1};
  V3<T> o[3];
  o[0] = {ox, oy, zero};
  o[1] = {ox, oy + d * c1, d * s1};
  o[2] = {o[1].x - lt * s2, o[1].y + lt * (s1 * c2), o[1].z - lt * (c1 * c2)};
  // M_ji (j <= i) at Mu[i (i + 1) / 2 + j], c_i at tau[i]; each sum starts
  // at its first term, link k = i
  T Mu[6], tau[3];
  V3<T> w = {zero, zero, zero}, dw = {zero, zero, zero};
  V3<T> a_joint = scale(T(-1), g_body);  // acceleration of the joint point o_k
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T one = T(1);
    const M3<T> R = k == 0 ? M3<T>{{one, zero, zero, zero, c1, -s1, zero, s1, c1}}
                           : (k == 1 ? roll_pitch(s1, c1, s2, c2) : roll_pitch(s1, c1, s23, c23));
    const T mass = link[(G_MASS + k) * THREADS];
    const V3<T> cm = add(o[k], mv(R, strided3(link + (G_COM + 3 * k) * THREADS, THREADS)));
    const M3<T> I = rotate_inertia(R, link + (G_INERTIA + 9 * k) * THREADS);

    // M: the contributions of link k to the columns i <= k
#pragma unroll
    for (int i = 0; i <= k; ++i) {
      const V3<T> zi = i == 0 ? V3<T>{T(1), zero, zero} : z1;
      const V3<T> Iz = i == 0 ? V3<T>{I.m[0], I.m[3], I.m[6]} : mv(I, z1);
      const V3<T> zr = cross(zi, sub(cm, o[i]));
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const T mji = along_axis(j, s1, c1, add(Iz, scale(mass, cross(sub(cm, o[j]), zr))));
        T& sum = Mu[i * (i + 1) / 2 + j];
        sum = k == i ? mji : sum + mji;
      }
    }

    // c: link k's velocity, acceleration, force and moment, then its
    // contributions to the joints i <= k
    const V3<T> zk = k == 0 ? V3<T>{T(1), zero, zero} : z1;
    const V3<T> zq = scale(dq[k], zk);
    if (k == 0) {
      w = zq;
    } else {
      const V3<T> l = sub(o[k], o[k - 1]);
      a_joint = add(a_joint, add(cross(dw, l), cross(w, cross(w, l))));
      dw = add(dw, cross(w, zq));
      w = add(w, zq);
    }
    const V3<T> r = sub(cm, o[k]);
    const V3<T> acc = add(a_joint, k == 0 ? cross(w, cross(w, r))
                                          : add(cross(dw, r), cross(w, cross(w, r))));
    const V3<T> F = scale(mass, acc);
    const V3<T> N = k == 0 ? cross(w, mv(I, w)) : add(mv(I, dw), cross(w, mv(I, w)));
#pragma unroll
    for (int i = 0; i <= k; ++i) {
      const T ci = along_axis(i, s1, c1, add(N, cross(sub(cm, o[i]), F)));
      tau[i] = k == i ? ci : tau[i] + ci;
    }
  }
  M = {{Mu[0], Mu[1], Mu[3], Mu[1], Mu[2], Mu[4], Mu[3], Mu[4], Mu[5]}};
  c_out = {tau[0], tau[1], tau[2]};
}

// The terrain's contact geometry at a world point (sim.terrain.contact_geometry):
// the unit normal and the penetration depth.
template <typename T>
__device__ __forceinline__ void contact_geometry(V3<T> p, int kind, T grade, T rise, T run,
                                                 V3<T>& n_out, T& pen_out) {
  const T zero = T(0), one = T(1);
  // every world's field is evaluated and the scenario's kind selects, as in
  // the plain version (the kind is uniform across a scenario's substeps)
  const T x = p.x;
  const T xc = k_max(x, zero);
  const T n_step = k_floor(xc / run);
  const T slope_z = grade * xc;
  const T stairs_z = rise * n_step;
  const T height = kind == SLOPE ? slope_z : (kind == STAIRS && x > zero ? stairs_z : zero);
  const T root = k_sqrt(one + grade * grade);
  const T slope_nx = (x > zero ? -grade : zero) / root, slope_nz = one / root;
  const V3<T> n_surf = kind == SLOPE ? V3<T>{slope_nx, zero, x > zero ? slope_nz : one}
                                     : V3<T>{zero, zero, one};
  const T pen_v = height - p.z;
  // horizontal depth past the current riser face; the first riser is at x = run
  const T x_rel = x - run * n_step;
  const T depth_h = x >= run ? x_rel : T(1e3);
  T w_face = one / (one + k_exp(-((pen_v - depth_h) / T(0.01))));
  if (!(kind == STAIRS && pen_v > zero)) w_face = zero;
  const V3<T> n = add(V3<T>{w_face * T(-1), w_face * zero, w_face * zero},
                      scale(one - w_face, n_surf));
  const T norm = k_sqrt(dot(n, n));
  n_out = {n.x / norm, n.y / norm, n.z / norm};
  pen_out = w_face * k_min(depth_h, pen_v) + (one - w_face) * pen_v;
}

__device__ __forceinline__ int scalar_slot(int c, int s) {
  return LEG_VALUES * THREADS + c * SCENARIOS + s;
}

// Where value k of the block's scenario s's parameter row is staged.
__device__ __forceinline__ int staged_slot(int k, int s) {
  int first, width, value;
  if (k < P_RHO) return scalar_slot(C_MASS + k - P_MASS, s);
  if (k < P_LINK_MASS) {
    first = P_RHO, width = 5, value = G_RHO;
  } else if (k < P_LINK_COM) {
    first = P_LINK_MASS, width = 3, value = G_MASS;
  } else if (k < P_LINK_INERTIA) {
    first = P_LINK_COM, width = 9, value = G_COM;
  } else if (k < P_KIND) {
    first = P_LINK_INERTIA, width = 27, value = G_INERTIA;
  } else if (k < P_KP) {
    return scalar_slot(C_KIND + k - P_KIND, s);
  } else if (k < P_KD) {
    first = P_KP, width = 3, value = G_KP;
  } else if (k < P_TAU_MAX) {
    first = P_KD, width = 3, value = G_KD;
  } else {
    return scalar_slot(C_TAU_MAX + k - P_TAU_MAX, s);
  }
  const int leg = (k - first) / width;
  return (value + (k - first) % width) * THREADS + LEGS * s + leg;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) articulated_kernel(const T* K7_RESTRICT state,
                                                              const T* K7_RESTRICT targets,
                                                              const T* K7_RESTRICT params,
                                                              T* K7_RESTRICT out, int n_sub,
                                                              int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const staged = reinterpret_cast<T*>(smem_raw);
  const T zero = T(0), one = T(1);

  // the block's parameter rows, once, coalesced
  const int first = blockIdx.x * SCENARIOS;
  const int here = B - first < SCENARIOS ? B - first : SCENARIOS;  // scenarios in this block
  {
    const T* K7_RESTRICT rows = params + static_cast<size_t>(first) * PARAMS;
    for (int i = threadIdx.x; i < here * PARAMS; i += THREADS)
      staged[staged_slot(i % PARAMS, i / PARAMS)] = rows[i];
  }
  __syncthreads();
  if (threadIdx.x < here) {  // the torso's inverse inertia, once a scenario
    const M3<T> inv = inv3(strided9(staged + scalar_slot(C_INERTIA, threadIdx.x), SCENARIOS));
#pragma unroll
    for (int e = 0; e < 9; ++e) staged[scalar_slot(C_INERTIA_INV + e, threadIdx.x)] = inv.m[e];
  }
  __syncthreads();

  // a lane per leg; a lane past the last scenario computes on the block's
  // last one and stores nothing
  const int leg = threadIdx.x % LEGS;
  const int local = threadIdx.x / LEGS;
  const bool active = local < here;
  const int slot = active ? local : here - 1;
  const int b = first + slot;
  const T* const link = staged + LEGS * slot + leg;  // value v at link[v * THREADS]
  const T* const sc = staged + scalar_slot(0, slot);  // value c at sc[c * SCENARIOS]

  const T* K7_RESTRICT s = state + static_cast<size_t>(b) * STATE;
  V3<T> pos = load3(s + S_POS), vel = load3(s + S_VEL), omega = load3(s + S_OMEGA);
  T qw = s[S_QUAT], qx = s[S_QUAT + 1], qy = s[S_QUAT + 2], qz = s[S_QUAT + 3];
  T q[3], dq[3], q_ref[3], dq_ref[3], tau_ff[3];
  V3<T> anchor = load3(s + S_ANCHOR + 3 * leg);
  const T* K7_RESTRICT tg = targets + static_cast<size_t>(b) * TARGETS;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    q[j] = s[S_Q + 3 * leg + j];
    dq[j] = s[S_DQ + 3 * leg + j];
    q_ref[j] = tg[T_Q + 3 * leg + j];
    dq_ref[j] = tg[T_DQ + 3 * leg + j];
    tau_ff[j] = tg[T_TAU + 3 * leg + j];
  }

  const int kind = static_cast<int>(sc[C_KIND * SCENARIOS]);
  const T dt = sc[C_DT * SCENARIOS] / static_cast<T>(n_sub);
  const T g = T(GRAVITY);
#ifdef K7_PHASE_CLOCKS
  long long phase_spent_[PHASES] = {0, 0, 0, 0, 0};
  long long phase_at_ = clock64();
#endif

  for (int sub_step = 0; sub_step < n_sub; ++sub_step) {
    // attitude: body -> world
    const T xx = qx * qx, yy = qy * qy, zz = qz * qz, wx = qw * qx, wy = qw * qy, wz = qw * qz;
    const T xy = qx * qy, xz = qx * qz, yz = qy * qz;
    M3<T> R = {{one - T(2) * (yy + zz), T(2) * (xy - wz), T(2) * (xz + wy),
                T(2) * (xy + wz), one - T(2) * (xx + zz), T(2) * (yz - wx),
                T(2) * (xz - wy), T(2) * (yz + wx), one - T(2) * (xx + yy)}};
    // gravity in the body frame: Rᵀ(0, 0, −g)
    V3<T> g_body = {R.m[6] * -g, R.m[7] * -g, R.m[8] * -g};
    K7_STAMP(PH_ATTITUDE, R, g_body, q, dq);

    // the leg's foot kinematics (kin.leg.fk / jac)
    T ox = link[G_RHO * THREADS], oy = link[(G_RHO + 1) * THREADS],
      d = link[(G_RHO + 2) * THREADS], lt = link[(G_RHO + 3) * THREADS];
    const T lc = link[(G_RHO + 4) * THREADS];
    T s1, c1, s2, c2, s23, c23;
    k_sincos(q[0], s1, c1);
    k_sincos(q[1], s2, c2);
    k_sincos(q[1] + q[2], s23, c23);
    const T ext = lt * c2 + lc * c23;
    const V3<T> foot = {ox - lt * s2 - lc * s23, oy + d * c1 + ext * s1, d * s1 - ext * c1};
    const T dext2 = -lt * s2 - lc * s23, dext3 = -lc * s23;
    const M3<T> J = {{zero, -lt * c2 - lc * c23, -lc * c23, -d * s1 + ext * c1, dext2 * s1,
                      dext3 * s1, d * c1 + ext * s1, -dext2 * c1, -dext3 * c1}};
    const V3<T> dq3 = {dq[0], dq[1], dq[2]};
    const V3<T> foot_world = add(pos, mv(R, foot));
    const V3<T> v_rel = add(cross(omega, foot), mv(J, dq3));
    const V3<T> foot_vel = add(vel, mv(R, v_rel));

    // contact: normal spring-damper, stick-slip friction
    V3<T> n;
    T pen;
    contact_geometry(foot_world, kind, sc[C_GRADE * SCENARIOS], sc[C_RISE * SCENARIOS],
                     sc[C_RUN * SCENARIOS], n, pen);
    const T v_n = dot(foot_vel, n);
    T fn = sc[C_CONTACT_KP * SCENARIOS] * pen - sc[C_CONTACT_KD * SCENARIOS] * v_n;
    const bool in_contact = pen > zero;
    const T fn_pushing = k_max(fn, zero);  // one-sided
    fn = in_contact ? fn_pushing : zero;
    const V3<T> v_t = sub(foot_vel, scale(v_n, n));
    const V3<T> disp = sub(foot_world, anchor);
    const V3<T> disp_t = sub(disp, scale(dot(disp, n), n));
    const T kts = sc[C_CONTACT_KT_SPRING * SCENARIOS];
    const V3<T> ft_raw = sub(scale(-kts, disp_t), scale(sc[C_CONTACT_KT * SCENARIOS], v_t));
    const T ft_norm = k_sqrt(dot(ft_raw, ft_raw));
    const T ft_max = sc[C_MU * SCENARIOS] * fn;
    const T ft_scale = k_min(ft_max / k_max(ft_norm, T(1e-9)), one);
    const V3<T> ft = scale(ft_scale, ft_raw);
    const bool slipping = in_contact && ft_norm > ft_max;
    const V3<T> slip = add(foot_world, V3<T>{ft.x / kts, ft.y / kts, ft.z / kts});
    anchor = in_contact ? (slipping ? slip : anchor) : foot_world;
    const T on = in_contact ? one : zero;
    const V3<T> f_world = add(scale(fn, n), scale(on, ft));
    const V3<T> f_body = mtv(R, f_world);

    // actuator torque, clamped
    const T tau_max = sc[C_TAU_MAX * SCENARIOS];
    T rhs[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T tau = link[(G_KP + j) * THREADS] * (q_ref[j] - q[j]) +
                    link[(G_KD + j) * THREADS] * (dq_ref[j] - dq[j]) + tau_ff[j];
      rhs[j] = k_min(k_max(tau, -tau_max), tau_max);
    }
    V3<T> jtf = mtv(J, f_body);
    // the leg's terms of the torso's sums: its force and its moment about the
    // torso's origin
    T sums[6];
    {
      const V3<T> moment = cross(foot, f_body);
      sums[0] = f_body.x, sums[1] = f_body.y, sums[2] = f_body.z;
      sums[3] = moment.x, sums[4] = moment.y, sums[5] = moment.z;
    }
    K7_STAMP(PH_CONTACT, sums, rhs, jtf, anchor, s1, c1, s2, c2, s23, c23, dq, ox, oy, d, lt,
             g_body);

    // the leg chain: M·q̈ = τ − c + Jᵀ·f_body, then its semi-implicit step
    {
      M3<T> M;
      V3<T> c;
      leg_dynamics(s1, c1, s2, c2, s23, c23, dq, ox, oy, d, lt, link, g_body, M, c);
      const V3<T> r = {rhs[0] - c.x + jtf.x, rhs[1] - c.y + jtf.y, rhs[2] - c.z + jtf.z};
      const V3<T> ddq = mv(inv3(M), r);
      dq[0] = dq[0] + dt * ddq.x;
      dq[1] = dq[1] + dt * ddq.y;
      dq[2] = dq[2] + dt * ddq.z;
#pragma unroll
      for (int j = 0; j < 3; ++j) q[j] = q[j] + dt * dq[j];
    }
    K7_STAMP(PH_DYNAMICS, q, dq, sums);

    // the torso's sums over the scenario's four lanes: a butterfly, the same
    // bits in every lane
#pragma unroll
    for (int offset = 1; offset < LEGS; offset <<= 1)
#pragma unroll
      for (int v = 0; v < 6; ++v) sums[v] = sums[v] + __shfl_xor_sync(FULL, sums[v], offset);
    K7_STAMP(PH_SUMS, sums);

    // the torso (sim.plant.dynamics with the feet at the fk points), in
    // every lane
    {
      const M3<T> inertia = strided9(sc + C_INERTIA * SCENARIOS, SCENARIOS);
      V3<T> force_world = mv(R, V3<T>{sums[0], sums[1], sums[2]});
      V3<T> moment = {sums[3], sums[4], sums[5]};
      const V3<T> g_world = {zero, zero, -g};
      moment = add(moment, cross(strided3(sc + C_COM_OFFSET * SCENARIOS, SCENARIOS),
                                 scale(sc[C_COM_MASS * SCENARIOS], g_body)));
      moment = sub(moment, cross(omega, mv(inertia, omega)));
      force_world = add(force_world, strided3(sc + C_EXT_FORCE * SCENARIOS, SCENARIOS));
      moment = add(moment, strided3(sc + C_EXT_TORQUE * SCENARIOS, SCENARIOS));
      const T mass = sc[C_MASS * SCENARIOS];
      const V3<T> vel_dot =
          add(V3<T>{force_world.x / mass, force_world.y / mass, force_world.z / mass}, g_world);
      const V3<T> omega_dot =
          mv(strided9(sc + C_INERTIA_INV * SCENARIOS, SCENARIOS), moment);

      vel = add(vel, scale(dt, vel_dot));
      omega = add(omega, scale(dt, omega_dot));
      pos = add(pos, scale(dt, vel));
      // q̇ = ½·G(q)·ω, G = [−vᵀ; w·I + [v]×]
      const T half_dt = dt * T(0.5);
      const T qn[4] = {qw + half_dt * (-qx * omega.x - qy * omega.y - qz * omega.z),
                       qx + half_dt * (qw * omega.x - qz * omega.y + qy * omega.z),
                       qy + half_dt * (qz * omega.x + qw * omega.y - qx * omega.z),
                       qz + half_dt * (-qy * omega.x + qx * omega.y + qw * omega.z)};
      const T norm = k_sqrt(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3]);
      qw = qn[0] / norm;
      qx = qn[1] / norm;
      qy = qn[2] / norm;
      qz = qn[3] / norm;
    }
    K7_STAMP(PH_TORSO, pos, vel, omega, qw, qx, qy, qz, q, dq, anchor);
  }

#ifdef K7_PHASE_CLOCKS
  if (blockIdx.x == gridDim.x / 2 && threadIdx.x == 0) {
    for (int p = 0; p < PHASES; ++p) k7_phase_clocks[p] = phase_spent_[p];
    const long long a = clock64();
    const long long z = clock64();
    k7_phase_clocks[PHASES] = z - a;
  }
#endif
  if (!active) return;
  T* K7_RESTRICT o = out + static_cast<size_t>(b) * STATE;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    o[S_Q + 3 * leg + j] = q[j];
    o[S_DQ + 3 * leg + j] = dq[j];
  }
  o[S_ANCHOR + 3 * leg] = anchor.x;
  o[S_ANCHOR + 3 * leg + 1] = anchor.y;
  o[S_ANCHOR + 3 * leg + 2] = anchor.z;
  if (leg == 0) {
    o[S_POS] = pos.x, o[S_POS + 1] = pos.y, o[S_POS + 2] = pos.z;
    o[S_QUAT] = qw, o[S_QUAT + 1] = qx, o[S_QUAT + 2] = qy, o[S_QUAT + 3] = qz;
    o[S_VEL] = vel.x, o[S_VEL + 1] = vel.y, o[S_VEL + 2] = vel.z;
    o[S_OMEGA] = omega.x, o[S_OMEGA + 1] = omega.y, o[S_OMEGA + 2] = omega.z;
  }
}

}  // namespace

extern "C" void articulated_widths(int* out) {
  out[0] = STATE;
  out[1] = TARGETS;
  out[2] = PARAMS;
}

#ifdef __CUDACC__  // the host side: the launch and the C interface

namespace {

template <typename T>
int launch(const T* state, const T* targets, const T* params, T* out, int n_sub, int B,
           void* stream) {
  constexpr size_t bytes = sizeof(T) * STAGED;
  // Above 48 KB a block's dynamic shared memory has to be asked for.
  cudaError_t err = cudaFuncSetAttribute(articulated_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + SCENARIOS - 1) / SCENARIOS;
  articulated_kernel<T><<<blocks, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      state, targets, params, out, n_sub, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int articulated_step_f32(const float* state, const float* targets,
                                    const float* params, float* out, int n_sub, int B,
                                    void* stream) {
  return launch<float>(state, targets, params, out, n_sub, B, stream);
}

extern "C" int articulated_step_f64(const double* state, const double* targets,
                                    const double* params, double* out, int n_sub, int B,
                                    void* stream) {
  return launch<double>(state, targets, params, out, n_sub, B, stream);
}

#ifdef K7_PHASE_CLOCKS
// The clocks of the last launch (k7_phase_clocks), to host memory (synchronises).
extern "C" int articulated_clocks(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, k7_phase_clocks, sizeof(long long) * (PHASES + 1)));
}
#endif

#endif  // __CUDACC__
