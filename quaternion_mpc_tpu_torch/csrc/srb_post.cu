// K11 — the SRB plant's tick and what follows it (the walking and standing
// steps' `post`), every scenario in one launch.
//
// Replaces the region XLA fused for the JAX package at
// quaternion_mpc_tpu/sim/plant.py:109 (`step`) and the `post` stages of
// quaternion_mpc_tpu/runtime/step.py around it (:1581-1616, :1066-1195,
// :363-397, :780-895, :1452-1471, :182-200, :575-610), under jax.vmap. There
// is no Pallas kernel for it; eager PyTorch runs the port's plain version
// (runtime/step._srb_post_plain) as ~360 launches a walking tick at B = 4096.
//
// What it computes, for scenario b (runtime/step._srb_post_plain, line by
// line): in the walking mode the applied forces grf·contact and the feet
// after the tick (stance feet kept, swing feet on the FSM's target); n_sub
// midpoint steps of sim/plant.step (two evaluations of `dynamics` each: rot·Σf,
// the moments Σ p_f × f, the CoM offset's gravity moment, −ω × Iω, the push
// where one is given, I⁻¹·moment, ½G(q)ω; the quaternion renormalised), of
// dt = h (walking) or h / n_sub (standing); the safety mask (|roll| < 1,
// |pitch| < 3, every |joint velocity| < 30, every value finite, and walking
// the torso 5 cm above the terrain under it), alive, the plant kept where
// alive and the old one where not; the metrics: walking the forward velocity
// error in the yaw frame and the height error over the stance feet's ground,
// standing the height error and the attitude error 1 − |q·q_d|. The inputs
// are never written: every output is a new buffer.
//
// Every value is computed by the operations PyTorch does for the plain
// version on the card, each rounded alike (built -fmad=false,
// kernels/srb_post.FLAGS; csrc/closed_loop.cuh): the elementwise ops one at a
// time in the plain version's order; libdevice's atan2, asin, sin, cos and
// sqrt; a Python number divided into a tensor as a product with its
// reciprocal (`rcp`); torch.linalg.cross's terms fused as fma(a, b, −(c·d));
// the sums over the feet (torch.sum over a dimension that is not the
// fastest) one accumulator an element, added in order (Reduce.cuh's
// thread_reduce); the norm over the quaternion's last axis as `tnorm4`; the
// 3 x 3 inverse as the adjugate divided by the determinant; and the einsum
// products, which go to cuBLAS, in the order cuBLAS takes them at the call's
// batch size and type (`dot3`; kernels/srb_post.CUBLAS_ORDERS). So the
// outputs equal the plain version's bit for bit, and the closed loops, whose
// f32 fate is set by rounding, take the steps they took before (chip_smoke.py
// holds it at B from 4096 to 1; PERF.md). Between the batch sizes whose
// orders were measured they are a guess, and the last bits may differ there.
//
// What bounds it on an H100: bytes (kernels/srb_post.work: ~85 values read
// and ~55 written a scenario, ~0.0007 ms at f32 B = 4096); below its bound,
// one scenario's latency, the same at B = 1 as at 4096: its loads' round
// trip, then its chain of two dynamics a substep, the mask's angles and the
// metric, 1,800-2,800 instructions that one warp issues once each, in
// order, so that every instruction and every branch (a division's, a
// libdevice call's) counts (k1_phase_clocks.py k11 prints the clocks of
// each stage; PERF.md).
//
// Design: four lanes a scenario, eight scenarios a warp (GROUP, SCENARIOS in
// csrc/closed_loop.cuh), a warp a block (-DK11_WARPS builds others for
// chip_smoke.py --kernels-only's sweep); the mode (walking, standing) and the
// push's presence are template arguments.
// - Every input is loaded before the first store, in place through its
//   (batch stride, element stride) pair (batch stride 0 for a leaf every
//   scenario shares), so the controller's batch-last forces are read where
//   they lie: the plant, the parameters and the scalars in every lane of the
//   group, a foot's values (and three joints') in its lane. A warp's loads of
//   a batch-first leaf land in one run of its eight scenarios.
// - Lane f of a group is foot f: its applied force (walking: grf·contact)
//   and its feet output, written at once, and its moment p_f × f; the sums
//   Σf and Σ p_f × f are formed in every lane after shuffles, in the plain
//   version's order. The joint velocities' check is dealt over the group
//   (three joints a lane, combined by &).
// - The plant's chain runs in every lane of the group, and its independent
//   divisions (each a branch of its own, so one lane takes them in series)
//   are dealt over the lanes and handed on by shuffles: the inertia's nine,
//   three a lane; the velocity's three by the mass in each dynamics; the
//   renormalisation's four. So are the mask's libdevice calls: lanes 0, 2, 3
//   the atan2 of the roll, of the yaw and of the input attitude's yaw, lane 1
//   the asin of the pitch; the walking metric takes the stepped plant's yaw
//   or the input's, so the kept quaternion's angles are never computed again
//   (they are the bits of one of the two). In f32 the einsum products pick
//   their order by selects, not branches (`dot3s`), so that their rows
//   interleave.
// - The outputs: lane g stores element g of each vector, lane 3 the
//   scalars, so that a warp's stores of an output land contiguous. A group
//   past B (B not a multiple of 8) computes on the warp's last scenario and
//   stores nothing, so that every lane reaches every shuffle.
// Which lane does an operation never changes the operation: the parent
// design (a thread a scenario) gives the same bits, which chip_smoke.py
// --kernels-only --k11-baseline holds on the card. Staging the batch-first
// leaves and the outputs in shared memory by cp.async was measured slower:
// the copies' address arithmetic added more instructions than the loads they
// replaced (PERF.md).
//
// C interface (bound with ctypes): srb_post_f32 / _f64 take the input
// pointers (null for an absent input), their batch and element strides, the
// output pointers, the alive output, B, the substeps, the mode (1 walking),
// whether a push is given, the products' orders (enum Site, two bits a site)
// and a cudaStream_t; they launch on that stream and return the CUDA error
// of the launch. srb_post_table(out) writes the tables' sizes, so the
// wrapper checks them; srb_post_occupancy(f64, walking, ext) the blocks
// resident on an SM. Built with -DK11_PHASE_CLOCKS, lane 0 of scenario
// srb_post_clock_scenario(b)'s group stamps clock64() after each stage, read
// by srb_post_clocks (k1_phase_clocks.py k11).
//
// The device code also compiles as plain C++ (no __CUDACC__) against
// tests/cuda_emulation.h; tests/test_torch_srb_post.py holds it against the
// plain version that way.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#include <cmath>
#endif

#include "batch_last.cuh"
#include "closed_loop.cuh"

namespace {

enum Input {
  IN_POS, IN_QUAT, IN_VEL, IN_OMEGA, IN_ALIVE,        // plant (3, 4, 3, 3), alive (bool)
  IN_GRF, IN_FOOT_BODY,                               // (4, 3) body forces, feet
  IN_MASS, IN_INERTIA, IN_COM_OFFSET, IN_COM_MASS,    // (), (3, 3), (3), ()
  IN_H, IN_TARGET_HEIGHT,                             // ()
  IN_EXT_FORCE, IN_EXT_TORQUE,                        // (3) world, body; where given
  IN_JOINT_VEL,                                       // (12) where given (else zeros)
  IN_QUAT_D,                                          // (4) standing
  IN_PLAN_CONTACTS, IN_FEET, IN_TARGET_POS,           // walking: (4), (4, 3), (4, 3)
  IN_KIND, IN_GRADE, IN_RISE, IN_RUN,                 // walking: terrain world
  IN_VELX, IN_GROUND_Z,                               // walking: ()
  INPUTS
};

enum Out {
  O_NEW_POS, O_NEW_QUAT, O_NEW_VEL, O_NEW_OMEGA,  // the plant before the mask
  O_POS, O_QUAT, O_VEL, O_OMEGA,                  // the plant kept
  O_ALIVE_F,                                      // alive in the state's dtype
  O_HEIGHT_ERR,                                   // ()
  O_ERR,                                          // walking vel_err, standing att_err
  O_F_BODY, O_FEET,                               // walking: (4, 3), (4, 3)
  OUTPUTS
};

enum Site {
  S_F_WORLD, S_G_BODY, S_I_OMEGA, S_QUAT_RATE, S_OMEGA_DOT,  // sim/plant.dynamics
  S_VEL_REL,                                                 // the walking metric
  SITES
};
static_assert(2 * SITES <= 31, "the orders word holds two bits a site");

constexpr int FEET = 4;
constexpr int JOINTS = 12;
static_assert(FEET == GROUP, "lane f of a scenario's group is foot f");
#ifndef K11_WARPS
#define K11_WARPS 1  // a block's warps (chip_smoke.py --kernels-only times others)
#endif
constexpr int WARPS = K11_WARPS;
constexpr int THREADS = 32 * WARPS;

#ifndef __CUDACC__
using std::isfinite;
#endif

// torch.linalg.cross of 3-vectors: each term a_j·b_k − a_k·b_j fused as
// PyTorch's kernel computes it
template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  out[0] = fma_(a[1], b[2], -(a[2] * b[1]));
  out[1] = fma_(a[2], b[0], -(a[0] * b[2]));
  out[2] = fma_(a[0], b[1], -(a[1] * b[0]));
}

// torch.sum over the feet (a dimension other than the fastest): one
// accumulator an element from 0, added in order
template <typename T>
__device__ __forceinline__ T feet_sum(T a, T b, T c, T d) {
  return ((z0(a) + z0(b)) + z0(c)) + z0(d);
}

// dot3 of closed_loop.cuh without its branches in f32: each order's sum
// formed and the launch's picked by selects (the same operations for each
// order), so that the rows of a product interleave. f64 keeps dot3: its
// selects, two a value, took the registers past 255 and saved no time.
template <typename T>
__device__ __forceinline__ T dot3s(int order, T a0, T b0, T a1, T b1, T a2, T b2) {
  if constexpr (sizeof(T) == 8) return dot3(order, a0, b0, a1, b1, a2, b2);
  const T p0 = a0 * b0;
  const bool parity = order == PARITY;
  const T x1 = parity ? a2 : a1, y1 = parity ? b2 : b1;  // the term fused first
  const T x2 = parity ? a1 : a2, y2 = parity ? b1 : b2;  // the term after it
  const T t = fma_(x1, y1, p0);
  const T chain = fma_(x2, y2, t), split = t + x2 * y2;
  const T sums = tsum3(p0, a1 * b1, a2 * b2);
  return order == SUMS ? sums : (order == CHAIN ? chain : split);
}
template <typename T>
__device__ __forceinline__ void mv3s(int order, const T* M, const T* v, T* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = dot3s(order, M[3 * i], v[0], M[3 * i + 1], v[1], M[3 * i + 2], v[2]);
}
template <typename T>
__device__ __forceinline__ void mtv3s(int order, const T* M, const T* v, T* out) {
  for (int i = 0; i < 3; ++i) out[i] = dot3s(order, M[i], v[0], M[3 + i], v[1], M[6 + i], v[2]);
}

// The plant's parameters of one scenario
template <typename T>
struct Params {
  T mass, com_mass;
  T I[9], I_inv[9], com[3];
};

// sim/plant.dynamics at state (q, v, w): the forces' sum Σf (`fsum`) and
// their moment Σ p_f × f (`mfeet`) are the tick's, the same at every state
// (in every lane of the group; lane i < 3 divides row i of the velocity's
// rate by the mass, for all)
template <typename T, bool EXT>
__device__ __forceinline__ void dynamics(const T* q, const T* v, const T* w, const T* fsum,
                                         const T* mfeet, const Params<T>& P, const T* ext_f,
                                         const T* ext_t, int orders, int g, T* dp, T* dq, T* dv,
                                         T* dw) {
  T R[9];
  quat_to_rotmat(q, R);
  const T gv[3] = {T(0), T(0), T(0) - T(GRAVITY)};
  T tf[3], gb[3], c[3], m[3], Iw[3], gyro[3];
  mv3s(order_of(orders, S_F_WORLD), R, fsum, tf);
  mtv3s(order_of(orders, S_G_BODY), R, gv, gb);
  const T mg[3] = {P.com_mass * gb[0], P.com_mass * gb[1], P.com_mass * gb[2]};
  cross3(P.com, mg, c);
  for (int i = 0; i < 3; ++i) m[i] = mfeet[i] + c[i];
  mv3s(order_of(orders, S_I_OMEGA), P.I, w, Iw);
  cross3(w, Iw, gyro);
  for (int i = 0; i < 3; ++i) m[i] = m[i] - gyro[i];
  if (EXT) {
    for (int i = 0; i < 3; ++i) tf[i] = tf[i] + ext_f[i], m[i] = m[i] + ext_t[i];
  }
  for (int i = 0; i < 3; ++i) dp[i] = v[i];
  {
    const T qw = q[0], x = q[1], y = q[2], z = q[3];
    // lie.quat_G: [−v; w·I + skew(v)]
    const T G[12] = {-x, -y, -z,
                     qw * T(1) + T(0), qw * T(0) + -z, qw * T(0) + y,
                     qw * T(0) + z, qw * T(1) + T(0), qw * T(0) + -x,
                     qw * T(0) + -y, qw * T(0) + x, qw * T(1) + T(0)};
    for (int i = 0; i < 4; ++i)
      dq[i] = T(0.5) * dot3s(order_of(orders, S_QUAT_RATE), G[3 * i], w[0], G[3 * i + 1], w[1],
                            G[3 * i + 2], w[2]);
  }
  const T row = sel(tf, g < 3 ? g : 0) / P.mass;
  for (int i = 0; i < 3; ++i) dv[i] = gshfl(row, i) + gv[i];
  mv3s(order_of(orders, S_OMEGA_DOT), P.I_inv, m, dw);
}

// The inverse of the 3 x 3 inertia (row-major) as the adjugate over the
// determinant (batch_last.cuh inverse3's operations), its nine divisions
// dealt over the group: lane g divides elements g and g + 4, every lane
// element 8; the group's lanes hand them on.
template <typename T>
__device__ __forceinline__ void inverse3_dealt(const T* M, T* inv, int g) {
  const T A = M[0], Bv = M[1], C = M[2], D = M[3], E = M[4], F = M[5], G = M[6], H = M[7],
          I = M[8];
  const T adj[9] = {E * I - F * H, C * H - Bv * I, Bv * F - C * E,
                    F * G - D * I, A * I - C * G, C * D - A * F,
                    D * H - E * G, Bv * G - A * H, A * E - Bv * D};
  const T det = (A * adj[0] + Bv * adj[3]) + C * adj[6];
  const T lo = sel(adj, g) / det, hi = sel(adj, g + 4) / det;
  inv[8] = adj[8] / det;
  for (int k = 0; k < 4; ++k) inv[k] = gshfl(lo, k), inv[k + 4] = gshfl(hi, k);
}

// The angles the mask and the walking metric need (lie.quat_to_euler's
// operations), one libdevice call a lane: lane 0 the roll and lane 1 the
// pitch of q, lane 2 the yaw of q, lane 3 the yaw of q0; every lane returns
// the four.
template <typename T>
__device__ __forceinline__ void euler_dealt(const T* q, const T* q0, int g, T& roll, T& pitch,
                                            T& yaw, T& yaw0) {
  T e[4];
  for (int i = 0; i < 4; ++i) e[i] = g == 3 ? q0[i] : q[i];
  const T w = e[0], x = e[1], y = e[2], z = e[3];
  const T ysqr = y * y;
  T angle;
  if (g == 1) {
    angle = asin(clampv(T(2) * (w * y - z * x), T(-1), T(1)));
  } else {  // one atan2 for the three lanes
    const T roll_y = T(2) * (w * x + y * z), roll_x = T(1) - T(2) * (x * x + ysqr);
    const T yaw_y = T(2) * (w * z + x * y), yaw_x = T(1) - T(2) * (ysqr + z * z);
    angle = atan2(g == 0 ? roll_y : yaw_y, g == 0 ? roll_x : yaw_x);
  }
  roll = gshfl(angle, 0), pitch = gshfl(angle, 1), yaw = gshfl(angle, 2), yaw0 = gshfl(angle, 3);
}

#ifdef K11_PHASE_CLOCKS
constexpr int CLOCK_SLOTS = 32;
__device__ long long phase_clocks[CLOCK_SLOTS];
__device__ long long clock_scenario = -1;  // the scenario whose group's lane 0 stamps
// v computed before the stamp that follows
__device__ __forceinline__ void fence(float v) { asm volatile("" ::"f"(v)); }
__device__ __forceinline__ void fence(double v) { asm volatile("" ::"d"(v)); }
#define K11_STAMP(slot, v)                                           \
  do {                                                               \
    fence(v);                                                        \
    if (mine && b == clock_scenario && g == 0 && (slot) < CLOCK_SLOTS) \
      phase_clocks[(slot)] = clock64();                              \
  } while (0)
#else
#define K11_STAMP(slot, v)
#endif

template <typename T>
struct Args {
  const void* in[INPUTS];
  long long bs[INPUTS], es[INPUTS];
  T* out[OUTPUTS];
  bool* alive;
  int B, n_sub, orders;
};

// (one block an SM is all it asks, so that ptxas may take up to 255
// registers: at its own choice of 128 the f32 kernels spilled)
template <typename T, bool WALK, bool EXT>
__global__ void __launch_bounds__(THREADS, 1) srb_post_kernel(const Args<T> a) {
  const int lane = static_cast<int>(threadIdx.x) & 31, warp = static_cast<int>(threadIdx.x) >> 5;
  const int g = lane & (GROUP - 1), f = g;  // this lane's place in its group, and its foot
  const long long b0 = (static_cast<long long>(blockIdx.x) * WARPS + warp) * SCENARIOS;
  if (b0 >= a.B) return;  // the whole warp
  const int n_warp = a.B - b0 < SCENARIOS ? static_cast<int>(a.B - b0) : SCENARIOS;
  // a group past B computes on the warp's last scenario and stores nothing
  const bool mine = lane / GROUP < n_warp;
  const long long b = b0 + (mine ? lane / GROUP : n_warp - 1);
  K11_STAMP(0, T(0));

  // ---- every input, before any store: the plant, the parameters and the
  // scalars in every lane of the group, this lane's foot and joints
  auto in = [&](int i, int k) {
    return static_cast<const T*>(a.in[i])[b * a.bs[i] + k * a.es[i]];
  };
  T p0[3], q0[4], v0[3], w0[3];
  for (int i = 0; i < 3; ++i) p0[i] = in(IN_POS, i), v0[i] = in(IN_VEL, i), w0[i] = in(IN_OMEGA, i);
  for (int i = 0; i < 4; ++i) q0[i] = in(IN_QUAT, i);
  const bool alive_in =
      static_cast<const unsigned char*>(a.in[IN_ALIVE])[b * a.bs[IN_ALIVE]] != 0;
  T grf[3], pfb[3], jv[JOINTS / GROUP], feet[3] = {}, target[3] = {};
  T pc = T(1);
  for (int i = 0; i < 3; ++i) grf[i] = in(IN_GRF, 3 * f + i), pfb[i] = in(IN_FOOT_BODY, 3 * f + i);
  const bool joints = a.in[IN_JOINT_VEL] != nullptr;
  for (int k = 0; k < JOINTS / GROUP; ++k)
    jv[k] = joints ? in(IN_JOINT_VEL, (JOINTS / GROUP) * g + k) : T(0);
  Params<T> P;
  P.mass = in(IN_MASS, 0), P.com_mass = in(IN_COM_MASS, 0);
  for (int k = 0; k < 9; ++k) P.I[k] = in(IN_INERTIA, k);
  for (int i = 0; i < 3; ++i) P.com[i] = in(IN_COM_OFFSET, i);
  const T h = in(IN_H, 0), target_height = in(IN_TARGET_HEIGHT, 0);
  T ext_f[3] = {}, ext_t[3] = {};
  if (EXT)
    for (int i = 0; i < 3; ++i) ext_f[i] = in(IN_EXT_FORCE, i), ext_t[i] = in(IN_EXT_TORQUE, i);
  T qd[4] = {};
  int kind = FLAT;
  T grade = T(0), rise = T(0), run = T(1), velx = T(0), ground_z = T(0);
  if (WALK) {
    pc = in(IN_PLAN_CONTACTS, f);
    for (int i = 0; i < 3; ++i)
      feet[i] = in(IN_FEET, 3 * f + i), target[i] = in(IN_TARGET_POS, 3 * f + i);
    kind = static_cast<const int*>(a.in[IN_KIND])[b * a.bs[IN_KIND]];
    grade = in(IN_GRADE, 0), rise = in(IN_RISE, 0), run = in(IN_RUN, 0);
    velx = in(IN_VELX, 0), ground_z = in(IN_GROUND_Z, 0);
  } else {
    for (int i = 0; i < 4; ++i) qd[i] = in(IN_QUAT_D, i);
  }
  K11_STAMP(1, grf[2] + pfb[2] + jv[2] + P.I[8] + P.mass + h + qd[3] + ground_z + p0[0] + q0[3] +
                   v0[0] + w0[0] + pc + feet[2] + target[2]);
  inverse3_dealt(P.I, P.I_inv, g);
  K11_STAMP(2, P.I_inv[0] + P.I_inv[8]);

  // ---- this lane's foot: the applied force (walking: grf·contact) and the
  // feet after the tick (stance kept, swing on the FSM's target), written at
  // once; its moment; the sum and the moment over the feet in every lane, in
  // order
  T fb[3], cf[3];
  for (int i = 0; i < 3; ++i) fb[i] = WALK ? grf[i] * pc : grf[i];
  if (WALK && mine)
    for (int i = 0; i < 3; ++i) {
      a.out[O_F_BODY][12 * b + 3 * f + i] = fb[i];
      a.out[O_FEET][12 * b + 3 * f + i] = pc > T(0.5) ? feet[i] : target[i];
    }
  cross3(pfb, fb, cf);
  T fsum[3], mfeet[3];
  for (int i = 0; i < 3; ++i) {
    fsum[i] = feet_sum(gshfl(fb[i], 0), gshfl(fb[i], 1), gshfl(fb[i], 2), gshfl(fb[i], 3));
    mfeet[i] = feet_sum(gshfl(cf[i], 0), gshfl(cf[i], 1), gshfl(cf[i], 2), gshfl(cf[i], 3));
  }
  // every |joint velocity| < 30: three joints a lane
  int ok_joints = 1;
  for (int k = 0; k < JOINTS / GROUP; ++k) ok_joints = ok_joints & (fabs(jv[k]) < T(30));
  ok_joints = ok_joints & __shfl_xor_sync(FULL, ok_joints, 1, GROUP);
  ok_joints = ok_joints & __shfl_xor_sync(FULL, ok_joints, 2, GROUP);
  K11_STAMP(3, fsum[2] + mfeet[2] + T(ok_joints));

  // ---- n_sub midpoint steps (sim/plant.step), in every lane
  const T dt = WALK ? h : h * rcp<T>(a.n_sub);
  const T half_dt = T(0.5) * dt;
  T p[3], q[4], v[3], w[3];
  for (int i = 0; i < 3; ++i) p[i] = p0[i], v[i] = v0[i], w[i] = w0[i];
  for (int i = 0; i < 4; ++i) q[i] = q0[i];
#pragma unroll 1
  for (int s = 0; s < a.n_sub; ++s) {
    T dp[3], dq[4], dv[3], dw[3];
    dynamics<T, EXT>(q, v, w, fsum, mfeet, P, ext_f, ext_t, a.orders, g, dp, dq, dv, dw);
    K11_STAMP(4 + 3 * s, dq[3] + dv[2] + dw[2]);
    T mq[4], mv[3], mw[3];
    for (int i = 0; i < 3; ++i) mv[i] = v[i] + half_dt * dv[i], mw[i] = w[i] + half_dt * dw[i];
    for (int i = 0; i < 4; ++i) mq[i] = q[i] + half_dt * dq[i];
    dynamics<T, EXT>(mq, mv, mw, fsum, mfeet, P, ext_f, ext_t, a.orders, g, dp, dq, dv, dw);
    K11_STAMP(5 + 3 * s, dq[3] + dv[2] + dw[2]);
    for (int i = 0; i < 3; ++i)
      p[i] = p[i] + dt * dp[i], v[i] = v[i] + dt * dv[i], w[i] = w[i] + dt * dw[i];
    for (int i = 0; i < 4; ++i) q[i] = q[i] + dt * dq[i];
    const T n = tnorm4(q[0], q[1], q[2], q[3]);
    const T qg = sel(q, g) / n;  // lane i divides q_i, for all
    for (int i = 0; i < 4; ++i) q[i] = gshfl(qg, i);
    K11_STAMP(6 + 3 * s, q[0] + q[3] + p[2] + v[2] + w[2]);
  }

  // ---- the safety and divergence mask (control/safety.is_safe,
  // finite_state; walking: the floor under the torso)
  T roll, pitch, yaw, yaw0;
  euler_dealt(q, q0, g, roll, pitch, yaw, yaw0);
  bool ok = (ok_joints != 0) & (fabs(roll) < T(1)) & (fabs(pitch) < T(3));
  for (int i = 0; i < 3; ++i) ok = ok & isfinite(p[i]) & isfinite(v[i]) & isfinite(w[i]);
  for (int i = 0; i < 4; ++i) ok = ok & isfinite(q[i]);
  if (WALK) ok = ok & ((p[2] - terrain_height(kind, grade, rise, run, p[0])) > T(0.05));
  const bool alive = alive_in & ok;
  K11_STAMP(4 + 3 * a.n_sub, T(alive));

  // ---- the metrics, of the plant kept (the stepped one where alive, else
  // the input)
  T height_err, err;
  if (WALK) {
    // lane 0 the forward velocity error of the stepped plant, lane 1 of the
    // input, each in its own yaw frame
    T vv[3], Rz[9];
    for (int i = 0; i < 3; ++i) vv[i] = g & 1 ? v0[i] : v[i];
    rotz(g & 1 ? yaw0 : yaw, Rz);
    const T vel_rel =
        dot3s(order_of(a.orders, S_VEL_REL), Rz[0], vv[0], Rz[3], vv[1], Rz[6], vv[2]);
    const T e_lane = fabs(vel_rel - velx);
    const T e_new = gshfl(e_lane, 0), e_old = gshfl(e_lane, 1);
    err = alive ? e_new : e_old;
    height_err = fabs(((alive ? p[2] : p0[2]) - ground_z) - target_height);
  } else {
    T kq[4];
    for (int i = 0; i < 4; ++i) kq[i] = alive ? q[i] : q0[i];
    height_err = fabs((alive ? p[2] : p0[2]) - target_height);
    err = T(1) - fabs(tsum4(kq[0] * qd[0], kq[1] * qd[1], kq[2] * qd[2], kq[3] * qd[3]));
  }
  K11_STAMP(5 + 3 * a.n_sub, height_err + err);

  // ---- the outputs: lane g element g of each vector, lane 3 the scalars;
  // the warp's stores of an output land contiguous
  if (mine) {
    if (g < 3) {
      const T pg = sel(p, g), vg = sel(v, g), wg = sel(w, g);
      a.out[O_NEW_POS][3 * b + g] = pg, a.out[O_NEW_VEL][3 * b + g] = vg;
      a.out[O_NEW_OMEGA][3 * b + g] = wg;
      a.out[O_POS][3 * b + g] = alive ? pg : sel(p0, g);
      a.out[O_VEL][3 * b + g] = alive ? vg : sel(v0, g);
      a.out[O_OMEGA][3 * b + g] = alive ? wg : sel(w0, g);
    } else {
      a.out[O_ALIVE_F][b] = T(alive);
      a.out[O_HEIGHT_ERR][b] = height_err;
      a.out[O_ERR][b] = err;
      a.alive[b] = alive;
    }
    const T qg = sel(q, g);
    a.out[O_NEW_QUAT][4 * b + g] = qg;
    a.out[O_QUAT][4 * b + g] = alive ? qg : sel(q0, g);
  }
  K11_STAMP(6 + 3 * a.n_sub, T(0));
}

template <typename T, bool WALK, bool EXT>
int launch_mode(const Args<T>& a, void* stream) {
  constexpr int PER_BLOCK = WARPS * SCENARIOS;
  const int blocks = static_cast<int>((static_cast<long long>(a.B) + PER_BLOCK - 1) / PER_BLOCK);
#ifdef __CUDACC__
  srb_post_kernel<T, WALK, EXT><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
#else
  (void)stream;
  return emulate_blocks(blocks, THREADS, srb_post_kernel<T, WALK, EXT>, a);
#endif
}

template <typename T>
int launch(const void* const* in, const long long* bs, const long long* es, void* const* out,
           void* alive, int B, int n_sub, int walking, int ext, int orders, void* stream) {
  if (n_sub < 1) return 1;  // cudaErrorInvalidValue
  Args<T> a;
  for (int i = 0; i < INPUTS; ++i) a.in[i] = in[i], a.bs[i] = bs[i], a.es[i] = es[i];
  for (int o = 0; o < OUTPUTS; ++o) a.out[o] = static_cast<T*>(out[o]);
  a.alive = static_cast<bool*>(alive);
  a.B = B, a.n_sub = n_sub, a.orders = orders;
  return walking ? (ext ? launch_mode<T, true, true>(a, stream)
                         : launch_mode<T, true, false>(a, stream))
                 : (ext ? launch_mode<T, false, true>(a, stream)
                        : launch_mode<T, false, false>(a, stream));
}

#ifdef __CUDACC__
template <typename T, bool WALK, bool EXT>
int mode_occupancy() {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, srb_post_kernel<T, WALK, EXT>, THREADS, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
template <typename T>
int occupancy(int walking, int ext) {
  return walking ? (ext ? mode_occupancy<T, true, true>() : mode_occupancy<T, true, false>())
                 : (ext ? mode_occupancy<T, false, true>() : mode_occupancy<T, false, false>());
}
#endif

}  // namespace

extern "C" {

int srb_post_f32(const void* const* in, const long long* bs, const long long* es,
                 void* const* out, void* alive, int B, int n_sub, int walking, int ext,
                 int orders, void* stream) {
  return launch<float>(in, bs, es, out, alive, B, n_sub, walking, ext, orders, stream);
}

int srb_post_f64(const void* const* in, const long long* bs, const long long* es,
                 void* const* out, void* alive, int B, int n_sub, int walking, int ext,
                 int orders, void* stream) {
  return launch<double>(in, bs, es, out, alive, B, n_sub, walking, ext, orders, stream);
}

void srb_post_table(int* out) {
  out[0] = INPUTS;
  out[1] = OUTPUTS;
  out[2] = SITES;
}

#ifdef __CUDACC__
// Blocks of the kernel resident on an SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
int srb_post_occupancy(int f64, int walking, int ext) {
  return f64 ? occupancy<double>(walking, ext) : occupancy<float>(walking, ext);
}
#endif

#ifdef K11_PHASE_CLOCKS
// The scenario whose group's lane 0 stamps in the launches after it; every
// stamp set to 0.
int srb_post_clock_scenario(long long b) {
  static const long long zeros[CLOCK_SLOTS] = {};
  cudaError_t err = cudaMemcpyToSymbol(phase_clocks, zeros, sizeof(zeros));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(clock_scenario, &b, sizeof(long long));
  return static_cast<int>(err);
}
// The first n stamps since (CLOCK_SLOTS at most), to host memory
// (synchronises).
int srb_post_clocks(long long* out, int n) {
  if (n > CLOCK_SLOTS) n = CLOCK_SLOTS;
  return static_cast<int>(cudaMemcpyFromSymbol(out, phase_clocks, sizeof(long long) * n));
}
#endif

}  // extern "C"
