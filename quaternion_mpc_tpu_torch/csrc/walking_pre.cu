// K10 — the walking tick's stage before the solve (`pre`), every scenario in
// one launch.
//
// Replaces the region XLA fused for the JAX package at
// quaternion_mpc_tpu/runtime/step.py:1516-1580 (`pre`, under jax.vmap at
// :1620; the estimated twin at :996-1063). There is no Pallas kernel for it;
// eager PyTorch runs the port's plain version (runtime/step._walking_pre_plain)
// as ~1,100 launches a tick at B = 4096.
//
// What it computes, for scenario b (runtime/step._walking_pre_plain, line by
// line): the body-frame feet Rᵀ(p_f − p); the contact flags of the gait
// state; the pinned-feet joint state (IK, the closed-form J⁻¹, dq clamped to
// ±21); the Raibert footholds snapped to the terrain (flat, slope, stairs);
// the gait FSM with its rate-limited, latched foothold and the quintic or
// clearing swing target; the planned contacts and, where asked, the (N+1, 4)
// contact schedule; the goal update with its two 3-channel window filters and
// the sinusoidal attitude mode; the ground height under the stance feet; the
// terrain update (the weighted plane fit, the dihedral angle, its window
// filter, the clamp and the signed pitch); and the desired attitude pitched by
// it. The inputs are never written: every output is a new buffer.
//
// Every value is computed by the operations PyTorch does for the plain
// version on the card, each rounded alike (built -fmad=false,
// kernels/walking_pre.FLAGS): the elementwise ops one at a time in the plain
// version's order; libdevice's sin, cos, atan2, asin, acos and sqrt as
// PyTorch calls them; a Python scalar rounded to T before it meets a tensor,
// and divided into a tensor as a product with its reciprocal in T (`rcp`,
// PyTorch's division by a host scalar); `c / t` of a Python scalar c as
// reciprocal(t)·c (torch.Tensor.__rtruediv__); torch.remainder by fmod;
// torch.linalg.cross's terms fused as fma(a, b, −(c·d)); every torch.sum,
// torch.linalg.norm and vector_norm over the last, contiguous axis in the
// order of PyTorch's CUDA reduction for it (Reduce.cuh: `tsum3`, `tsum4`,
// `window_mean`); and the einsum products, which go to cuBLAS, in the order
// cuBLAS takes them at the call's batch size and type (`dot3`, `dot4`;
// kernels/walking_pre.CUBLAS_ORDERS). So the outputs equal the plain
// version's bit for bit, and the closed loops, whose f32 fate is set by
// rounding, take the steps they took before (chip_smoke.py holds it at B
// from 4096 to 1; PERF.md). Between the batch sizes whose orders were
// measured they are a guess, and the last bits may differ there.
//
// What bounds it on an H100: bytes (kernels/walking_pre.work: the three
// 100-slot window buffers are 700 of a scenario's ~1,000 values each way);
// below its bound, one scenario's serial chain (libdevice's functions, the
// divisions, each with its slow path's branch) and, at a fleet's size, the
// bursts of those buffers' bytes (k1_phase_clocks.py k10 prints the clocks
// of each stage; PERF.md).
//
// Design: four lanes a scenario, eight scenarios a warp (GROUP, SCENARIOS),
// one warp a block (WARPS; chip_smoke.py --kernels-only times two and four).
// - Every input is read before the first store: a scenario's values into
//   registers at the top, then the window buffers of the warp's eight
//   scenarios into shared memory by cp.async (16 bytes a copy where
//   aligned), landing while the chain runs.
// - Lane g of a group is leg g: its body-frame foot, IK and J⁻¹, Raibert
//   foothold and snap, FSM, swing curve and contact schedule over every knot;
//   the legs' planned contacts reach the group by shuffles of width 4. The
//   scenario's chain (attitude, goal, plane fit, pitched attitude) runs in
//   every lane of the group, and where it has independent parts of one kind
//   they are dealt over the lanes: the goal's four divisions by the norm, the
//   plane fit's solve a row a lane, the means' divisions, the pitched
//   attitude's three half angles' cosines and sines.
// - The window filters: the new values written into the staged copies, the
//   buffers written out from them, coalesced, and their masked sums read from
//   them in PyTorch's reduction order over four lanes (group_sum). A group
//   past B (B not a multiple of 8) computes on the warp's last scenario and
//   stores nothing, so that every lane reaches every shuffle.
// Which lane does an operation never changes the operation: another layout
// of the same arithmetic (one warp a scenario, say) gives the same bits,
// which chip_smoke.py --kernels-only --k10-baseline holds on the card.
//
// Layout: every input is read through its batch stride (0 for a leaf every
// scenario shares: the terrain's scalars, the leg geometry, the default
// stance, the pattern tables, the gait frequency), its own values contiguous
// in the order of enum Input. Outputs are contiguous (B, ...) buffers in the
// order of enum Out and enum OutInt.
//
// C interface (bound with ctypes): walking_pre_f32 / _f64 take the input
// pointers and batch strides, the float and int output pointers, B, the goal
// filters' and the terrain filter's windows (1 to MAX_WINDOW), the pattern's
// segment count (1 to MAX_SEG), the contact schedule's knots (0: none), the
// products' orders (enum Site, two bits a site), ½ / gait_freq as the
// caller's Python float, and a cudaStream_t; they launch on that stream and
// return the CUDA error of the launch. walking_pre_table(out) writes the
// tables' sizes and the count of product sites, so the wrapper checks them;
// walking_pre_occupancy(f64, w, wt) the blocks resident on an SM. Built with
// -DK10_PHASE_CLOCKS, the group of scenario walking_pre_clock_scenario(b)
// stamps clock64() after each stage (lane 0), read by walking_pre_clocks
// (k1_phase_clocks.py k10).
//
// The device code also compiles as plain C++ (no __CUDACC__) against
// tests/cuda_emulation.h; tests/test_torch_walking_pre.py holds it against the
// plain version that way.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#include <cmath>
#define __host__
#endif

#include "batch_last.cuh"
#include "closed_loop.cuh"

namespace {

enum Input {
  IN_POS, IN_QUAT, IN_VEL, IN_OMEGA, IN_EST_POS, IN_EST_VEL,  // plant (3, 4, 3, 3), estimate
  IN_FEET,                                                       // (4, 3) world feet
  IN_PHASE, IN_SEG_IDX, IN_SEG_START, IN_SWING_START, IN_TARGET_POS, IN_TARGET_VEL,
  IN_TERRAIN_H, IN_FOOTHOLD,                                     // gait state (4), (4, 3)
  IN_POS_D, IN_QUAT_D,                                           // goal (3), (4)
  IN_VEL_BUF, IN_VEL_IDX, IN_VEL_COUNT, IN_POS_BUF, IN_POS_IDX, IN_POS_COUNT,  // (3, w), (3)
  IN_ATT_COUNT,
  IN_ANGLE_BUF, IN_ANGLE_IDX, IN_ANGLE_COUNT, IN_TERRAIN_ANGLE,  // terrain estimate (w), ()
  IN_H, IN_TARGET_HEIGHT,
  IN_KIND, IN_GRADE, IN_RISE, IN_RUN,                            // terrain world
  IN_RHO, IN_DEFAULT_REL,                                        // (4, 5), (4, 3)
  IN_VELX, IN_VELY, IN_BODY_HEIGHT, IN_ROLL_RATE, IN_PITCH_RATE, IN_YAW_RATE,
  IN_SIN_ANG_VEL,                                                // bool
  IN_STATES, IN_SWITCH_TIME, IN_N_SEG,                           // (4, S) int32, f64; (4)
  IN_GF,                                                         // gait frequency ()
  INPUTS
};

enum Out {
  O_FOOT_BODY,       // (4, 3)
  O_CONTACTS_NOW,    // (4)
  O_JOINT_POS,       // (12)
  O_JOINT_VEL,       // (12)
  O_POS_BODY_D,      // (3) command
  O_VEL_BODY_D,      // (3)
  O_QUAT_CMD,        // (4) pitched
  O_ANG_VEL_D,       // (3)
  O_SCHEDULE,        // (n_knots, 4), where asked
  O_POS_D,           // (3) goal state
  O_QUAT_D,          // (4) unpitched
  O_VEL_BUF,         // (3, w)
  O_POS_BUF,         // (3, w)
  O_ATT_COUNT,       // ()
  O_PHASE,           // (4) gait state
  O_SEG_START,       // (4)
  O_SWING_START,     // (4, 3)
  O_TARGET_POS,      // (4, 3)
  O_TARGET_VEL,      // (4, 3)
  O_TARGET_ACC,      // (4, 3)
  O_TERRAIN_H,       // (4)
  O_FOOTHOLD,        // (4, 3)
  O_PLAN_CONTACTS,   // (4)
  O_ANGLE_BUF,       // (w) terrain estimate
  O_TERRAIN_ANGLE,   // ()
  O_SURF_COEF,       // (3)
  O_GROUND_Z,        // ()
  OUTPUTS
};

enum OutInt {
  OI_VEL_IDX, OI_VEL_COUNT, OI_POS_IDX, OI_POS_COUNT,  // (3)
  OI_SEG_IDX,                                          // (4)
  OI_ANGLE_IDX, OI_ANGLE_COUNT,                        // ()
  OUTPUTS_INT
};

constexpr int LEGS = 4;
constexpr double PI = 3.141592653589793;
#ifndef K10_WARPS
#define K10_WARPS 1  // a block's warps (chip_smoke.py --kernels-only times others)
#endif
constexpr int WARPS = K10_WARPS;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_SEG = 4;  // a leg's pattern segments (gait/schedule.MAX_SEG)
constexpr int MAX_WINDOW = 127;  // a window filter's slots: PyTorch's sum of them is one pass
constexpr int PAD = 4;  // a warp's shared memory past its windows: their zero, 16 bytes aligned
constexpr int SWING = 0, STANCE = 1;
#ifdef __CUDACC__
#define K10_NOINLINE __device__ __noinline__
#else
#define K10_NOINLINE
#endif

enum Site {
  S_FOOT, S_VREL, S_DQ,                     // Rᵀ(p_f − p), Rᵀ(v_f − v), J⁻¹·v
  S_RZ_VEL, S_RZ_DELTA, S_RZ_REL,           // Raibert: Rzᵀ·v, Rz·Δ, Rz·p_rel
  S_RZ_VD, S_VBODY, S_PBODY, S_QUAT_RATE,   // goal: Rz·v_d, Rᵀ·v_d, Rᵀ(p_d − p), G(q)·ω
  S_WTW, S_WTZ, S_SOL,                      // plane fit: WᵀW, Wᵀz, (WᵀW)⁻¹·Wᵀz
  SITES
};
static_assert(2 * SITES <= 31, "the orders word holds two bits a site");

// kin.leg.ik (knee-backward branch)
template <typename T>
__device__ __forceinline__ void leg_ik(const T* p, const T* rho, T* q) {
  const T ox = rho[0], oy = rho[1], d = rho[2], lt = rho[3], lc = rho[4];
  const T px = p[0] - ox, py = p[1] - oy, pz = p[2];
  const T r2 = py * py + pz * pz;
  const T s2 = clamp_min(r2 - d * d, T(1e-12));
  const T s = sqrt(s2);
  T q1 = atan2(pz, py) + atan2(s, d);
  q1 = remainderv(q1 + T(PI), T(2 * PI)) - T(PI);
  const T lo = (lt - lc) * (lt - lc) + T(1e-12);
  const T hi = (lt + lc) * (lt + lc) - T(1e-12);
  const T dist2 = minv(maxv(px * px + s2, lo), hi);
  const T cos_knee = (dist2 - lt * lt - lc * lc) / (T(2) * lt * lc);
  const T q3 = -acos(clampv(cos_knee, T(-1), T(1)));
  const T q2 = atan2(-px, s) - atan2(lc * sin(q3), lt + lc * cos(q3));
  q[0] = q1, q[1] = q2, q[2] = q3;
}

// kin.leg.jac, row-major
template <typename T>
__device__ __forceinline__ void leg_jac(const T* q, const T* rho, T* J) {
  const T d = rho[2], lt = rho[3], lc = rho[4];
  const T s1 = sin(q[0]), c1 = cos(q[0]);
  const T s2 = sin(q[1]), c2 = cos(q[1]);
  const T q23 = q[1] + q[2];
  const T s23 = sin(q23), c23 = cos(q23);
  const T ext = lt * c2 + lc * c23;
  const T dext2 = -lt * s2 - lc * s23;
  const T dext3 = -lc * s23;
  J[0] = T(0), J[1] = -lt * c2 - lc * c23, J[2] = -lc * c23;
  J[3] = -d * s1 + ext * c1, J[4] = dext2 * s1, J[5] = dext3 * s1;
  J[6] = d * c1 + ext * s1, J[7] = -dext2 * c1, J[8] = -dext3 * c1;
}

// gait.swing._smoothstep and its derivatives
template <typename T>
__device__ __forceinline__ T smoothstep(T s) {
  const T c = clampv(s, T(0), T(1));
  return c * c * (T(3) - T(2) * c);
}
template <typename T>
__device__ __forceinline__ T smoothstep_d(T s) {
  const bool inside = (s >= T(0)) & (s <= T(1));
  const T c = clampv(s, T(0), T(1));
  return inside ? T(6) * c * (T(1) - c) : T(0);
}
template <typename T>
__device__ __forceinline__ T smoothstep_dd(T s) {
  const bool inside = (s >= T(0)) & (s <= T(1));
  const T c = clampv(s, T(0), T(1));
  return inside ? T(6) - T(12) * c : T(0);
}

// gait.swing.quintic_swing_target with its switch to clearing_swing_target,
// at time t of a swing of duration Tw from ps to pe
template <typename T>
__device__ __forceinline__ void swing_target(T t, T Tw, const T* ps, const T* pe, T* pos, T* vel,
                                             T* acc) {
  constexpr double Z_APEX = 0.1, CLEARING_RISE = 0.06, F_UP = 0.4, F_FWD = 0.9;
  if ((pe[2] - ps[2]) > T(CLEARING_RISE)) {
    const T s = t / clamp_min(Tw, T(1e-9));
    const T z_s = ps[2], z_e = pe[2];
    const T apex = maxv(z_s, z_e) + T(Z_APEX);
    const T s1 = s * rcp<T>(F_UP);
    const T s2 = (s - T(F_UP)) * rcp<T>(F_FWD - F_UP);
    const T s3 = (s - T(F_FWD)) * rcp<T>(1.0 - F_FWD);
    const T u1 = smoothstep(s1), u2 = smoothstep(s2), u3 = smoothstep(s3);
    const T t1 = T(F_UP) * Tw, t2 = T(F_FWD - F_UP) * Tw, t3 = T(1.0 - F_FWD) * Tw;
    const T d1 = smoothstep_d(s1) / t1, d2 = smoothstep_d(s2) / t2, d3 = smoothstep_d(s3) / t3;
    const T a1 = smoothstep_dd(s1) / (t1 * t1), a2 = smoothstep_dd(s2) / (t2 * t2),
            a3 = smoothstep_dd(s3) / (t3 * t3);
    pos[2] = z_s + (apex - z_s) * u1 - (apex - z_e) * u3;
    vel[2] = (apex - z_s) * d1 - (apex - z_e) * d3;
    acc[2] = (apex - z_s) * a1 - (apex - z_e) * a3;
    for (int i = 0; i < 2; ++i) {
      const T dxy = pe[i] - ps[i];
      pos[i] = ps[i] + dxy * u2;
      vel[i] = dxy * d2;
      acc[i] = dxy * a2;
    }
    return;
  }
  const T dx = pe[0] - ps[0], dy = pe[1] - ps[1];
  const T v_xy_mid = ((T(1) / Tw) * T(1.26)) * sqrt(dx * dx + dy * dy);
  const T theta = atan2(fabs(dy), fabs(dx));
  const T vmid_x = signv(dx) * v_xy_mid * cos(theta);
  const T vmid_y = signv(dy) * v_xy_mid * sin(theta);
  const T apex = maxv(ps[2], pe[2]) + T(Z_APEX);
  const T s = t / Tw;
  for (int i = 0; i < 3; ++i) {
    const T p0 = ps[i], pT = pe[i];
    const T v0 = i == 2 ? T(0) + T(0.1) : T(0);
    const T vT = i == 2 ? T(0) + T(-0.1) : T(0);
    const T mid = i == 2 ? apex : T(0.5) * (p0 + pT);
    const T vmid = i == 0 ? vmid_x : (i == 1 ? vmid_y : T(0));
    // gait.swing._quintic_coeffs
    const T a1 = Tw * v0;
    const T r1 = pT - p0 - a1;
    const T r2 = Tw * vT - a1;
    const T r3 = mid - p0 - T(0.5) * a1;
    const T r4 = Tw * vmid - a1;
    const T a2 = T(7) * r1 - r2 + T(16) * r3 - T(8) * r4;
    const T a3 = T(-34) * r1 + T(5) * r2 - T(32) * r3 + T(32) * r4;
    const T a4 = T(52) * r1 - T(8) * r2 + T(16) * r3 - T(40) * r4;
    const T a5 = T(-24) * r1 + T(4) * r2 + T(16) * r4;
    pos[i] = p0 + s * (a1 + s * (a2 + s * (a3 + s * (a4 + s * a5))));
    vel[i] = (a1 + s * (T(2) * a2 + s * (T(3) * a3 + s * (T(4) * a4 + s * T(5) * a5)))) / Tw;
    acc[i] = (T(2) * a2 + s * (T(6) * a3 + s * (T(12) * a4 + s * T(20) * a5))) / (Tw * Tw);
  }
}

// The block width of PyTorch's CUDA reduction over a contiguous last axis of
// n < 128 elements with `rows` outputs (Reduce.cuh setReduceConfig and
// set_block_dimension; 512 threads a block).
__host__ __device__ inline int reduce_width(int n, long long rows) {
  auto last_pow2 = [](long long v) {
    long long p = 1;
    while (p * 2 <= v) p *= 2;
    return p;
  };
  const long long d0 = last_pow2(n), d1 = rows < 512 ? last_pow2(rows) : 512;
  const long long bw0 = d0 < 32 ? d0 : 32;
  const long long bh = d1 < 512 / bw0 ? d1 : 512 / bw0;
  return static_cast<int>(d0 < 512 / bh ? d0 : 512 / bh);
}

// A window filter's masked sum Σ buf·(slot < count) over the staged new
// buffer `buf` (n ≤ MAX_WINDOW slots) in the order of PyTorch's reduction of
// WIDTH lanes (0: `width`, known at run time), by a scenario's group.
// PyTorch's lane t sums its elements t + width·m in accumulator m mod 4
// (width ≥ min(n's last power of two, 32), so m < 4: one pass; at width 64
// the lanes t and t + 32 meet first), then the lanes meet by the
// __shfl_down tree of offsets 16, 8, 4, 2, 1. Lane j of the group takes the
// lanes t ≡ j (mod 4) and the tree's levels 16, 8 and 4 on them, whose
// partners share that residue; levels 2 and 1 are shuffles in the group.
// Every lane of the group returns the sum. A slot past the end reads
// `zero` and adds 0 + 0·0 = +0, PyTorch's untouched accumulator: no load
// waits behind a branch. The widths of a fleet's and of a few robots'
// filters (32, 64) are template arguments, the others a call.
template <int WIDTH, typename T>
__device__ __forceinline__ T group_sum(const T* buf, const T* zero, int n, int count,
                                       int width_rt, int j) {
  const int width = WIDTH ? WIDTH : width_rt;
  auto acc = [&](int s) {
    if (s > MAX_WINDOW) return T(0);  // never a slot: known at compile time where WIDTH is
    const T x = *(s < n ? buf + s : zero);
    return T(0) + x * (s < count ? T(1) : T(0));
  };
  auto part = [&](int t) {
    const T a0 = acc(t), a1 = acc(t + width), a2 = acc(t + 2 * width), a3 = acc(t + 3 * width);
    return ((a0 + a1) + a2) + a3;
  };
  const int W = width < 32 ? width : 32;  // the tree's lanes
  T p[32 / GROUP];                        // p[i]: PyTorch's lane j + 4i
#pragma unroll
  for (int i = 0; i < 32 / GROUP; ++i) {
    const int t = j + GROUP * i;
    p[i] = t < W ? part(t) : T(0);
    if (width > 32) p[i] = p[i] + part(t + 32);
  }
#pragma unroll
  for (int off = 16; off >= GROUP; off /= 2)
    if (off < W) {
#pragma unroll
      for (int i = 0; i < off / GROUP; ++i) p[i] = p[i] + p[i + off / GROUP];
    }
  if (W > 2) p[0] = p[0] + gshfl_down(p[0], 2);
  if (W > 1) p[0] = p[0] + gshfl_down(p[0], 1);
  return gshfl(p[0], 0);
}
template <typename T>
K10_NOINLINE T group_sum_any(const T* buf, const T* zero, int n, int count, int width, int j) {
  return group_sum<0>(buf, zero, n, count, width, j);
}
template <typename T>
__device__ __forceinline__ T group_sum(const T* buf, const T* zero, int n, int count, int width,
                                       int j) {
  if (width == 32) return group_sum<32>(buf, zero, n, count, width, j);
  if (width == 64) return group_sum<64>(buf, zero, n, count, width, j);
  return group_sum_any(buf, zero, n, count, width, j);
}

// 16 bytes, the unit of the wide copies below
struct alignas(16) Chunk {
  unsigned int v[4];
};

// One element, or 16 bytes, from device memory to shared memory,
// asynchronously.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
#ifdef __CUDACC__
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src) : "memory");
  else if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(to), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Whether p lies on a 16-byte boundary and n elements of T fill whole Chunks
template <typename T>
__device__ __forceinline__ bool chunked(const T* p, int n) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0 && n % (16 / sizeof(T)) == 0;
}

// A window buffer of the warp's n scenarios (`len` values each, scenario s's
// at src + s·bs) to shared memory at dst + s·len (16 bytes aligned), by
// cp.async over the warp's lanes: one run where the scenarios' values are
// contiguous, 16 bytes a copy where it is aligned; and back, from shared
// memory to the contiguous output.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long bs, int len, int n,
                                      int lane) {
  if (bs == len || n == 1) {
    const int total = n * len;
    if (chunked(src, total)) {
      const int chunks = total / (16 / static_cast<int>(sizeof(T)));
#pragma unroll 4
      for (int e = lane; e < chunks; e += 32)
        cp_async(reinterpret_cast<Chunk*>(dst) + e, reinterpret_cast<const Chunk*>(src) + e);
    } else {
#pragma unroll 4
      for (int e = lane; e < total; e += 32) cp_async(dst + e, src + e);
    }
  } else {
    for (int s = 0; s < n; ++s) {
#pragma unroll 4
      for (int r = lane; r < len; r += 32) cp_async(dst + s * len + r, src + s * bs + r);
    }
  }
}
template <typename T>
__device__ __forceinline__ void unstage(T* __restrict__ dst, const T* __restrict__ src, int total,
                                        int lane) {
  if (chunked(dst, total)) {
    const int chunks = total / (16 / static_cast<int>(sizeof(T)));
#pragma unroll 4
    for (int e = lane; e < chunks; e += 32)
      reinterpret_cast<Chunk*>(dst)[e] = reinterpret_cast<const Chunk*>(src)[e];
  } else {
#pragma unroll 4
    for (int e = lane; e < total; e += 32) dst[e] = src[e];
  }
}

#ifdef K10_PHASE_CLOCKS
constexpr int CLOCK_SLOTS = 32;
__device__ long long phase_clocks[CLOCK_SLOTS];
__device__ long long clock_scenario = -1;  // the scenario whose group's lane 0 stamps
#define K10_STAMP(slot)                                                           \
  do {                                                                            \
    if (mine && b == clock_scenario && g == 0 && (slot) < CLOCK_SLOTS)            \
      phase_clocks[(slot)] = clock64();                                           \
  } while (0)
#else
#define K10_STAMP(slot)
#endif

template <typename T>
struct Args {
  const void* in[INPUTS];
  long long bs[INPUTS];
  T* out[OUTPUTS];
  int* out_int[OUTPUTS_INT];
  int B, w_goal, w_terrain, n_seg_max, n_knots, orders;
  int width_goal, width_terrain;  // PyTorch's reduction widths of the filters' sums
  double t_half_stance;
};

template <typename T>
__host__ __device__ inline size_t smem_bytes(int w_goal, int w_terrain) {
  return sizeof(T) * WARPS * (SCENARIOS * static_cast<size_t>(6 * w_goal + w_terrain) + PAD);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) walking_pre_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = static_cast<int>(threadIdx.x) & 31, warp = static_cast<int>(threadIdx.x) >> 5;
  const int g = lane & (GROUP - 1), f = g;  // this lane's place in its group, and its leg
  const long long b0 = (static_cast<long long>(blockIdx.x) * WARPS + warp) * SCENARIOS;
  if (b0 >= a.B) return;  // the whole warp
  const int n_warp = a.B - b0 < SCENARIOS ? static_cast<int>(a.B - b0) : SCENARIOS;
  // a group past B computes on the warp's last scenario and stores nothing
  const int q = lane / GROUP;
  const bool mine = q < n_warp;
  const long long b = b0 + (mine ? q : n_warp - 1);
  K10_STAMP(0);

  // ---- every input, before any store: this scenario's values into
  // registers first, then the window buffers of the warp's scenarios staged
  // in shared memory by cp.async (the vel (3, wg) buffers of its scenarios
  // one after the other from vbuf, the pos buffers from pbuf, the angle (wt)
  // buffers from abuf), landing while the chain below runs
  auto fin = [&](int i) { return static_cast<const T*>(a.in[i]) + b * a.bs[i]; };
  auto iin = [&](int i) { return static_cast<const int*>(a.in[i]) + b * a.bs[i]; };

  T pos[3], quat[4], vel[3], omega[3], est_pos[3], est_vel[3], feet[LEGS][3], fw[3];
  for (int i = 0; i < 3; ++i) {
    pos[i] = fin(IN_POS)[i], vel[i] = fin(IN_VEL)[i], omega[i] = fin(IN_OMEGA)[i];
    est_pos[i] = fin(IN_EST_POS)[i], est_vel[i] = fin(IN_EST_VEL)[i];
    fw[i] = fin(IN_FEET)[3 * f + i];
  }
  for (int i = 0; i < 4; ++i) quat[i] = fin(IN_QUAT)[i];
  for (int l = 0; l < LEGS; ++l)
    for (int i = 0; i < 3; ++i) feet[l][i] = fin(IN_FEET)[3 * l + i];
  const T h = fin(IN_H)[0], gf = fin(IN_GF)[0];
  const int kind = iin(IN_KIND)[0];
  const T grade = fin(IN_GRADE)[0], rise = fin(IN_RISE)[0], run = fin(IN_RUN)[0];
  // this leg's gait state, geometry, stance and pattern row
  const int S = a.n_seg_max;
  const int seg_idx = iin(IN_SEG_IDX)[f], n_seg = iin(IN_N_SEG)[f];
  const T phase_in = fin(IN_PHASE)[f], seg_start_in = fin(IN_SEG_START)[f];
  const T terrain_h_in = fin(IN_TERRAIN_H)[f];
  T swing_in[3], tpos_in[3], tvel_in[3], old_hold[3], rho[5], dr[3];
  for (int i = 0; i < 3; ++i) {
    swing_in[i] = fin(IN_SWING_START)[3 * f + i], tpos_in[i] = fin(IN_TARGET_POS)[3 * f + i];
    tvel_in[i] = fin(IN_TARGET_VEL)[3 * f + i], old_hold[i] = fin(IN_FOOTHOLD)[3 * f + i];
    dr[i] = fin(IN_DEFAULT_REL)[3 * f + i];
  }
  for (int i = 0; i < 5; ++i) rho[i] = fin(IN_RHO)[5 * f + i];
  int states[MAX_SEG];
  double switch_time[MAX_SEG];
  {
    const int* st = iin(IN_STATES) + f * S;
    const double* sw = static_cast<const double*>(a.in[IN_SWITCH_TIME]) + b * a.bs[IN_SWITCH_TIME]
                       + f * S;
#pragma unroll
    for (int j = 0; j < MAX_SEG; ++j) {
      states[j] = j < S ? st[j] : STANCE;
      switch_time[j] = j < S ? sw[j] : 1.0;
    }
  }
  // the goal, the joystick, the terrain estimate, the filters' places
  const T pos_d_in[2] = {fin(IN_POS_D)[0], fin(IN_POS_D)[1]};
  T qd[4];
  for (int i = 0; i < 4; ++i) qd[i] = fin(IN_QUAT_D)[i];
  const T vd_rel[3] = {fin(IN_VELX)[0], fin(IN_VELY)[0], T(0)};
  const T body_height = fin(IN_BODY_HEIGHT)[0];
  const T ang_vel_d[3] = {fin(IN_ROLL_RATE)[0], fin(IN_PITCH_RATE)[0], fin(IN_YAW_RATE)[0]};
  const T att_count = fin(IN_ATT_COUNT)[0];
  const bool sin_mode =
      static_cast<const unsigned char*>(a.in[IN_SIN_ANG_VEL])[b * a.bs[IN_SIN_ANG_VEL]] != 0;
  const T target_height = fin(IN_TARGET_HEIGHT)[0], terrain_angle = fin(IN_TERRAIN_ANGLE)[0];
  int vi[3], vc[3], pi[3], pcn[3];
  for (int c = 0; c < 3; ++c) {
    vi[c] = iin(IN_VEL_IDX)[c], vc[c] = iin(IN_VEL_COUNT)[c];
    pi[c] = iin(IN_POS_IDX)[c], pcn[c] = iin(IN_POS_COUNT)[c];
  }
  const int ai = iin(IN_ANGLE_IDX)[0], ac = iin(IN_ANGLE_COUNT)[0];
  const int wg = a.w_goal, wt = a.w_terrain;
  T* const vbuf = reinterpret_cast<T*>(smem_raw) +
                  static_cast<long long>(warp) * (SCENARIOS * (6 * wg + wt) + PAD);
  T* const pbuf = vbuf + SCENARIOS * 3 * wg;
  T* const abuf = pbuf + SCENARIOS * 3 * wg;
  T* const zero = abuf + SCENARIOS * wt;  // what a window's slot past its end reads
  if (lane == 0) *zero = T(0);
  auto first = [&](int i) { return static_cast<const T*>(a.in[i]) + b0 * a.bs[i]; };
  stage(vbuf, first(IN_VEL_BUF), a.bs[IN_VEL_BUF], 3 * wg, n_warp, lane);
  stage(pbuf, first(IN_POS_BUF), a.bs[IN_POS_BUF], 3 * wg, n_warp, lane);
  stage(abuf, first(IN_ANGLE_BUF), a.bs[IN_ANGLE_BUF], wt, n_warp, lane);
  K10_STAMP(1);

  T R[9];
  quat_to_rotmat(quat, R);
  T eul[3];
  quat_to_euler(quat, eul);
  T Rz[9];
  rotz(eul[2], Rz);
  K10_STAMP(2);

  // ---- the goal update (control.goals.goal_update)
  T vel_d_world[3], vel_d_body[3], pos_d[3], pos_d_body[3];
  mv3(order_of(a.orders, S_RZ_VD), Rz, vd_rel, vel_d_world);
  mtv3(order_of(a.orders, S_VBODY), R, vel_d_world, vel_d_body);
  pos_d[0] = pos_d_in[0] + vel_d_world[0] * h;
  pos_d[1] = pos_d_in[1] + vel_d_world[1] * h;
  pos_d[2] = body_height;
  {
    T d[3];
    for (int i = 0; i < 3; ++i) d[i] = pos_d[i] - est_pos[i];
    mtv3(order_of(a.orders, S_PBODY), R, d, pos_d_body);
  }
  T quat_d[4];
  {
    const T w = qd[0], x = qd[1], y = qd[2], z = qd[3];
    // lie.quat_G: [−v; w·I + skew(v)]
    const T G[12] = {-x, -y, -z,
                     w * T(1) + T(0), w * T(0) + -z, w * T(0) + y,
                     w * T(0) + z, w * T(1) + T(0), w * T(0) + -x,
                     w * T(0) + -y, w * T(0) + x, w * T(1) + T(0)};
    T qn[4];
    for (int i = 0; i < 4; ++i)
      qn[i] = qd[i] + T(0.5) * dot3(order_of(a.orders, S_QUAT_RATE), G[3 * i], ang_vel_d[0],
                                    G[3 * i + 1], ang_vel_d[1], G[3 * i + 2], ang_vel_d[2]) * h;
    const T n = tnorm4(qn[0], qn[1], qn[2], qn[3]);
    // the four divisions one a lane
    const T mine_q = sel(qn, g) / n;
    for (int i = 0; i < 4; ++i) quat_d[i] = gshfl(mine_q, i);
  }
  if (sin_mode) {
    const T e = T(3.14 / 8.0) * sin(T(2.0 * 3.14 / 900.0) * att_count);
    euler_to_quat(e, e, e, quat_d);
  }
  K10_STAMP(3);

  // ---- this lane's leg: body-frame foot, contact, pinned-feet joint state
  T fpb[3];
  {
    T d[3];
    for (int i = 0; i < 3; ++i) d[i] = fw[i] - pos[i];
    for (int j = 0; j < 3; ++j)
      fpb[j] = dot3(order_of(a.orders, S_FOOT), d[0], R[j], d[1], R[3 + j], d[2], R[6 + j]);
  }
  const int cur_state = sel(states, seg_idx);
  const T contact_now = T(cur_state == STANCE);
  T jq[3], jdq[3];
  {
    T fvw[3], d[3], v_rel[3];
    for (int i = 0; i < 3; ++i) {
      fvw[i] = contact_now > T(0.5) ? T(0) : tvel_in[i];
      d[i] = fvw[i] - vel[i];
    }
    leg_ik(fpb, rho, jq);
    for (int j = 0; j < 3; ++j)
      v_rel[j] = dot3(order_of(a.orders, S_VREL), d[0], R[j], d[1], R[3 + j], d[2], R[6 + j]);
    // v_rel − ω × foot (torch.linalg.cross)
    v_rel[0] = v_rel[0] - fma_(omega[1], fpb[2], -(omega[2] * fpb[1]));
    v_rel[1] = v_rel[1] - fma_(omega[2], fpb[0], -(omega[0] * fpb[2]));
    v_rel[2] = v_rel[2] - fma_(omega[0], fpb[1], -(omega[1] * fpb[0]));
    T J[9], Ji[9];
    leg_jac(jq, rho, J);
    inverse3(J, Ji);
    for (int i = 0; i < 3; ++i)
      jdq[i] = clampv(dot3(order_of(a.orders, S_DQ), Ji[3 * i], v_rel[0], Ji[3 * i + 1],
                           v_rel[1], Ji[3 * i + 2], v_rel[2]),
                      T(-21), T(21));
  }
  K10_STAMP(4);

  // ---- Raibert footholds (gait.raibert.foothold_targets), snapped
  T target[3];
  {
    T vel_rel[3];
    mtv3(order_of(a.orders, S_RZ_VEL), Rz, est_vel, vel_rel);
    const T k = sqrt(fabs(pos[2]) * rcp<T>(9.81));
    const T th = T(a.t_half_stance);
    const T delta[3] = {clampv(k * (vel_rel[0] - vd_rel[0]) + th * vd_rel[0], T(-0.5), T(0.5)),
                        clampv(k * (vel_rel[1] - vd_rel[1]) + th * vd_rel[1], T(-0.3), T(0.3)),
                        T(0)};
    T delta_abs[3], ta[3];
    mv3(order_of(a.orders, S_RZ_DELTA), Rz, delta, delta_abs);
    mv3(order_of(a.orders, S_RZ_REL), Rz, dr, ta);
    for (int i = 0; i < 3; ++i) target[i] = ta[i] + delta_abs[i] + pos[i];
    // sim.terrain.snap_to_ground (edge_forward False)
    const T x = target[0];
    const T base = run * floor(clamp_min(x, T(0)) / run);
    const T x_rel = x - base;
    const T margin = clamp_max(T(0.45) * run, T(0.06));
    const bool near_edge = (x_rel < margin) & (base > T(0));
    T x_stairs = near_edge ? base - margin : minv(x, base + run - margin);
    x_stairs = x > T(0) ? x_stairs : x;
    const T x_out = kind == STAIRS ? x_stairs : x;
    target[0] = x_out;
    target[2] = terrain_height(kind, grade, rise, run, x_out);
  }
  K10_STAMP(5);

  // ---- the gait FSM (gait.schedule.gait_update) for this leg
  const T gfh = gf * h;
  T phase = phase_in + gfh;
  const T seg_end = T(sel(switch_time, seg_idx));
  T seg_start = seg_start_in;
  const T percent = clampv((phase - seg_start) / clamp_min(seg_end - seg_start, T(1e-9)), T(0),
                           T(1));
  const bool stance_to_swing = (cur_state == STANCE) & (phase >= seg_end);
  const bool swing_done = percent >= T(1);
  const bool early_contact = (percent > T(0.9)) & (contact_now > T(0.5));
  const bool swing_to_stance = (cur_state == SWING) & (swing_done | early_contact);
  const bool transition = stance_to_swing | swing_to_stance;
  const int next_idx = transition ? (seg_idx + 1) % n_seg : seg_idx;
  if (transition & (next_idx < seg_idx)) phase = phase - T(1);
  if (transition) seg_start = phase;
  const T seg_end_new = T(sel(switch_time, next_idx));
  const int new_state = sel(states, next_idx);
  const T terrain_h = stance_to_swing ? fw[2] : terrain_h_in;
  T swing_start[3], foothold[3];
  for (int i = 0; i < 3; ++i) swing_start[i] = stance_to_swing ? fw[i] : swing_in[i];
  const T percent_new =
      clampv((phase - seg_start) / clamp_min(seg_end_new - seg_start, T(1e-9)), T(0), T(1));
  const bool in_swing = new_state == SWING;
  const bool climb = (maxv(old_hold[2], target[2]) - swing_start[2]) > T(0.06);
  const bool latched = in_swing & (percent_new >= T(0.35)) & climb;
  for (int i = 0; i < 3; ++i) {
    const T limited = old_hold[i] + clampv(target[i] - old_hold[i], T(-0.06), T(0.06));
    foothold[i] = stance_to_swing ? target[i] : (latched ? old_hold[i] : limited);
  }
  T spos[3], svel[3], sacc[3];
  {
    const T t_swing = (T(1) / gf) * T(0.5);
    const T t = T(0.5) * percent_new / gf * T(1);
    swing_target(t, t_swing * T(1), swing_start, foothold, spos, svel, sacc);
  }
  const T plan_contact = T(new_state == STANCE);
  K10_STAMP(6);
  if (mine) {
    for (int i = 0; i < 3; ++i) {
      a.out[O_FOOT_BODY][b * 12 + 3 * f + i] = fpb[i];
      a.out[O_JOINT_POS][b * 12 + 3 * f + i] = jq[i];
      a.out[O_JOINT_VEL][b * 12 + 3 * f + i] = jdq[i];
      a.out[O_SWING_START][b * 12 + 3 * f + i] = swing_start[i];
      a.out[O_FOOTHOLD][b * 12 + 3 * f + i] = foothold[i];
      a.out[O_TARGET_POS][b * 12 + 3 * f + i] =
          in_swing ? spos[i] : (swing_to_stance ? fw[i] : tpos_in[i]);
      a.out[O_TARGET_VEL][b * 12 + 3 * f + i] = in_swing ? svel[i] : T(0);
      a.out[O_TARGET_ACC][b * 12 + 3 * f + i] = in_swing ? sacc[i] : T(0);
    }
    a.out[O_CONTACTS_NOW][b * 4 + f] = contact_now;
    a.out[O_PHASE][b * 4 + f] = phase;
    a.out[O_SEG_START][b * 4 + f] = seg_start;
    a.out[O_TERRAIN_H][b * 4 + f] = terrain_h;
    a.out[O_PLAN_CONTACTS][b * 4 + f] = plan_contact;
    a.out_int[OI_SEG_IDX][b * 4 + f] = next_idx;
  }
  // the contact schedule (gait.schedule.predict_contact_schedule) of this
  // lane's leg: knot k's entry; row 0 the new plan
  if (a.n_knots > 0 && mine) {
    T* sched = a.out[O_SCHEDULE] + b * 4 * a.n_knots;
    sched[f] = plan_contact;
#pragma unroll 4
    for (int k = 1; k < a.n_knots; ++k) {
      const T pred = remainderv(phase + gf * (T(k) * h), T(1));
      int idx = 0;
#pragma unroll
      for (int j = MAX_SEG - 1; j >= 0; --j)
        if (j < S && switch_time[j] >= static_cast<double>(pred)) idx = j;
      sched[4 * k + f] = T(sel(states, idx) == STANCE);
    }
  }
  K10_STAMP(7);

  // ---- the goal's window filters (utils/filters.window_update) on the
  // staged buffers: the new values in place (lane c of the group its vel
  // and pos channel c), the masked sums, the buffers written out by the
  // whole warp, coalesced
  cp_async_wait_all();
  __syncwarp();
  const int qs = mine ? q : n_warp - 1;
  T* const vq = vbuf + qs * 3 * wg;
  T* const pq = pbuf + qs * 3 * wg;
  T* const aq = abuf + qs * wt;
  if (mine && g < 3) {
    vq[g * wg + sel(vi, g)] = sel(vel_d_body, g);
    pq[g * wg + sel(pi, g)] = sel(pos_d_body, g);
  }
  __syncwarp();
  K10_STAMP(8);
  int vc_new[3], pc_new[3];
  for (int c = 0; c < 3; ++c) {
    vc_new[c] = vc[c] + 1 > wg ? wg : vc[c] + 1;
    pc_new[c] = pcn[c] + 1 > wg ? wg : pcn[c] + 1;
  }
  T vsum[3], psum[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    vsum[c] = group_sum(vq + c * wg, zero, wg, vc_new[c], a.width_goal, g);
    K10_STAMP(9 + 2 * c);
    psum[c] = group_sum(pq + c * wg, zero, wg, pc_new[c], a.width_goal, g);
    K10_STAMP(10 + 2 * c);
  }
  unstage(a.out[O_VEL_BUF] + b0 * 3 * wg, vbuf, n_warp * 3 * wg, lane);
  unstage(a.out[O_POS_BUF] + b0 * 3 * wg, pbuf, n_warp * 3 * wg, lane);
  K10_STAMP(15);

  // ---- the legs' planned contacts in every lane of the group
  T pc[LEGS];
  for (int l = 0; l < LEGS; ++l) pc[l] = gshfl(plan_contact, l);
  const T n_stance = clamp_min(tsum4(pc[0], pc[1], pc[2], pc[3]), T(1));
  const T ground_z = tsum4(feet[0][2] * pc[0], feet[1][2] * pc[1], feet[2][2] * pc[2],
                           feet[3][2] * pc[3]) / n_stance;

  // ---- the terrain update (kin.terrain.terrain_update), fit over pc
  T coef[3];
  {
    T W[LEGS][3], zw[LEGS];
    for (int l = 0; l < LEGS; ++l) {
      const T x = feet[l][0] - pos[0], y = feet[l][1] - pos[1], z = feet[l][2] - pos[2];
      W[l][0] = T(1) * pc[l], W[l][1] = x * pc[l], W[l][2] = y * pc[l];
      zw[l] = z * pc[l];
    }
    T A[9], Wtz[3];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        const T s = dot4(order_of(a.orders, S_WTW), W[0][i], W[0][j], W[1][i], W[1][j], W[2][i],
                         W[2][j], W[3][i], W[3][j]);
        A[3 * i + j] = s + (i == j ? T(1e-6) : T(0));
      }
      Wtz[i] = dot4(order_of(a.orders, S_WTZ), W[0][i], zw[0], W[1][i], zw[1], W[2][i], zw[2],
                    W[3][i], zw[3]);
    }
    // (WᵀW)⁻¹·Wᵀz: row r of the inverse (batch_last.cuh inverse3's adjugate
    // over the determinant) and its product on lane r; rows 1 and 2 kept
    const T a11 = A[4] * A[8] - A[5] * A[7], a12 = A[2] * A[7] - A[1] * A[8],
            a13 = A[1] * A[5] - A[2] * A[4];
    const T a21 = A[5] * A[6] - A[3] * A[8], a22 = A[0] * A[8] - A[2] * A[6],
            a23 = A[2] * A[3] - A[0] * A[5];
    const T a31 = A[3] * A[7] - A[4] * A[6], a32 = A[1] * A[6] - A[0] * A[7],
            a33 = A[0] * A[4] - A[1] * A[3];
    const T det = (A[0] * a11 + A[1] * a21) + A[2] * a31;
    const int r = g < 3 ? g : 2;
    const T row[3] = {(r == 0 ? a11 : (r == 1 ? a21 : a31)) / det,
                      (r == 0 ? a12 : (r == 1 ? a22 : a32)) / det,
                      (r == 0 ? a13 : (r == 1 ? a23 : a33)) / det};
    const T sol = dot3(order_of(a.orders, S_SOL), row[0], Wtz[0], row[1], Wtz[1], row[2], Wtz[2]);
    coef[0] = gshfl(sol, 1), coef[1] = gshfl(sol, 2), coef[2] = -T(1);
  }
  T raw;
  {
    const T zero = T(0), one = zero + T(1);
    const T num = fabs(tsum3(zero * coef[0], zero * coef[1], one * coef[2]));
    const T den = tnorm3(zero, zero, one) * tnorm3(coef[0], coef[1], coef[2]);
    raw = acos(clampv(num / clamp_min(den, T(1e-12)), T(-1), T(1)));
  }
  const bool active = (est_pos[2] - ground_z) > T(0.1);
  K10_STAMP(16);

  // ---- the terrain's window filter: the new angle in place where active
  // (lane 3), its masked sum, its buffers written out
  if (mine && g == 3 && active) aq[ai] = raw;
  __syncwarp();
  const int ac_new = ac + 1 > wt ? wt : ac + 1;
  const T asum = group_sum(aq, zero, wt, ac_new, a.width_terrain, g);
  unstage(a.out[O_ANGLE_BUF] + b0 * wt, abuf, n_warp * wt, lane);
  K10_STAMP(17);
  // the divisions by the counts, lane c its vel and pos channel c, lane 3
  // the angle's
  const T vel_f = (g < 3 ? sel(vsum, g) : asum) / T(g < 3 ? sel(vc_new, g) : ac_new);
  const T pos_f = sel(psum, g < 3 ? g : 2) / T(sel(pc_new, g < 3 ? g : 2));
  const T angle_mean = gshfl(vel_f, 3);  // every lane shuffles, active or not
  T angle = active ? angle_mean : terrain_angle;
  angle = clampv(angle, T(-0.349), T(0.349));
  const T f_r_diff = (((feet[0][2] - pos[2]) + (feet[1][2] - pos[2])) - (feet[2][2] - pos[2])) -
                     (feet[3][2] - pos[2]);
  T pitch_d = f_r_diff > T(0.05) ? -angle : angle;
  pitch_d = active ? pitch_d : T(0);

  // ---- the desired attitude pitched (lie.quat_to_euler, then
  // lie.euler_to_quat of roll, pitch + pitch_d, yaw): lane 0 the roll's half
  // angle, lane 1 the pitch's, lane 2 the yaw's, each its cosine and sine
  T qc[4];
  {
    const T w = quat_d[0], x = quat_d[1], y = quat_d[2], z = quat_d[3];
    const T ysqr = y * y;
    const T ay = g == 0 ? T(2) * (w * x + y * z) : T(2) * (w * z + x * y);
    const T ax = g == 0 ? T(1) - T(2) * (x * x + ysqr) : T(1) - T(2) * (ysqr + z * z);
    const T at = atan2(ay, ax);  // lane 0 the roll, the others the yaw
    const T pitch = asin(clampv(T(2) * (w * y - z * x), T(-1), T(1)));
    const T half = (g == 1 ? pitch + pitch_d : at) * T(0.5);
    const T c = cos(half), s = sin(half);
    const T cr = gshfl(c, 0), sr = gshfl(s, 0), cp = gshfl(c, 1), sp = gshfl(s, 1);
    const T cy = gshfl(c, 2), sy = gshfl(s, 2);
    qc[0] = cy * cp * cr + sy * sp * sr;
    qc[1] = cy * cp * sr - sy * sp * cr;
    qc[2] = cy * sp * cr + sy * cp * sr;
    qc[3] = sy * cp * cr - cy * sp * sr;
  }
  K10_STAMP(18);

  // ---- the scenario's outputs, lane c its component c
  if (mine) {
    if (g < 3) {
      a.out[O_VEL_BODY_D][b * 3 + g] = vel_f;
      a.out[O_ANG_VEL_D][b * 3 + g] = sel(ang_vel_d, g);
      a.out[O_POS_D][b * 3 + g] = sel(pos_d, g);
      a.out[O_SURF_COEF][b * 3 + g] = sel(coef, g);
      a.out[O_POS_BODY_D][b * 3 + g] = g < 2 ? pos_f : ground_z + target_height - est_pos[2];
      a.out_int[OI_VEL_IDX][b * 3 + g] = (sel(vi, g) + 1) % wg;
      a.out_int[OI_VEL_COUNT][b * 3 + g] = sel(vc_new, g);
      a.out_int[OI_POS_IDX][b * 3 + g] = (sel(pi, g) + 1) % wg;
      a.out_int[OI_POS_COUNT][b * 3 + g] = sel(pc_new, g);
    } else {
      a.out[O_ATT_COUNT][b] = att_count + T(sin_mode);
      a.out[O_TERRAIN_ANGLE][b] = angle;
      a.out[O_GROUND_Z][b] = ground_z;
      a.out_int[OI_ANGLE_IDX][b] = active ? (ai + 1) % wt : ai;
      a.out_int[OI_ANGLE_COUNT][b] = active ? ac_new : ac;
    }
    a.out[O_QUAT_CMD][b * 4 + g] = sel(qc, g);
    a.out[O_QUAT_D][b * 4 + g] = sel(quat_d, g);
  }
  K10_STAMP(19);
}

template <typename T>
int launch(const void* const* in, const long long* bs, void* const* out, void* const* out_int,
           int B, int w_goal, int w_terrain, int n_seg_max, int n_knots, int orders,
           double t_half_stance, void* stream) {
  if (n_seg_max < 1 || n_seg_max > MAX_SEG || w_goal < 1 || w_goal > MAX_WINDOW ||
      w_terrain < 1 || w_terrain > MAX_WINDOW)
    return 1;  // cudaErrorInvalidValue
  Args<T> a;
  for (int i = 0; i < INPUTS; ++i) a.in[i] = in[i], a.bs[i] = bs[i];
  for (int o = 0; o < OUTPUTS; ++o) a.out[o] = static_cast<T*>(out[o]);
  for (int o = 0; o < OUTPUTS_INT; ++o) a.out_int[o] = static_cast<int*>(out_int[o]);
  a.B = B, a.w_goal = w_goal, a.w_terrain = w_terrain, a.n_seg_max = n_seg_max;
  a.n_knots = n_knots, a.orders = orders, a.t_half_stance = t_half_stance;
  a.width_goal = reduce_width(w_goal, 3LL * B), a.width_terrain = reduce_width(w_terrain, B);
  constexpr int PER_BLOCK = WARPS * SCENARIOS;
  const int blocks = static_cast<int>((static_cast<long long>(B) + PER_BLOCK - 1) / PER_BLOCK);
  const size_t bytes = smem_bytes<T>(w_goal, w_terrain);
#ifdef __CUDACC__
  // beyond 48 KB a block asks, on every launch: the attribute is the
  // current card's, and a launch may be on another card than the last
  if (bytes > (48 << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(
        walking_pre_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  walking_pre_kernel<T><<<blocks, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
#else
  (void)stream, (void)bytes;
  return emulate_blocks(blocks, THREADS, walking_pre_kernel<T>, a);
#endif
}

#ifdef __CUDACC__
template <typename T>
int occupancy(int w_goal, int w_terrain) {
  const size_t bytes = smem_bytes<T>(w_goal, w_terrain);
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      walking_pre_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, walking_pre_kernel<T>, THREADS, bytes);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
#endif

}  // namespace

extern "C" {

int walking_pre_f32(const void* const* in, const long long* bs, void* const* out,
                    void* const* out_int, int B, int w_goal, int w_terrain, int n_seg_max,
                    int n_knots, int orders, double t_half_stance, void* stream) {
  return launch<float>(in, bs, out, out_int, B, w_goal, w_terrain, n_seg_max, n_knots, orders,
                       t_half_stance, stream);
}

int walking_pre_f64(const void* const* in, const long long* bs, void* const* out,
                    void* const* out_int, int B, int w_goal, int w_terrain, int n_seg_max,
                    int n_knots, int orders, double t_half_stance, void* stream) {
  return launch<double>(in, bs, out, out_int, B, w_goal, w_terrain, n_seg_max, n_knots, orders,
                        t_half_stance, stream);
}

void walking_pre_table(int* out) {
  out[0] = INPUTS;
  out[1] = OUTPUTS;
  out[2] = OUTPUTS_INT;
  out[3] = SITES;
}

#ifdef __CUDACC__
// Blocks of the kernel resident on an SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
int walking_pre_occupancy(int f64, int w_goal, int w_terrain) {
  return f64 ? occupancy<double>(w_goal, w_terrain) : occupancy<float>(w_goal, w_terrain);
}
#endif

#ifdef K10_PHASE_CLOCKS
// The scenario whose group's lane 0 stamps in the launches after it; every
// stamp set to 0.
int walking_pre_clock_scenario(long long b) {
  static const long long zeros[CLOCK_SLOTS] = {};
  cudaError_t err = cudaMemcpyToSymbol(phase_clocks, zeros, sizeof(zeros));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(clock_scenario, &b, sizeof(long long));
  return static_cast<int>(err);
}
// The first n stamps since (CLOCK_SLOTS at most), to host memory
// (synchronises).
int walking_pre_clocks(long long* out, int n) {
  if (n > CLOCK_SLOTS) n = CLOCK_SLOTS;
  return static_cast<int>(cudaMemcpyFromSymbol(out, phase_clocks, sizeof(long long) * n));
}
#endif

}  // extern "C"
