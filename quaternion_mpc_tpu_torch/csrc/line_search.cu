// K2 — the line search of one iLQR iteration, every alpha of every scenario
// in one launch, for each model it is instantiated for: the quaternion SRB
// (midpoint rule), the Euler SRB of the convex baseline (midpoint rule and
// forward Euler) and the attitude model of falling_cat (midpoint rule).
//
// Replaces the region XLA fused for the JAX package at
// quaternion_mpc_tpu/solver/fleet.py:757-799 (jax.vmap of rollout :662-676
// and total_cost :388 over the alphas, the Armijo test, the accept and the
// NaN-safe select). There is no Pallas kernel for it; eager PyTorch runs it
// as about a thousand small launches an iteration (solver/fleet.line_search,
// the plain version).
//
// What it computes, for every scenario b and alpha α_k = alphas[k], k < K:
// - where no J is given (FLAG_PRICE: an AL iteration's first line search,
//   after the multipliers moved), J itself: the AL cost below of xs_bar and
//   us_bar. The Armijo test compares J with costs of rollouts, and in f32 a J
//   summed in another order than they are can differ from them by more than
//   the decrease the test asks of the smaller alphas;
// - the closed-loop rollout from x = xs_bar[0]: at knot j, δx = x ⊖ xs_bar[j]
//   (the Cayley-chart attitude error where the state holds a quaternion, a
//   plain difference elsewhere), u = (ū[j] + α·d[j]) + K[j]·δx, and x stepped
//   by the model (csrc/step_models.cuh: QuatSrbMidpoint, EulerSrb,
//   AttitudeMidpoint);
// - its augmented-Lagrangian cost (solver/fleet.total_cost): per stage knot
//   ½Σ Qd·dx² + ½Σ Rd·du² + w·(1 − |q·q_ref|) + (Σ λ̄² − Σ λ²)/(2ρ) with
//   λ̄ = max(λ + ρ·(Cu·u + cb), 0), then the terminal ½Σ Qdf·dx² + w·(1 − |q·q_ref|)
//   (the geodesic terms only where the state holds a quaternion);
// - the Armijo test against J and the expected decrease −(α·dV1 + α²·dV2)
//   (solver/fleet.armijo_ok), which also needs a finite cost;
// - the select: the first (largest) passing alpha; accepted = any passes,
//   improved = accepted and J_k < J, and where improved and not done the
//   selected rollout and its cost replace xs, us and J.
//
// What bounds it on an H100: bytes at the fleet's sizes. Every lane of a
// scenario reads the same gains K[j] (nu·ne values a knot), which are most of
// the bytes the function needs (kernels/line_search.work); the K rollouts'
// arithmetic is below that at the card's peak. A rollout is a serial chain
// of N knots, so what the design has to hide is the latency of that chain and
// of its operands' loads; below a full wave of blocks (B up to ~2k at K = 8)
// that latency is the whole time.
//
// Design (each point measured on an H100 for the quaternion SRB; PERF.md, "K2
// redesigned"). Nothing in it depends on the model but the sizes, the
// constants a block stages and the step: a model is a template argument.
// - A thread per (alpha, scenario), or two (P = 2, below): the G·P lanes of
//   a scenario (G the least power of two >= K) sit next to each other in one
//   warp; a block owns S consecutive scenarios.
// - Shared memory holds every operand a lane reads in the rollouts. Once a
//   launch: Qd, Qdf, Rd, Cu, w and cb where they are not per knot, and the
//   model's constants of its step (computed by the scenario's first lane from
//   its parameters: M::load). A knot slab, double-buffered: xs_bar[j],
//   us_bar[j], K[j], d[j], x_ref[j], u_ref[j], λ[j], and cb[j], w[j] where per
//   knot. The whole block copies
//   knot j+1 with cp.async while its lanes roll knot j; one __syncthreads()
//   a knot. A copy is one element (4 or 8 bytes): thread t takes scenario
//   t mod S and every (G·P)-th row, so neighbouring threads read neighbouring
//   scenarios of a batch-last row (coalesced). In shared memory a slot holds
//   each scenario's rows one after the other, the scenarios an odd pitch
//   apart: the copies' stores and the lanes' loads fall into distinct banks,
//   and a lane reads its rows at a base register plus a constant offset
//   (with the scenarios side by side, every load paid a multiply by the
//   stride: 0.1058 -> 0.0907 ms at the fleet's B = 4096, 0.0452 -> 0.0345 at
//   the hardware tick's B = 1). An input with batch extent 1 (a value every
//   scenario shares: the golden fixture's references, weights and Cu) is
//   staged once a block, and every scenario reads that copy.
//   At nu = 12, nc = 24 and every leaf per scenario that is 379 values a
//   scenario once and 230 a knot (255 with w and cb per knot): ~108 KB a
//   block in f32 at S = 32 and in f64 at S = 16, two blocks an SM.
// - Where no J is given, the scenario's G·P lanes price xs_bar and us_bar
//   together before the rollouts: lane q takes the stage costs of knots q,
//   q+G·P, ... and the terminal, the knots' rows read from device memory and
//   the constants from shared memory (their costs do not depend on each
//   other); the stage costs come to every lane of the scenario by
//   __shfl_sync, round by round, each lane adding them in knot order with
//   the same operations as a rollout's running sum: J and the J_k are summed
//   alike, as the f32 Armijo test needs.
// - No second rollout: each alpha writes its x at every knot and u at every
//   stage, as it rolls them, into a trajectory slab (row e, scenario s,
//   alpha k at e·stride + s·G + k: a warp's stores are consecutive). The
//   slab lives in shared memory where it fits beside the staging and every
//   block has an SM of its own (small B: it then takes no block's place);
//   else in a device-memory scratch of (N+1)·nx + N·nu rows x B x G values
//   that the wrapper allocates (the fleet's B = 4096: 34 MB in f32, most of
//   it in L2). After the select, the whole block writes xs and us, thread t
//   taking scenario t mod S and every (G·P)-th row: the selected alpha's
//   rows, or xs_bar's and us_bar's where the step is not taken (so the
//   outputs never alias the inputs), coalesced along B, eight loads ahead of
//   their stores.
// - The launch plan (choose_blocks): while the scenarios fill at most one
//   block an SM at 256 lanes a block (512 in f32, the fleet's B = 4096 at 8
//   alphas), two lanes serve each alpha (P = 2: each computes half of u's
//   rows and, in chunks of four, half of the friction rows of every knot;
//   the pair exchanges them by __shfl_xor_sync and both lanes add the rows
//   in row order) in blocks of 128-256 lanes spread over the SMs; below a
//   wave the time is then one block's chain. Above, one lane an alpha in
//   blocks whose rows are 128 bytes (S = 32 in f32, 16 in f64).
//   At K = 12 a scenario's 16 lanes hold 12 alphas: the 4 past K roll the
//   last alpha and pass no test.
// - The scenario's first passing alpha is the lowest set bit of its lanes in
//   a __ballot_sync, its cost comes by __shfl_sync. Lanes past the last
//   scenario roll nothing (with P = 2 they roll what their shared memory
//   holds, for the shuffles); all reach every barrier, ballot and shuffle.
// For the quaternion SRB every value is computed by the same sequence of
// rounded operations as in the first design (one thread per (alpha,
// scenario) reading every operand from device memory, a second rollout of
// the selected alpha, the pricing by lane 0 alone): its outputs have the same
// bits, NaN's sign aside.
// Everything that changes within a solve is read from device memory (ρ, h, J,
// dV1, dV2, done, the alphas), so a captured CUDA graph replays it right.
// A select, never a 0/1-weighted sum, takes the selected values: an
// unselected alpha's Inf or NaN reaches no output.
//
// The models (csrc/step_models.cuh, shared with K9: each a struct of NX, NE,
// NU, QI, VALUES, load and step, the step in the order of the operations of
// its plain PyTorch model): QuatSrbMidpoint<NF> (the quaternion SRB),
// EulerSrb<NF, FORWARD> (the Euler SRB of the convex baseline, by the midpoint
// rule or forward Euler) and AttitudeMidpoint (falling_cat), each with the
// header's `Separate` rounding: a cross product's terms as two rounded
// products and their difference, sincos. An instantiation is named by its
// tag (line_search_tags, in the order of enum Model), which the wrapper
// checks against its own.
//
// Layout: batch-last, as the solver holds it. The wrapper
// (kernels/line_search.py) hands a table of input pointers and one of their
// (row stride, batch stride) pairs, as K8 and K9 take them; the order is enum
// Input below, then the alphas, done and the trajectory scratch. The inputs
// the kernel stages are contiguous in their leading axes with a batch axis
// of B or of 1 (a value every scenario shares, read with batch stride 0); the
// batch-first model parameters (params_to_fleet's movedim) are read in place
// through their strides (batch_last.cuh In).
//
// C interface (bound with ctypes): line_search_f32 / _f64 take the input
// table, its strides, the output table, N, B, K, n_feet (1-4; 1 for the
// attitude model, whose three torques are one group of three), nc and
// flags (FLAG_*, the model's index at MODEL_SHIFT), and a cudaStream_t; they
// launch on that stream and return the CUDA error of the launch.
// line_search_table(out) writes the tables' sizes and line_search_tags() the
// instantiations' tags, so the wrapper checks its order against the one
// compiled.
//
// Built with -fmad=false (kernels/line_search.FLAGS): each operation rounds
// as the plain version's do. Contracted, the kernel met its checks against
// the plain version, but the f32 walking fleet of chip_smoke.py fell where
// the plain version's stands: that closed loop's fate is set by rounding
// (PERF.md, K2's findings). The Euler SRB's sine and cosine are the accurate
// sincos (no fast math).
//
// Build options: -DK2_TRAJ_IN_DEVICE_MEMORY keeps the trajectory slab in the
// scratch at every shape; -DK2_PLAN_OVERRIDE adds line_search_override(S,
// P), which sets the block's scenarios and the lanes an alpha of the
// launches after it;
// -DK2_PHASE_CLOCKS makes thread 0 of the middle block stamp clock64() after
// every phase (staging, pricing, each knot's copies, rollout and wait, the
// select, the write), read back by line_search_clocks(out, n).
//
// The device code also compiles as plain C++ (no __CUDACC__) against
// tests/cuda_emulation.h, where cp_async copies at once;
// tests/test_torch_line_search_emulation.py holds it against the plain
// version that way.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define K2_ISFINITE(x) isfinite(x)
#else
#include <cmath>
#define K2_ISFINITE(x) std::isfinite(x)
#endif

#include <cstddef>

#include "step_models.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_LIMIT = 232448;  // the shared memory a block may have on an H100

// the inputs, in the order of the wrapper's table (nx, ne: the model's state
// and error state)
enum Input {
  IN_XS, IN_US, IN_KS, IN_DS,        // xs_bar (N+1, nx), us_bar (N, nu), Ks (N, nu, ne), ds (N, nu)
  IN_X_REF, IN_U_REF,          // (N+1, nx), (N+1, nu)
  IN_QD, IN_QDF, IN_RD, IN_W,        // (nx), (nx), (nu), w (1) or per knot (N+1)
  IN_CU, IN_CB, IN_LAM,           // (nc, nu), cb (nc) or per knot (N+1, nc), lam (N, nc)
  // the model's parameters in the order of step_models.cuh enum Param (null
  // where a model has none of them)
  IN_FOOT, IN_INERTIA, IN_MASS, IN_COM_OFFSET, IN_COM_MASS, IN_ROT,
  IN_H, IN_RHO, IN_J, IN_DV1, IN_DV2,   // each one value a scenario (h, ρ: shared or not; J
                                        // null with FLAG_PRICE)
  INPUTS
};
// after the table's INPUTS pointers: the alphas (K), done (B, bool) and the
// trajectory scratch ((N+1)·nx + N·nu rows x B x G values)
constexpr int IN_ALPHAS = INPUTS, IN_DONE = INPUTS + 1, IN_SCRATCH = INPUTS + 2;
// the outputs: xs (N+1, nx, B), us (N, nu, B), the cost the test compared
// against (B), J (B), accepted (B, bool), improved (B, bool), the rollouts'
// costs (K, B) or null
enum Output { XS_OUT, US_OUT, J_IN_OUT, J_OUT, ACCEPTED, IMPROVED, COSTS, OUTPUTS };
// flags: w or cb per knot; FLAG_PRICE: no J given, the kernel prices xs_bar,
// us_bar; the instantiation's index (enum Model) from bit MODEL_SHIFT on
constexpr int FLAG_W_PER_KNOT = 1, FLAG_CB_PER_KNOT = 2, FLAG_PRICE = 4, MODEL_SHIFT = 8;

// What shared memory holds: the values staged once a launch, the model's
// constants, then one knot's slab (in two buffers).
enum Slot {
  SL_QD, SL_QDF, SL_RD, SL_W, SL_CU, SL_CB, SL_MODEL,
  SL_XS, SL_US, SL_KS, SL_DS, SL_XREF, SL_UREF, SL_LAM, SL_CBK, SL_WK,
  SLOTS
};
constexpr int FIRST_KNOT_SLOT = SL_XS;

// Where a launch keeps what in shared memory, in values of T: each slot's
// offset (a knot slot's within a buffer) and the pitch between its
// scenarios' rows (odd, so that the scenarios of a warp fall into distinct
// banks; 0 for an input of batch extent 1, one copy for all); rows 0 for a
// slot this launch does not use.
struct Plan {
  int S, lgS, G, lgG, threads, blocks;
  int P, GP, lgGP;  // lanes an alpha (1 or 2), and a scenario's lanes G·P
  int at[SLOTS], pitch[SLOTS], rows[SLOTS];
  int source[SLOTS];         // the input a slot is staged from (-1: the model)
  int knot_at, knot_values;  // buffer 0 at knot_at, buffer 1 knot_values further
  int sel_at;                // 2·S ints: each scenario's take and selected lane
  int traj_at;               // the trajectory slab, or -1: in the device-memory scratch
  size_t bytes;
};

template <typename T>
struct Args {
  View<T> in[INPUTS];  // the model's parameters' entries unused: prm
  In<T> prm[PARAMS];   // the model's parameters, read in place through their strides
  const T* alphas;              // (K)
  const unsigned char* done;    // (B), bool
  T* scratch;                   // the trajectories where they are not in shared memory
  T* xs;
  T* us;
  T* J_in;
  T* J_out;
  unsigned char* accepted;
  unsigned char* improved;
  T* costs;                     // (K, B) or null
  int N, B, K, nc, flags;
  Plan plan;
};

// The least power of two >= K: the lanes a scenario takes.
inline int group_lanes(int K) {
  int g = 1;
  while (g < K) g <<= 1;
  return g;
}

inline int log2_of(int pow2) {
  int l = 0;
  while ((1 << l) < pow2) ++l;
  return l;
}

// The lanes a block may have (measured: 512-lane blocks were slower than 256
// at every shape that could take them).
constexpr int MAX_THREADS = 256;

#ifdef K2_PLAN_OVERRIDE
// A measurement build's (S, P) in place of the policy's, where each is > 0
// (and allowed: S >= 32 / (G·P), S·G·P within MAX_THREADS, P = 2 only at G <= 16).
int override_S = 0, override_P = 0;
#endif

// The block's scenarios S and the lanes P that serve one alpha (two: each
// computes half of the inputs' rows and of the friction rows of every knot,
// exchanged by shuffles), as measured on an H100 (PERF.md, "K2 redesigned"):
// while B scenarios fill one block an SM at <= 256 lanes a block (512 in
// f32), the launch is bound by the latency of one block's chain, and two
// lanes an alpha in blocks of 128-256 lanes spread over the SMs take least
// time; above, one lane an alpha in blocks of 128-byte rows (S = 32 in f32,
// 16 in f64).
template <typename T>
void choose_blocks(int G, int B, int sms, int& S, int& P) {
  int wave = 1;  // the scenarios a block for one block an SM
  while (static_cast<long long>(wave) * sms < B) wave <<= 1;
  P = G <= 16 && wave * 2 * G <= (sizeof(T) == 4 ? 512 : 256) ? 2 : 1;
#ifdef K2_PLAN_OVERRIDE
  if (override_P > 0) P = override_P == 2 && G <= 16 ? 2 : 1;
#endif
  const int lanes = G * P;
  int most = 128 / static_cast<int>(sizeof(T));  // a row of 128 bytes
  while (most * lanes > MAX_THREADS) most >>= 1;
  int fit = 1;  // no more scenarios than B needs
  while (fit < B) fit <<= 1;
  S = wave > 128 / lanes ? wave : 128 / lanes;
  S = S < fit ? S : fit;
#ifdef K2_PLAN_OVERRIDE
  if (override_S > 0) S = override_S;
#endif
  S = S < most ? S : most;
  S = S * lanes < 32 ? 32 / lanes : S;  // a warp at least
}

// The launch's plan: the block's scenarios and lanes, and shared memory;
// nx, ne, nu, model_values: the model's state, error state, input and constants
// (M::NX, M::NE, M::NU, M::VALUES); `sms`, the card's multiprocessors.
template <typename T>
Plan make_plan(const View<T>* in, int N, int B, int K, int nx, int ne, int nu,
               int model_values, int nc, int flags, int sms) {
  Plan p{};
  p.G = group_lanes(K);
  p.lgG = log2_of(p.G);
  int S;
  choose_blocks<T>(p.G, B, sms, S, p.P);
  p.GP = p.G * p.P;
  p.lgGP = log2_of(p.GP);
  p.S = S;
  p.lgS = log2_of(S);
  p.threads = S * p.GP;
  p.blocks = static_cast<int>((static_cast<long long>(B) + S - 1) / S);
  const bool w_knot = flags & FLAG_W_PER_KNOT, cb_knot = flags & FLAG_CB_PER_KNOT;
  const int rows[SLOTS] = {
      nx, nx, nu, w_knot ? 0 : 1, nc * nu, cb_knot ? 0 : nc, model_values,
      nx, nu, nu * ne, nu, nx, nu, nc, cb_knot ? nc : 0, w_knot ? 1 : 0};
  const int source[SLOTS] = {IN_QD, IN_QDF, IN_RD, IN_W, IN_CU, IN_CB, -1,
                             IN_XS, IN_US, IN_KS, IN_DS, IN_X_REF, IN_U_REF, IN_LAM, IN_CB, IN_W};
  int at = 0;
  for (int slot = 0; slot < SLOTS; ++slot) {
    if (slot == FIRST_KNOT_SLOT) {
      p.knot_at = at;
      at = 0;
    }
    p.rows[slot] = rows[slot];
    p.source[slot] = source[slot];
    const bool shared = source[slot] >= 0 && in[source[slot]].ld == 1;
    p.pitch[slot] = shared ? 0 : rows[slot] | 1;
    p.at[slot] = at;
    at += rows[slot] == 0 ? 0 : shared ? rows[slot] : S * p.pitch[slot];
  }
  p.knot_values = at;
  const size_t values = static_cast<size_t>(p.knot_at) + 2 * static_cast<size_t>(p.knot_values);
  p.sel_at = static_cast<int>(values);
  const size_t sel = (2 * S * sizeof(int) + sizeof(T) - 1) / sizeof(T);
  const size_t traj = (static_cast<size_t>(N + 1) * nx + static_cast<size_t>(N) * nu) * S * p.G;
  p.traj_at = static_cast<int>(values + sel);
  p.bytes = (values + sel + traj) * sizeof(T);
  // in shared memory where it fits and every block has an SM of its own, so
  // that it takes no block's place
#ifdef K2_TRAJ_IN_DEVICE_MEMORY
  const bool in_smem = false;
#else
  const bool in_smem = p.bytes <= SMEM_LIMIT && p.blocks <= sms;
#endif
  if (!in_smem) {
    p.traj_at = -1;
    p.bytes = (values + sel) * sizeof(T);
  }
  return p;
}

#ifdef K2_PHASE_CLOCKS
__device__ long long phase_clocks[1 << 12];
struct Stamp {
  int n = 0;
  bool on;
  __device__ explicit Stamp(bool on_) : on(on_) {}
  __device__ __forceinline__ void operator()() {
    if (on && n < (1 << 12)) phase_clocks[n++] = clock64();
  }
};
#else
struct Stamp {
  __device__ explicit Stamp(bool) {}
  __device__ __forceinline__ void operator()() {}
};
#endif

// One element from device memory to shared memory, asynchronously.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
#ifdef __CUDACC__
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(to), "l"(src) : "memory");
  }
#else
  *dst = *src;
#endif
}

// Closes the group of copies this thread has started since the last one.
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDACC__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits until at most `pending` of this thread's groups of copies are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait_prior() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
#endif
}

// Waits for every copy this thread has started.
__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// The block copies `rows` rows of an input (row r of scenario b at
// src[r·ld + b]) for its scenarios b0.. into dst: row r of scenario s at
// dst[s·pitch + r], or, for an input of batch extent 1, row r at dst[r].
// Thread t takes scenario t mod S: neighbouring threads read neighbouring
// values of a batch-last row and write words `pitch` (odd) apart.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long ld, int rows, int pitch,
                                      const Plan& p, long long b0, long long B) {
  if (ld == 1) {
    for (int r = threadIdx.x; r < rows; r += p.threads) cp_async(dst + r, src + r);
    return;
  }
  const int s = threadIdx.x & (p.S - 1);
  if (b0 + s >= B) return;
  dst += s * pitch;
  src += b0 + s;
  for (int r = threadIdx.x >> p.lgS; r < rows; r += p.threads >> p.lgS)
    cp_async(dst + r, src + r * ld);
}

// dst[e·dst_st] = src[e·src_st] for e = first, first + step, ... < rows,
// eight loads ahead of their stores: the loads do not wait for each other.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, long long dst_st, const T* src,
                                          long long src_st, long long rows, int first,
                                          int step) {
  constexpr int U = 8;
  long long e = first;
  for (; e + (U - 1) * step < rows; e += U * step) {
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = src[(e + u * step) * src_st];
#pragma unroll
    for (int u = 0; u < U; ++u) dst[(e + u * step) * dst_st] = v[u];
  }
  for (; e < rows; e += step) dst[e * dst_st] = src[e * src_st];
}

template <typename T>
__device__ __forceinline__ T k_abs(T x) {
  return x < T(0) ? -x : x;
}

// δx = x ⊖ x_bar: a plain difference, and where the state holds a quaternion
// (at M::QI) its Cayley coordinates of q_bar⁻¹ ⊗ q in its place.
template <typename M, typename T>
__device__ __forceinline__ void state_diff(const T* x, const Sm<T>& xb, T* dx) {
  constexpr int QI = M::QI;
  if constexpr (QI < 0) {
#pragma unroll
    for (int i = 0; i < M::NX; ++i) dx[i] = x[i] - xb[i];
  } else {
#pragma unroll
    for (int i = 0; i < QI; ++i) dx[i] = x[i] - xb[i];
    // δq = q_ref⁻¹ ⊗ q, then its Cayley coordinates dv / dw
    const T w1 = xb[QI], v1[3] = {-xb[QI + 1], -xb[QI + 2], -xb[QI + 3]};
    const T w2 = x[QI], v2[3] = {x[QI + 1], x[QI + 2], x[QI + 3]};
    const T dw = w1 * w2 - ((v1[0] * v2[0] + v1[1] * v2[1]) + v1[2] * v2[2]);
    const T cr[3] = {v1[1] * v2[2] - v1[2] * v2[1], v1[2] * v2[0] - v1[0] * v2[2],
                     v1[0] * v2[1] - v1[1] * v2[0]};
#pragma unroll
    for (int i = 0; i < 3; ++i) dx[QI + i] = (w1 * v2[i] + w2 * v1[i] + cr[i]) / dw;
#pragma unroll
    for (int i = QI + 3; i < M::NE; ++i) dx[i] = x[i + 1] - xb[i + 1];
  }
}

// Σ Qd·dx² and q·q_ref (0 for a state without a quaternion) of a state
// against its reference row.
template <typename M, typename T, typename RK, typename RC>
__device__ __forceinline__ void state_terms(const T* x, const RK& x_ref, const RC& Qd, T& sq,
                                            T& dot) {
  sq = T(0), dot = T(0);
#pragma unroll
  for (int i = 0; i < M::NX; ++i) {
    const T r = x_ref[i];
    const T d = x[i] - r;
    sq = sq + Qd[i] * d * d;
    if (M::QI >= 0 && i >= M::QI && i < M::QI + 4) dot = dot + x[i] * r;
  }
}

// The sums of the friction rows' AL terms, Σ λ̄² and Σ λ², split between an
// alpha's two lanes (h = 0, 1; the other's lane is lane ^ partner): in
// chunks of 2·R rows, lane h computes the chunk's rows h·R .. h·R + R-1, the
// pair exchanges z² and λ² by shuffles, and both lanes add the chunk's rows
// in row order: each lane ends with the one-lane sums.
template <typename T, int NU, typename RK, typename RC>
__device__ __forceinline__ void friction_sums_pair(const T* u, const RC& Cu, const RK& cb,
                                                   const RK& lam, int nc, T rho, int h,
                                                   int partner, T& s_bar, T& s_lam) {
  constexpr int R = 4;
  for (int r0 = 0; r0 < nc; r0 += 2 * R) {
    T zz[R], ll[R], oz[R], ol[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = r0 + h * R + i;
      const int r = row < nc ? row : 0;  // past the last row: any row, never added
      T c = T(0);
#pragma unroll
      for (int m = 0; m < NU; ++m) c = c + Cu[r * NU + m] * u[m];
      c = c + cb[r];
      const T l = lam[r];
      T z = l + rho * c;
      z = z < T(0) ? T(0) : z;  // max(z, 0) that keeps a NaN, as torch.clamp
      zz[i] = z * z;
      ll[i] = l * l;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      oz[i] = __shfl_xor_sync(FULL, zz[i], partner);
      ol[i] = __shfl_xor_sync(FULL, ll[i], partner);
    }
#pragma unroll
    for (int i = 0; i < 2 * R; ++i) {
      if (r0 + i >= nc) break;
      const bool mine = (i < R) == (h == 0);
      s_bar = s_bar + (mine ? zz[i % R] : oz[i % R]);
      s_lam = s_lam + (mine ? ll[i % R] : ol[i % R]);
    }
  }
}

// A stage knot's AL cost of (x, u), each operand at the knot's first row:
// the knot's rows (RK: x_ref, u_ref, cb, λ) and the constants (RC: Qd, Rd,
// Cu) may be read from different memories. P = 2: the friction rows split
// between the alpha's two lanes (friction_sums_pair).
template <typename M, typename T, int P = 1, typename RK, typename RC>
__device__ __forceinline__ T stage_cost(const T* x, const T* u, const RK& x_ref, const RK& u_ref,
                                        const RC& Qd, const RC& Rd, T w, const RC& Cu,
                                        const RK& cb, const RK& lam, int nc, T rho, int h = 0,
                                        int partner = 0) {
  constexpr int NU = M::NU;
  T stage;
  {
    T sq, dot, su = T(0);
    state_terms<M>(x, x_ref, Qd, sq, dot);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const T d = u[i] - u_ref[i];
      su = su + Rd[i] * d * d;
    }
    stage = T(0.5) * sq;
    stage = stage + T(0.5) * su;
    if constexpr (M::QI >= 0) stage = stage + w * (T(1) - k_abs(dot));
  }
  T s_bar = T(0), s_lam = T(0);
  if constexpr (P == 2) {
    friction_sums_pair<T, NU>(u, Cu, cb, lam, nc, rho, h, partner, s_bar, s_lam);
  } else {
    for (int r = 0; r < nc; ++r) {
      T c = T(0);
#pragma unroll
      for (int i = 0; i < NU; ++i) c = c + Cu[r * NU + i] * u[i];
      c = c + cb[r];
      const T l = lam[r];
      T z = l + rho * c;
      z = z < T(0) ? T(0) : z;  // max(z, 0) that keeps a NaN, as torch.clamp
      s_bar = s_bar + z * z;
      s_lam = s_lam + l * l;
    }
  }
  return stage + (s_bar - s_lam) / (T(2) * rho);
}

// u = ū + α·d + K·δx, the rows split between the alpha's two lanes: lane h
// computes rows h·UH .. h·UH + UH-1 and the pair exchanges them by shuffles.
template <typename T, int NU, int NE>
__device__ __forceinline__ void inputs_pair(const T* dx, T alpha, const Sm<T>& us_bar,
                                            const Sm<T>& ds, const Sm<T>& Ks, int h, int partner,
                                            T* u) {
  constexpr int UH = (NU + 1) / 2;
  T mine[UH], other[UH];
#pragma unroll
  for (int i = 0; i < UH; ++i) {
    const int row = h * UH + i < NU ? h * UH + i : NU - 1;  // past the last row: never used
    T kdx = T(0);
#pragma unroll
    for (int c = 0; c < NE; ++c) kdx = kdx + Ks[row * NE + c] * dx[c];
    mine[i] = us_bar[row] + alpha * ds[row] + kdx;
  }
#pragma unroll
  for (int i = 0; i < UH; ++i) other[i] = __shfl_xor_sync(FULL, mine[i], partner);
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = (i < UH) == (h == 0) ? mine[i % UH] : other[i % UH];
}

// The terminal cost of x against its reference row.
template <typename M, typename T, typename RK, typename RC>
__device__ __forceinline__ T terminal_cost(const T* x, const RK& x_ref, const RC& Qdf, T w) {
  T sq, dot;
  state_terms<M>(x, x_ref, Qdf, sq, dot);
  if constexpr (M::QI >= 0) return T(0.5) * sq + w * (T(1) - k_abs(dot));
  return T(0.5) * sq;
}

template <typename T, typename M, int P>
__global__ void __launch_bounds__(MAX_THREADS) line_search_kernel(const Args<T> a) {
  constexpr int NX = M::NX, NE = M::NE, NU = M::NU;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Plan& p = a.plan;
  const int N = a.N, G = p.G, GP = p.GP, nc = a.nc;
  const long long B = a.B;
  const int lane = threadIdx.x & 31;
  const int s = threadIdx.x >> p.lgGP;    // the lane's scenario in the block
  const int q = threadIdx.x & (GP - 1);   // its lane in the scenario
  const int k = q & (G - 1);              // its alpha
  const int half = q >> p.lgG;            // which of the alpha's P lanes
  const int base = lane & ~(GP - 1);      // the scenario's first lane in the warp
  const long long b0 = static_cast<long long>(blockIdx.x) * p.S;
  const bool in_range = b0 + s < B;
  const long long b = in_range ? b0 + s : B - 1;  // lanes past the last scenario read the last one
  const bool live = in_range && k < a.K;
  const T alpha = a.alphas[k < a.K ? k : a.K - 1];
  const bool priced = a.flags & FLAG_PRICE;
  const bool w_per_knot = a.flags & FLAG_W_PER_KNOT, cb_per_knot = a.flags & FLAG_CB_PER_KNOT;
  Stamp stamp(blockIdx.x == gridDim.x / 2 && threadIdx.x == 0);
  stamp();
  stamp();  // twice: their distance is what a stamp costs

  // slot `slot` as this lane reads it (knot slots in buffer `buf`)
  auto view = [&](int slot, int buf) {
    const int at = p.at[slot] + (slot >= FIRST_KNOT_SLOT ? p.knot_at + buf * p.knot_values : 0);
    return Sm<T>{sm + at + s * p.pitch[slot]};
  };
  // the block copies knot j's slab into buffer j & 1 (at j = N: x_ref, w)
  auto stage_knot = [&](int j) {
    T* to = sm + p.knot_at + (j & 1) * p.knot_values;
#pragma unroll
    for (int slot = FIRST_KNOT_SLOT; slot < SLOTS; ++slot) {
      const int rows = p.rows[slot];
      if (rows == 0 || (j == N && slot != SL_XREF && slot != SL_WK)) continue;
      const View<T>& v = a.in[p.source[slot]];
      stage(to + p.at[slot], v.p + static_cast<long long>(j) * rows * v.ld, v.ld, rows,
            p.pitch[slot], p, b0, B);
    }
  };

  // staged once: the constants, then knot 0; the model's constants by the
  // scenario's lane 0
#pragma unroll
  for (int slot = 0; slot < FIRST_KNOT_SLOT; ++slot) {
    if (slot == SL_MODEL || p.rows[slot] == 0) continue;
    const View<T>& v = a.in[p.source[slot]];
    stage(sm + p.at[slot], v.p, v.ld, p.rows[slot], p.pitch[slot], p, b0, B);
  }
  cp_async_commit();
  stage_knot(0);
  cp_async_commit();
  if (in_range && q == 0) M::load(a.prm, b, sm + p.at[SL_MODEL] + s * p.pitch[SL_MODEL]);
  stamp();

  const T h = column(a.in[IN_H], b)[0], rho = column(a.in[IN_RHO], b)[0];
  const Sm<T> Qd = view(SL_QD, 0), Qdf = view(SL_QDF, 0), Rd = view(SL_RD, 0),
              Cu = view(SL_CU, 0), model = view(SL_MODEL, 0);
  T J = T(0);
  if (priced) {
    // The scenario's lanes price xs_bar and us_bar, lane q knots q, q+GP, ...
    // (knot N: the terminal cost), the knots' rows from device memory and the
    // constants from shared memory; every lane adds the stage costs in knot
    // order, as a rollout does.
    cp_async_wait_prior<1>();
    __syncthreads();  // the constants have landed (knot 0 may still be on its way)
    const Col<T> xs_bar = column(a.in[IN_XS], b), us_bar = column(a.in[IN_US], b),
                 x_ref = column(a.in[IN_X_REF], b), u_ref = column(a.in[IN_U_REF], b),
                 w = column(a.in[IN_W], b), cb = column(a.in[IN_CB], b),
                 lam = column(a.in[IN_LAM], b);
    const T w_const = view(SL_W, 0)[0];
    T stages = T(0);
    for (int j0 = 0; j0 <= N; j0 += GP) {
      const int j = j0 + q;
      T cost = T(0);
      if (in_range && j <= N) {
        T x[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) x[i] = xs_bar[static_cast<long long>(j) * NX + i];
        if (j < N) {
          T u[NU];
#pragma unroll
          for (int i = 0; i < NU; ++i) u[i] = us_bar[static_cast<long long>(j) * NU + i];
          cost = stage_cost<M, T>(x, u, x_ref.at(static_cast<long long>(j) * NX),
                                   u_ref.at(static_cast<long long>(j) * NU), Qd, Rd,
                                   w_per_knot ? w[j] : w_const, Cu,
                                   cb.at(cb_per_knot ? static_cast<long long>(j) * nc : 0),
                                   lam.at(static_cast<long long>(j) * nc), nc, rho);
        } else {
          cost = terminal_cost<M>(x, x_ref.at(static_cast<long long>(N) * NX), Qdf,
                               w_per_knot ? w[N] : w_const);
        }
      }
      for (int i = 0; i < GP && j0 + i <= N; ++i) {
        const T got = __shfl_sync(FULL, cost, base + i);
        if (j0 + i < N)
          stages = stages + got;
        else
          J = stages + got;
      }
    }
  } else {
    J = column(a.in[IN_J], b)[0];
  }
  stamp();

  // The rollouts. Each alpha writes x at every knot and u at every stage to
  // the trajectory slab: row e of scenario s, alpha k at traj[e·tst]. With
  // two lanes an alpha both hold the whole x and u and every running sum.
  T* traj = p.traj_at >= 0 ? sm + p.traj_at + s * G + k : a.scratch + b * G + k;
  const long long tst = p.traj_at >= 0 ? static_cast<long long>(p.S) * G : B * G;
  const bool keep = live && half == 0;
  cp_async_wait_all();
  __syncthreads();  // the constants, the model and knot 0 have landed
  stamp();
  T x[NX];
  {
    const Sm<T> xs0 = view(SL_XS, 0);
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xs0[i];
  }
  T stages = T(0);
#pragma unroll 1
  for (int j = 0; j < N; ++j) {
    const int buf = j & 1;
    if (j > 0) {
      cp_async_wait_all();
      __syncthreads();  // knot j has landed; every lane is done with knot j-1's buffer
      stamp();
    }
    stage_knot(j + 1);
    stamp();
    if (P == 2 || in_range) {  // pairs shuffle: every lane takes part
      const Sm<T> xb = view(SL_XS, buf), us_bar = view(SL_US, buf), Ks = view(SL_KS, buf),
                  ds = view(SL_DS, buf);
      T u[NU];
      // δx = x ⊖ xs_bar[j]
      T dx[NE];
      state_diff<M>(x, xb, dx);
      // u = ū + α·d + K·δx
      if constexpr (P == 2) {
        inputs_pair<T, NU, NE>(dx, alpha, us_bar, ds, Ks, half, G, u);
      } else {
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          T kdx = T(0);
#pragma unroll
          for (int c = 0; c < NE; ++c) kdx = kdx + Ks[i * NE + c] * dx[c];
          u[i] = us_bar[i] + alpha * ds[i] + kdx;
        }
      }
      if (keep) {
        const long long row = static_cast<long long>(j) * NX;
#pragma unroll
        for (int i = 0; i < NX; ++i) traj[(row + i) * tst] = x[i];
        const long long urow = static_cast<long long>(N + 1) * NX + static_cast<long long>(j) * NU;
#pragma unroll
        for (int i = 0; i < NU; ++i) traj[(urow + i) * tst] = u[i];
      }
      const T stage = stage_cost<M, T, P>(
          x, u, view(SL_XREF, buf), view(SL_UREF, buf), Qd, Rd,
          w_per_knot ? view(SL_WK, buf)[0] : view(SL_W, 0)[0], Cu,
          cb_per_knot ? view(SL_CBK, buf) : view(SL_CB, 0), view(SL_LAM, buf), nc, rho, half, G);
      stages = stages + stage;
      M::step(x, u, model, h);
    }
    stamp();
  }
  cp_async_wait_all();
  __syncthreads();  // knot N's x_ref (and w) have landed
  stamp();
  T J_k = T(0);
  if (in_range) {
    const int buf = N & 1;
    J_k = stages + terminal_cost<M>(x, view(SL_XREF, buf), Qdf,
                                 w_per_knot ? view(SL_WK, buf)[0] : view(SL_W, 0)[0]);
    if (keep) {
#pragma unroll
      for (int i = 0; i < NX; ++i) traj[(static_cast<long long>(N) * NX + i) * tst] = x[i];
    }
  }
  stamp();

  // Armijo against the expected decrease, then the first passing alpha
  const T dV1 = column(a.in[IN_DV1], b)[0], dV2 = column(a.in[IN_DV2], b)[0];
  const T expected = -(alpha * dV1 + alpha * alpha * dV2);
  bool ok = expected > T(0)
                ? (J - J_k) / (expected < T(1e-30) ? T(1e-30) : expected) > T(1e-4)
                : J_k < J + T(1e-12);
  ok = ok && live && half == 0 && K2_ISFINITE(J_k);
  const unsigned votes = __ballot_sync(FULL, ok);
  const unsigned mine = G == 32 ? votes : (votes >> base) & ((1u << G) - 1u);
  const bool accepted = mine != 0u;
  const int first = accepted ? __ffs(mine) - 1 : 0;
  const T J_first = __shfl_sync(FULL, J_k, base + first);
  const T J_ls = accepted ? J_first : J;
  const bool improved = accepted && J_ls < J;
  const bool take = in_range && improved && !a.done[b];
  int* sel = reinterpret_cast<int*>(sm + p.sel_at);
  if (q == 0) {
    sel[s] = take;
    sel[p.S + s] = first;
  }
  if (in_range && q == 0) {
    a.J_in[b] = J;
    a.J_out[b] = take ? J_ls : J;
    a.accepted[b] = accepted;
    a.improved[b] = improved;
  }
  if (live && half == 0 && a.costs != nullptr) a.costs[static_cast<long long>(k) * B + b] = J_k;
  stamp();
  __syncthreads();  // every scenario's choice and trajectory are in place
  stamp();

  // The block writes xs and us, thread t scenario t mod S: the selected
  // lane's trajectory, or xs_bar and us_bar where the step is not taken.
  {
    const int ws = threadIdx.x & (p.S - 1);
    const long long wb = b0 + ws;
    if (wb < B) {
      const T* from = p.traj_at >= 0 ? sm + p.traj_at + ws * G + sel[p.S + ws]
                                     : a.scratch + wb * G + sel[p.S + ws];
      const long long rows_x = static_cast<long long>(N + 1) * NX;
      const View<T> xs_bar = a.in[IN_XS], us_bar = a.in[IN_US];
      const int e0 = threadIdx.x >> p.lgS, step = GP;
      if (sel[ws]) {
        copy_rows(a.xs + wb, B, from, tst, rows_x, e0, step);
        copy_rows(a.us + wb, B, from + rows_x * tst, tst, static_cast<long long>(N) * NU, e0,
                  step);
      } else {
        copy_rows(a.xs + wb, B, xs_bar.p + wb, xs_bar.ld, rows_x, e0, step);
        copy_rows(a.us + wb, B, us_bar.p + wb, us_bar.ld, static_cast<long long>(N) * NU, e0,
                  step);
      }
    }
  }
  stamp();
}

// The kernel's arguments from the wrapper's tables, with the launch's plan
// for model M.
template <typename T, typename M>
Args<T> make_args(const void* const* in, const long long* st, void* const* out, int N, int B,
                  int K, int nc, int flags, int sms) {
  Args<T> a;
  // a staged input is batch-last and contiguous (the wrapper lays it out
  // so): batch stride 1 and batch extent B, or 0 where every scenario shares
  // it (extent 1)
  for (int i = 0; i < INPUTS; ++i)
    a.in[i] = View<T>{static_cast<const T*>(in[i]), st[2 * i + 1] == 0 ? 1 : B};
  for (int i = 0; i < PARAMS; ++i)
    a.prm[i] = In<T>{static_cast<const T*>(in[IN_FOOT + i]), st[2 * (IN_FOOT + i)],
                     st[2 * (IN_FOOT + i) + 1]};
  a.alphas = static_cast<const T*>(in[IN_ALPHAS]);
  a.done = static_cast<const unsigned char*>(in[IN_DONE]);
  a.scratch = static_cast<T*>(const_cast<void*>(in[IN_SCRATCH]));
  a.xs = static_cast<T*>(out[XS_OUT]);
  a.us = static_cast<T*>(out[US_OUT]);
  a.J_in = static_cast<T*>(out[J_IN_OUT]);
  a.J_out = static_cast<T*>(out[J_OUT]);
  a.accepted = static_cast<unsigned char*>(out[ACCEPTED]);
  a.improved = static_cast<unsigned char*>(out[IMPROVED]);
  a.costs = static_cast<T*>(out[COSTS]);
  a.N = N, a.B = B, a.K = K, a.nc = nc, a.flags = flags;
  a.plan = make_plan<T>(a.in, N, B, K, M::NX, M::NE, M::NU, M::VALUES, nc, flags, sms);
  return a;
}

}  // namespace

// The table's sizes, so that the wrapper checks its order against the one
// compiled, and the values an input has in the second table: 2, its row and
// batch stride (a source before them wrote no third value: there it was 1,
// the input's batch extent).
extern "C" void line_search_table(int* out) {
  out[0] = INPUTS;
  out[1] = OUTPUTS;
  out[2] = 2;
}

// The instantiations' tags, space-separated, in the order of their indices
// (the flags' model bits).
extern "C" const char* line_search_tags() { return TAGS; }

#ifdef __CUDACC__  // the host side: the launch and the C interface

namespace {

// The current card's multiprocessors (asked once a card).
inline int multiprocessors() {
  static int known[64] = {};
  int device = 0, n = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return 132;
  if (known[device] == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || n < 1)
      return 132;
    known[device] = n;
  }
  return known[device];
}

template <typename T, typename M, int P>
int launch_lanes(const Args<T>& a, void* stream) {
  // Above 48 KB a block's dynamic shared memory has to be asked for, on
  // every launch: the attribute is the current card's, and a launch may be
  // on another card than the last
  if (a.plan.bytes > (48 << 10)) {
    const cudaError_t allowed = cudaFuncSetAttribute(
        line_search_kernel<T, M, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(a.plan.bytes));
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
  }
  line_search_kernel<T, M, P><<<a.plan.blocks, a.plan.threads, a.plan.bytes,
                                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One launch of model M's kernel (with_model's fn).
template <typename T>
struct Launch {
  const void* const* in;
  const long long* st;
  void* const* out;
  int N, B, K, nc, flags;
  void* stream;

  template <typename M>
  int run() {
    const Args<T> a = make_args<T, M>(in, st, out, N, B, K, nc, flags, multiprocessors());
    if (a.plan.bytes > SMEM_LIMIT || (a.plan.traj_at < 0 && a.scratch == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    return a.plan.P == 2 ? launch_lanes<T, M, 2>(a, stream) : launch_lanes<T, M, 1>(a, stream);
  }
};

template <typename T>
int launch(const void* const* in, const long long* st, void* const* out, int N, int B, int K,
           int n_feet, int nc, int flags, void* stream) {
  if (N < 1 || B < 1 || K < 1 || K > 32 || nc < 0 || n_feet < 1 || n_feet > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch<T> fn{in, st, out, N, B, K, nc, flags, stream};
  const int err = with_model<Separate>(flags >> MODEL_SHIFT, n_feet, fn);
  return err < 0 ? static_cast<int>(cudaErrorInvalidValue) : err;
}

}  // namespace

extern "C" int line_search_f32(const void* const* in, const long long* st, void* const* out,
                               int N, int B, int K, int n_feet, int nc, int flags,
                               void* stream) {
  return launch<float>(in, st, out, N, B, K, n_feet, nc, flags, stream);
}

extern "C" int line_search_f64(const void* const* in, const long long* st, void* const* out,
                               int N, int B, int K, int n_feet, int nc, int flags,
                               void* stream) {
  return launch<double>(in, st, out, N, B, K, n_feet, nc, flags, stream);
}

#ifdef K2_PLAN_OVERRIDE
// The (S, P) of the following launches (0: the policy's).
extern "C" void line_search_override(int S, int P) {
  override_S = S;
  override_P = P;
}
#endif

#ifdef K2_PHASE_CLOCKS
// The first n stamps of the last launch, to host memory (synchronises).
extern "C" int line_search_clocks(long long* out, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, phase_clocks, sizeof(long long) * n));
}
#endif

#endif  // __CUDACC__
