// K9 — the solve's open-loop rollout and the AL pricing of a trajectory, for
// each model K2 has: the quaternion SRB (midpoint rule), the Euler SRB of
// the convex baseline (midpoint rule and forward Euler) and the attitude
// model of falling_cat (midpoint rule). Two entries a type:
// - rollout: xs (N+1, nx, B) of the inputs us (N, nu, B) from x0, each knot
//   the model's step (solver/fleet.open_loop_rollout);
// - price: the AL cost J (B,) of a trajectory (xs, us) (solver/fleet.
//   total_cost) and, where asked, the multipliers' update λ̄ = max(λ + ρ·(Cu·u
//   + cb), 0) (N, nc, B) (solver/fleet.make_fleet_solver's update after an AL
//   iteration). The solver prices its final trajectory with λ = 0 and ρ =
//   1e-30 (no λ given: zero), and takes λ̄ alone after each AL iteration.
//
// Replaces the regions XLA fused for the JAX package at
// quaternion_mpc_tpu/solver/fleet.py:728-732 (the init_step lax.scan of the
// open-loop rollout), :829-831 (total_cost :388 of the final trajectory) and
// :815-818 (the multiplier update). There is no Pallas kernel for them; eager
// PyTorch runs them (the plain versions) as ~130 launches a knot of the
// rollout and ~200-530 for a pricing: most of the launches of a solve
// outside K1, K2 and K8 (PERF.md).
//
// What it computes, for scenario b: the rollout x_0 = x0, x_{k+1} =
// step(x_k, u_k) (the model's, csrc/step_models.cuh); the pricing, per stage
// knot j < N, ½Σ Qd·dx² + ½Σ Rd·du² + w·(1 − |q·q_ref|) + (Σ λ̄² − Σ λ²)/(2ρ)
// with dx = x_j − x_ref_j, du = u_j − u_ref_j and λ̄ = max(λ_j + ρ·(Cu·u_j +
// cb_j), 0), then the terminal ½Σ Qdf·dx² + w·(1 − |q·q_ref|) (the geodesic
// terms only where the state holds a quaternion), J the sum of the stage
// terms over the knots plus the terminal.
//
// Every value is computed by the operations PyTorch does for the plain
// version on the card, each rounded alike: built -fmad=false
// (kernels/rollout.FLAGS), the models' steps with the `AsTorch` rounding
// (a cross product's terms fused as torch.linalg.cross's, the sine and the
// cosine apart), and every torch.sum of the plain version (the feet's forces
// and moments, Cu·u, the sums over the state's and the inputs' rows, over the
// inequality rows and over the knots) in the order of PyTorch's CUDA
// reduction over a dimension of stride > 1 (`torch_sum`: four accumulators
// from 0, then added in order). So at B > 1 the rollout's xs and λ̄ equal the
// plain version's bit for bit, and J too (chip_smoke.py holds them so): the
// closed loops take the steps they took before, whose f32 fate is set by
// rounding (PERF.md). At B = 1 PyTorch reduces the rows of a sum that lie
// next to each other in memory by another scheme, and the last bits may
// differ. A non-finite value spreads as in the plain version (a runaway
// falling_cat start).
//
// What bounds it on an H100: bytes at the fleet's sizes (kernels/rollout.work:
// the rollout reads us and writes xs, the pricing reads xs, us, the
// references and Cu, and writes J and λ̄). Below that, the rollout's time is
// one scenario's serial chain of N `advance`s (its latency floor, which the
// bytes bound does not state: k1_phase_clocks.py k9), and a pricing's the
// latency of a knot's loads and its inequality rows.
//
// Design (each choice timed on an H100 against the first, simple one, PR
// 21's: chip_smoke.py --kernels-only --k9-baseline; PERF.md):
// - rollout: a block of S scenarios (RollPlan: S halves from 32 down to 8
//   while the blocks would not fill the SMs; threads trimmed until every
//   block is resident at once). The step is split (step_models.cuh): what
//   depends on the inputs alone, the drive (the SRBs' forces, moment, v̇ and
//   ω̇; the attitude model's u), is computed first for every knot at once, a
//   thread a (knot, scenario), from us rows read coalesced and the
//   scenario's constants, which its first thread computes once (M::load,
//   every parameter read before the inverse's divisions) and hands on
//   through shared memory; the drives go to shared memory. Then a thread a
//   scenario runs the chain of N `advance`s with x in registers, each
//   knot's drive read from shared memory a step ahead, so that no load from
//   device memory remains on the chain; each xs row is written coalesced
//   along the batch-last axis. Knots beyond what 48 KB holds go in passes.
// - price: a block of S scenarios x `rows` knot rows; a knot of a scenario
//   takes four lanes of one warp (lane s + 8q, q < 4, a warp 8 scenarios),
//   lane q its inequality rows r ≡ q (mod 4), its state and input rows
//   i ≡ q (mod 4) and the quaternion's q-th product: exactly accumulator q of
//   `torch_sum`, the four combined as ((a0 + a1) + a2) + a3 by shuffles, so
//   the bits are the simple design's. The block stages its tile's Cu, and cb
//   and λ of its knots, in shared memory by cp.async once (a leaf every
//   scenario shares once for all), each
//   scenario's rows a pitch apart that puts the four lanes' rows in
//   distinct banks; the first knot's operands load while the copies land,
//   and in f32 each next knot's while a lane computes the current one (in
//   f64 the registers that would take cost a block an SM). The final cost
//   keeps a tile's knots in one block; after a barrier the block's threads
//   divide each knot's Σ λ̄² − Σ λ² by 2ρ, and each scenario's costs are
//   summed in torch_sum's knot order (no atomics: their order would move the
//   bits). The multiplier update, with no sum over the knots, runs a grid
//   over (scenario tile, knot group), in groups only below a wave of tiles.
// What holds it back (k1_phase_clocks.py k9, PERF.md): the rollout's
// constants (the inertia's nine divisions, one after another) and its
// chain; the pricing's copies (bandwidth from L2) and its rows' address
// arithmetic.
// Everything that changes between calls (h, ρ, x0, us, λ) is read from
// device memory, so a captured CUDA graph replays it right.
//
// Layout: every input is read through a row stride and a batch stride
// (batch_last.cuh In), so that the batch-first model parameters
// (params_to_fleet's movedim) are read in place; the outputs are batch-last
// and contiguous. The input table's order is enum Input below (K8's, csrc/
// expansions.cu); an entry an entry does not read may be null.
//
// C interface (bound with ctypes): rollout_f32 / _f64 and price_f32 / _f64
// take the input table, its (row stride, batch stride) pairs, the output
// table (enum Output; null for an output not asked for), N, B, n_feet (1-4;
// 1 for the attitude model), nc (the inequality's rows) and flags (FLAG_*,
// the instantiation's index at MODEL_SHIFT), and a cudaStream_t; they launch
// on that stream and return the CUDA error of the launch. rollout_table(out)
// writes the tables' sizes and rollout_tags() the instantiations' tags, so
// that the wrapper checks them; rollout_plans writes the launches' plans.
//
// Build options: -DK9_PLAN_OVERRIDE adds rollout_override and price_override,
// which set the plans of the following launches (chip_smoke.py times them in
// turns); -DK9_PHASE_CLOCKS makes thread 0 of one block stamp clock64() at
// the ends of its phases, read back by rollout_clocks (k1_phase_clocks.py
// k9); -DK9_UNSTAGED makes the pricing read Cu, cb and λ from device memory.
//
// The device code also compiles as plain C++ (no __CUDACC__) against
// tests/cuda_emulation.h; tests/test_torch_line_search_emulation.py holds it
// against the plain version that way.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#include <cmath>
#endif

#include <cstddef>

#include "step_models.cuh"

namespace {

// the inputs, in the order of the wrapper's table (nx, nu: the model's state
// and input); the rollout reads x0 (at IN_XS: (nx)), us, the parameters and
// h, the pricing the rest
enum Input {
  IN_XS, IN_US,               // xs (N+1, nx) or the rollout's x0 (nx), us (N, nu)
  IN_X_REF, IN_U_REF,         // (N+1, nx), (N+1, nu)
  IN_QD, IN_QDF, IN_RD, IN_W,  // (nx), (nx), (nu), w (1) or per knot (N+1)
  IN_CU, IN_CB, IN_LAM,        // (nc, nu), cb (nc) or per knot (N+1, nc), λ (N, nc) or null: 0
  // the model's parameters in the order of step_models.cuh enum Param (null
  // where a model has none of them)
  IN_FOOT, IN_INERTIA, IN_MASS, IN_COM_OFFSET, IN_COM_MASS, IN_ROT,
  IN_H, IN_RHO,                // one value a scenario, shared or not
  INPUTS
};
// the outputs: the rollout's xs (N+1, nx, B); the pricing's J (B) and λ̄ (N,
// nc, B), each null where not asked for
enum Output { OUT_XS, OUT_J, OUT_LAM, OUTPUTS };
// flags: w or cb per knot; the instantiation's index (enum Model) from bit
// MODEL_SHIFT on
constexpr int FLAG_W_PER_KNOT = 1, FLAG_CB_PER_KNOT = 2, MODEL_SHIFT = 8;

// A pricing knot's lanes: inequality row r on lane r mod LANES (torch_sum's
// accumulator); a warp holds GROUP scenarios.
constexpr int LANES = 4, GROUP = 32 / LANES;
// a block's most threads (at 512 ptxas spills an f32 pricing)
constexpr int MAX_THREADS = 256;
// a rollout's shared memory for its drives (so that no attribute is needed);
// a block's most
constexpr size_t ROLL_SMEM = 48 << 10, SMEM_LIMIT = 227 << 10;

// A rollout's launch: S scenarios a block, `threads` threads (a multiple of
// S and of 32; the first S run the chains), the knots whose drives one pass
// holds, the blocks and the dynamic shared memory in bytes.
struct RollPlan {
  int S, threads, chunk, blocks;
  size_t bytes;
};
// A pricing's launch: S scenarios a block (a multiple of GROUP), `rows` knot
// rows (threads = LANES·S·rows), `knots` knots a block (`groups` blocks a
// tile; the final cost: every knot, one group), `tiles` tiles of S
// scenarios; shared memory: the staged Cu, cb and λ (at *_at, in elements,
// -1 where read from device memory) with each scenario's rows `pitch` or
// `lpitch` apart, the knots' costs and AL terms at cost_at; `bytes` in all.
struct PricePlan {
  int S, rows, knots, groups, tiles, blocks, threads;
  int pitch, lpitch, cu_at, cb_at, lam_at, cost_at;
  size_t bytes;
};

#ifdef K9_PLAN_OVERRIDE
int roll_plan_override[2] = {0, 0};      // S, threads (0: the policy's)
int price_plan_override[3] = {0, 0, 0};  // S, rows, knots a block of the multiplier update
#endif

template <typename T>
struct Args {
  In<T> in[INPUTS];
  T* xs;       // (N+1, nx, B) or null
  T* J;        // (B) or null
  T* lam_bar;  // (N, nc, B) or null
  int N, B, nc, flags;
  RollPlan roll;
  PricePlan price;
};

#ifdef K9_PHASE_CLOCKS
constexpr int CLOCK_SLOTS = 160;
__device__ long long phase_clocks[CLOCK_SLOTS];
__device__ int clock_block = -1;  // the block whose thread 0 stamps
#define K9_STAMP(slot)                                                            \
  do {                                                                            \
    if (static_cast<int>(blockIdx.x) == clock_block && threadIdx.x == 0 &&        \
        (slot) < CLOCK_SLOTS)                                                     \
      phase_clocks[(slot)] = clock64();                                           \
  } while (0)
#else
#define K9_STAMP(slot)
#endif

// Σ p(i), i < n, in the order of PyTorch's CUDA sum over a dimension of
// stride > 1 (the plain version's sums at a batch of B > 1): term i into
// accumulator i mod 4, each accumulator from 0 and in index order, then the
// four added in order (one thread's reduction in its Reduce.cuh, vt0 = 4).
// The accumulators are indexed by the unrolled inner loop alone, so that they
// stay in registers at a count n known only at run time.
template <typename T, typename F>
__device__ __forceinline__ T torch_sum(int n, const F& p) {
  T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int i = 0; i < n; i += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (i + q < n) acc[q] = acc[q] + p(i + q);
  }
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

// ((a0 + a1) + a2) + a3 of the four lanes of a knot (lane s + 8q holds a_q),
// on its lane q = 0: torch_sum's last step. Every lane of the warp takes part.
template <typename T>
__device__ __forceinline__ T combine(T a) {
#ifdef __CUDACC__
  constexpr unsigned FULL = 0xffffffffu;
#else
  constexpr unsigned FULL = 0;
#endif
  const int base = static_cast<int>(threadIdx.x) & (GROUP - 1);
  const T a1 = __shfl_sync(FULL, a, base + GROUP), a2 = __shfl_sync(FULL, a, base + 2 * GROUP),
          a3 = __shfl_sync(FULL, a, base + 3 * GROUP);
  return ((a + a1) + a2) + a3;
}

template <typename T>
__device__ __forceinline__ T k_fabs(T x) {
#ifdef __CUDACC__
  return fabs(x);
#else
  return std::fabs(x);
#endif
}

// One element from device memory to shared memory, asynchronously.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
#ifdef __CUDACC__
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(to), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

template <typename T, typename M>
__global__ void __launch_bounds__(MAX_THREADS) rollout_kernel(const Args<T> a) {
  constexpr int NX = M::NX, NU = M::NU, D = M::D, V = M::VALUES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* consts = reinterpret_cast<T*>(smem_raw);  // [i * S + s]: scenario s's constants
  T* drives = consts + V * a.roll.S;           // [(k * D + i) * S + s]: a pass's drives
  K9_STAMP(0);
  const int S = a.roll.S, t = static_cast<int>(threadIdx.x), s = t % S, R = a.roll.threads / S,
            row = t / S, N = a.N, chunk = a.roll.chunk;
  const long long B = a.B, b = static_cast<long long>(blockIdx.x) * S + s;
  const bool in = b < B, chain = t < S;
  const Col<T> us = column(a.in[IN_US], in ? b : 0);
  T m[V > 0 ? V : 1];
  const Sm<T> model{m};
  // the first knot's inputs start loading before the constants' barrier
  T u[NU];
  if (in && row < (chunk < N ? chunk : N)) {
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = us[static_cast<long long>(row) * NU + i];
  }
  T x[NX], h = T(0);
  T* xs = a.xs + b;
  if (chain && in) {
    const Col<T> x0 = column(a.in[IN_XS], b);
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x0[i];
    h = column(a.in[IN_H], b)[0];
    M::load(a.in + IN_FOOT, b, m);
#pragma unroll
    for (int i = 0; i < V; ++i) consts[i * S + s] = m[i];
  }
  __syncthreads();
  K9_STAMP(1);
  if (!chain && in) {
#pragma unroll
    for (int i = 0; i < V; ++i) m[i] = consts[i * S + s];
  }
  if (chain && in) {
#pragma unroll
    for (int i = 0; i < NX; ++i) xs[i * B] = x[i];
  }
  for (int k0 = 0; k0 < N; k0 += chunk) {
    const int kc = N - k0 < chunk ? N - k0 : chunk;
    // the drives of this pass's knots, a thread a (knot, scenario)
    if (in) {
#pragma unroll 1
      for (int k = row; k < kc; k += R) {
        if (k0 > 0 || k != row) {
#pragma unroll
          for (int i = 0; i < NU; ++i) u[i] = us[static_cast<long long>(k0 + k) * NU + i];
        }
        T d[D];
        M::drive(u, model, d);
#pragma unroll
        for (int i = 0; i < D; ++i) drives[(k * D + i) * S + s] = d[i];
      }
    }
    __syncthreads();
    if (k0 == 0) K9_STAMP(2);
    // the chain: each knot's drive read a step ahead
    if (chain && in) {
      T d[D];
#pragma unroll
      for (int i = 0; i < D; ++i) d[i] = drives[i * S + s];
#pragma unroll 1
      for (int k = 0; k < kc; ++k) {
        T next[D];
        const int kn = k + 1 < kc ? k + 1 : k;
#pragma unroll
        for (int i = 0; i < D; ++i) next[i] = drives[(kn * D + i) * S + s];
        M::advance(x, d, model, h);
        T* row_k = xs + static_cast<long long>(k0 + k + 1) * NX * B;
#pragma unroll
        for (int i = 0; i < NX; ++i) row_k[i * B] = x[i];
        K9_STAMP(3 + k0 + k);
#pragma unroll
        for (int i = 0; i < D; ++i) d[i] = next[i];
      }
    }
    if (k0 + kc < N) __syncthreads();  // the next pass overwrites the drives
  }
}

// Input i's rows of scenario b as the pricing reads them: staged in shared
// memory (at `at`, -1: not staged; `shared`: one column for every scenario,
// else scenario s at s with rows `pitch` apart), else in device memory; from
// row `first` of the staged ones (or of the input) on.
template <typename T>
__device__ __forceinline__ Col<T> rows_of(const In<T>& v, const T* sm, int at, int pitch, int s,
                                          long long b, long long first) {
  if (at < 0) return column(v, b).at(first);
  return v.bs == 0 ? Col<T>{sm + at + first, 1} : Col<T>{sm + at + first * pitch + s, pitch};
}

// Input i's rows [first, first + n) of the tile's scenarios to shared memory
// at `at` (rows_of's layout) by cp.async, the block's threads over them:
// thread t copies scenario t mod S's rows t / S, t / S + threads / S, ...
// (threads a multiple of S), neighbouring threads neighbouring scenarios.
template <typename T>
__device__ __forceinline__ void stage(const In<T>& v, T* sm, int at, int pitch, long long first,
                                      int n, int S, long long b0, long long B) {
  const int t = static_cast<int>(threadIdx.x), threads = static_cast<int>(blockDim.x);
  if (at < 0 || v.p == nullptr) return;
  if (v.bs == 0) {
    for (int e = t; e < n; e += threads) cp_async(sm + at + e, v.p + (first + e) * v.rs);
    return;
  }
  const int s = t % S, r0 = t / S, dr = threads / S;
  if (b0 + s >= B) return;
  const long long step = static_cast<long long>(dr) * v.rs;
  const T* from = v.p + (first + r0) * v.rs + (b0 + s) * v.bs;
  T* to = sm + at + r0 * pitch + s;
  for (int r = r0; r < n; r += dr, from += step, to += dr * pitch) cp_async(to, from);
}

// One knot's operands from device memory as lane q reads them: its rows
// i ≡ q (mod 4) of x, x_ref (and of u and u_ref for the input's sum), every
// row of u (for Cu·u), the quaternion's q-th pair, w.
template <typename T, typename M>
struct Knot {
  static constexpr int RX = (M::NX + LANES - 1) / LANES, RU = (M::NU + LANES - 1) / LANES;
  T x[RX], x_ref[RX], uq[RU], u_ref[RU], u[M::NU], xq, xrq, w;
};

// Knot j's operands (stage knots: u too; with `priced` the cost's).
template <typename T, typename M>
__device__ __forceinline__ void load_knot(Knot<T, M>& k, const Args<T>& a, long long b, int j,
                                          int q, bool priced) {
  constexpr int NX = M::NX, NU = M::NU;
  const long long jl = j;
  const Col<T> us = column(a.in[IN_US], b).at(jl * NU);
  if (j < a.N) {
#pragma unroll
    for (int i = 0; i < NU; ++i) k.u[i] = us[i];
  }
  if (!priced) return;
  const Col<T> x = column(a.in[IN_XS], b).at(jl * NX), x_ref = column(a.in[IN_X_REF], b).at(jl * NX);
#pragma unroll
  for (int r = 0; r < Knot<T, M>::RX; ++r)
    if (q + LANES * r < NX) k.x[r] = x[q + LANES * r], k.x_ref[r] = x_ref[q + LANES * r];
  if (j < a.N) {
    const Col<T> u_ref = column(a.in[IN_U_REF], b).at(jl * NU);
#pragma unroll
    for (int r = 0; r < Knot<T, M>::RU; ++r)
      if (q + LANES * r < NU) k.uq[r] = us[q + LANES * r], k.u_ref[r] = u_ref[q + LANES * r];
  }
  if constexpr (M::QI >= 0) {
    k.xq = x[M::QI + q], k.xrq = x_ref[M::QI + q];
    k.w = column(a.in[IN_W], b)[a.flags & FLAG_W_PER_KNOT ? jl : 0];
  }
}

// A stage knot's inequality rows on lane q: c = Cu·u + cb, λ̄ = max(λ + ρ·c, 0)
// (a NaN kept, as torch.clamp) to lam_bar (row r at lam_bar[r·ld], null: not
// asked for), and lane q's accumulators of Σ λ̄² and Σ λ² (rows r ≡ q).
// cu(e), cb(r) and lam(r) read Cu's element e = r·nu + i, cb's and λ's row r.
template <typename T, typename M, typename CU, typename CB, typename LAM>
__device__ __forceinline__ void knot_rows(int q, int nc, const T* u, T rho, const CU& cu,
                                          const CB& cb, const LAM& lam, bool has_lam, T* lam_bar,
                                          long long ld, T& bars, T& lams) {
  for (int r = q; r < nc; r += LANES) {
    const int e = r * M::NU;
    const T c = torch_sum<T>(M::NU, [&](int i) { return cu(e + i) * u[i]; }) + cb(r);
    const T l = has_lam ? lam(r) : T(0);
    T z = l + rho * c;
    z = z < T(0) ? T(0) : z;
    if (lam_bar != nullptr) lam_bar[r * ld] = z;
    bars = bars + z * z;
    lams = lams + l * l;
  }
}

template <typename T, typename M>
__global__ void __launch_bounds__(MAX_THREADS) price_kernel(const Args<T> a) {
  constexpr int NX = M::NX, NU = M::NU, RX = Knot<T, M>::RX, RU = Knot<T, M>::RU;
  // f32 loads each knot's operands a knot ahead; f64 keeps its registers
  constexpr bool AHEAD = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  K9_STAMP(0);
  const PricePlan& p = a.price;
  const int S = p.S, t = static_cast<int>(threadIdx.x), lane = t & 31, warp = t >> 5,
            per_row = S / GROUP, q = lane / GROUP, s = (warp % per_row) * GROUP + (lane & (GROUP - 1)),
            row = warp / per_row, N = a.N, nc = a.nc;
  const int tile = static_cast<int>(blockIdx.x) / p.groups,
            group = static_cast<int>(blockIdx.x) - tile * p.groups;
  const long long B = a.B, b0 = static_cast<long long>(tile) * S, b = b0 + s;
  const bool in = b < B, priced = a.J != nullptr;
  // a lane past the batch reads scenario B-1, so that every lane of a warp
  // runs the same knots and shuffles; it writes nothing
  const long long bl = in ? b : B - 1;
  const int j0 = group * p.knots, j_end = j0 + p.knots < N + priced ? j0 + p.knots : N + priced,
            stage_end = j_end < N ? j_end : N;
  const bool cb_per_knot = a.flags & FLAG_CB_PER_KNOT, has_lam = a.in[IN_LAM].p != nullptr;
  // the tile's Cu, and cb and λ of the block's stage knots
  stage(a.in[IN_CU], sm, p.cu_at, p.pitch, 0, nc * NU, S, b0, B);
  if (cb_per_knot)
    stage(a.in[IN_CB], sm, p.cb_at, p.lpitch, static_cast<long long>(j0) * nc,
          (stage_end - j0) * nc, S, b0, B);
  else
    stage(a.in[IN_CB], sm, p.cb_at, p.lpitch, 0, nc, S, b0, B);
  stage(a.in[IN_LAM], sm, p.lam_at, p.lpitch, static_cast<long long>(j0) * nc,
        (stage_end - j0) * nc, S, b0, B);
  K9_STAMP(1);
  // [j * S + s]: knot j's cost but the AL term, then stage knot j's Σ λ̄² − Σ λ²
  T* costs = sm + p.cost_at;
  T* al = costs + (N + 1) * S;
  // where each staged leaf's rows lie (a leaf every scenario shares: one
  // column), and whether all of them are staged
  const bool staged = p.cu_at >= 0 && p.cb_at >= 0 && (p.lam_at >= 0 || !has_lam);
  const int cu_ld = a.in[IN_CU].bs == 0 ? 1 : p.pitch, cb_ld = a.in[IN_CB].bs == 0 ? 1 : p.lpitch,
            lam_ld = a.in[IN_LAM].bs == 0 ? 1 : p.lpitch;
  const T* cu_s = sm + p.cu_at + (cu_ld == 1 ? 0 : s);
  const T* cb_s = sm + p.cb_at + (cb_ld == 1 ? 0 : s);
  const T* lam_s = sm + p.lam_at + (lam_ld == 1 ? 0 : s);
  // the scenario's weights (lane q's rows), and the first knot's operands
  // while the copies land
  T Qd[RX], Qdf[RX], Rd[RU];
  if (priced) {
    const Col<T> Qd_ = column(a.in[IN_QD], bl), Qdf_ = column(a.in[IN_QDF], bl),
                 Rd_ = column(a.in[IN_RD], bl);
#pragma unroll
    for (int r = 0; r < RX; ++r)
      if (q + LANES * r < NX) Qd[r] = Qd_[q + LANES * r], Qdf[r] = Qdf_[q + LANES * r];
#pragma unroll
    for (int r = 0; r < RU; ++r)
      if (q + LANES * r < NU) Rd[r] = Rd_[q + LANES * r];
  }
  const T rho = column(a.in[IN_RHO], bl)[0];
  Knot<T, M> cur, next;
  const int first = j0 + row;
  if (first < j_end) load_knot(cur, a, bl, first, q, priced);
  cp_async_wait_all();
  __syncthreads();
  K9_STAMP(2);
  // each knot: its state and input terms (the cost's), then the inequality's
  // rows
  for (int j = first; j < j_end; j += p.rows) {
    if constexpr (AHEAD) {
      if (j + p.rows < j_end) load_knot(next, a, bl, j + p.rows, q, priced);
    } else if (j != first) {
      load_knot(cur, a, bl, j, q, priced);
    }
    const long long jl = j;
    if (priced) {
      // Σ Qd·(x − x_ref)² (stage_cost_terms; Qdf: total_cost's terminal term),
      // lane q's accumulator of torch_sum
      T acc = T(0);
#pragma unroll
      for (int r = 0; r < RX; ++r)
        if (q + LANES * r < NX) {
          const T d = cur.x[r] - cur.x_ref[r];
          acc = acc + (j == N ? Qdf[r] : Qd[r]) * d * d;
        }
      T val = T(0.5) * combine(acc);
      if (j < N) {
        T acc_u = T(0);
#pragma unroll
        for (int r = 0; r < RU; ++r)
          if (q + LANES * r < NU) {
            const T d = cur.uq[r] - cur.u_ref[r];
            acc_u = acc_u + Rd[r] * d * d;
          }
        val = val + T(0.5) * combine(acc_u);
      }
      if constexpr (M::QI >= 0) {  // w·(1 − |q·q_ref|)
        const T dot = combine(T(0) + cur.xq * cur.xrq);
        val = val + cur.w * (T(1) - k_fabs(dot));
      }
      if (q == 0) costs[j * S + s] = val;
    }
    if (j < N) {
      T bars = T(0), lams = T(0);
      T* lam_bar = a.lam_bar != nullptr && in ? a.lam_bar + jl * nc * B + b : nullptr;
      const int kj = cb_per_knot ? j - j0 : 0, lj = j - j0;
      if (staged) {  // from shared memory
        knot_rows<T, M>(
            q, nc, cur.u, rho, [&](int e) { return cu_s[e * cu_ld]; },
            [&](int r) { return cb_s[(kj * nc + r) * cb_ld]; },
            [&](int r) { return lam_s[(lj * nc + r) * lam_ld]; }, has_lam, lam_bar, B, bars, lams);
      } else {  // what shared memory could not hold from device memory
        const Col<T> Cu = rows_of(a.in[IN_CU], sm, p.cu_at, p.pitch, s, bl, 0),
                     cb = rows_of(a.in[IN_CB], sm, p.cb_at, p.lpitch, s, bl,
                                  cb_per_knot ? (p.cb_at < 0 ? jl : jl - j0) * nc : 0),
                     lam = has_lam ? rows_of(a.in[IN_LAM], sm, p.lam_at, p.lpitch, s, bl,
                                             (p.lam_at < 0 ? jl : jl - j0) * nc)
                                   : Col<T>{nullptr, 0};
        knot_rows<T, M>(
            q, nc, cur.u, rho, [&](int e) { return Cu[e]; }, [&](int r) { return cb[r]; },
            [&](int r) { return lam[r]; }, has_lam, lam_bar, B, bars, lams);
      }
      if (priced) {
        const T s_bar = combine(bars), s_lam = combine(lams);
        if (q == 0) al[j * S + s] = s_bar - s_lam;
      }
    }
    if constexpr (AHEAD) cur = next;
  }
  K9_STAMP(3);
  if (!priced) return;  // every thread of the launch alike
  __syncthreads();
  // each stage knot's al_value (Σ λ̄² − Σ λ²) / (2ρ), the block's threads
  // over the (knot, scenario) pairs (the final cost's launch: a block a tile)
  {
    const int u_t = static_cast<int>(threadIdx.x), u_S = a.price.S, u_s = u_t % u_S;
    const long long u_b = static_cast<long long>(blockIdx.x) * u_S + u_s;
    if (u_b < a.B) {
      const T two_rho = T(2) * column(a.in[IN_RHO], u_b)[0];
      T* mine_al = reinterpret_cast<T*>(smem_raw) + a.price.cost_at + (a.N + 1) * u_S + u_s;
      for (int k = u_t / u_S; k < a.N; k += a.price.threads / u_S)
        mine_al[k * u_S] = mine_al[k * u_S] / two_rho;
    }
  }
  __syncthreads();
  K9_STAMP(4);
  // J: each stage cost plus its al_value, summed in torch_sum's order, and
  // the terminal's; the indices read afresh, so that nothing stays live from
  // the knots' loop
  const int u_t = static_cast<int>(threadIdx.x);
  const long long u_b = static_cast<long long>(blockIdx.x) * a.price.S + u_t;
  if (u_t < a.price.S && u_b < a.B) {
    const int u_S = a.price.S;
    const T* mine = reinterpret_cast<T*>(smem_raw) + a.price.cost_at + u_t;
    const T* mine_al = mine + (a.N + 1) * u_S;
    a.J[u_b] = torch_sum<T>(a.N, [&](int k) { return mine[k * u_S] + mine_al[k * u_S]; }) +
               mine[a.N * u_S];
  }
  K9_STAMP(5);
}

constexpr int div_up(long long n, int d) { return static_cast<int>((n + d - 1) / d); }

// Whether `blocks` blocks of `threads` threads at `regs` registers a thread
// (0: not known) are all resident at once on `sms` SMs.
inline bool resident(long long blocks, int threads, int regs, int sms) {
  const int per_thread = (regs + 7) / 8 * 8;  // allocated by 8
  return regs <= 0 || static_cast<long long>(65536 / (per_thread * threads)) * sms >= blocks;
}

// The rollout's plan: S halves from 32 down to 8 while a launch would put
// fewer blocks than the card has SMs; a thread a (knot, scenario) up to
// MAX_THREADS, fewer while the blocks would not all be resident at once
// (`regs`, the kernel's registers a thread); as many knots a pass as
// ROLL_SMEM holds.
template <typename T, typename M>
RollPlan roll_plan(int N, int B, int sms, int regs) {
  RollPlan p{};
  int S = 32;
  while (S > 8 && div_up(B, S) < sms) S /= 2;
  int threads = div_up(static_cast<long long>(S) * N, 32) * 32;
  threads = threads < MAX_THREADS ? threads : MAX_THREADS;
  while (threads > 32 && !resident(div_up(B, S), threads, regs, sms)) threads -= 32;
#ifdef K9_PLAN_OVERRIDE
  if (roll_plan_override[0] > 0) S = roll_plan_override[0], threads = roll_plan_override[1];
#endif
  p.S = S, p.threads = threads;
  const size_t consts = static_cast<size_t>(M::VALUES) * S * sizeof(T),
               knot = static_cast<size_t>(M::D) * S * sizeof(T);
  const long long fit = ROLL_SMEM > consts + knot ? (ROLL_SMEM - consts) / knot : 1;
  p.chunk = static_cast<int>(fit < N ? fit : N);
  p.blocks = div_up(B, S);
  p.bytes = consts + p.chunk * knot;
  return p;
}

// The least pitch >= S at which the four lanes of a knot (rows r and r + 1,
// ..., n elements apart) read distinct banks: n·pitch ≡ 8 (mod 16).
inline int bank_pitch(int S, int n) {
  for (int p = S; p < S + 32; ++p)
    if ((n * p) % 16 == 8) return p;
  return S + 1;
}

// The pricing's plan: S as the rollout's; rows so that a block has
// MAX_THREADS threads, halved down to two while the tiles' blocks would not
// all be resident at once (`regs` as the rollout's; one row a block
// serialises its knots); the final cost every knot in
// one block, the multiplier update too where the tiles fill the card, else
// in knot groups that bring its blocks up to the SMs (each block stages its
// tile's Cu). Cu, cb and λ staged while the
// block's shared memory holds them (S halves first), the last that does not
// fit read from device memory.
template <typename T, typename M>
PricePlan price_plan(const In<T>* in, int N, int B, int nc, int flags, bool priced, int sms,
                     int regs) {
  PricePlan p{};
  int S = 32;
  while (S > GROUP && div_up(B, S) < sms) S /= 2;
  int rows = MAX_THREADS / (LANES * S);
  while (rows > 2 && !resident(div_up(B, S), LANES * S * rows, regs, sms)) rows /= 2;
  int groups = div_up(sms, div_up(B, S));
  groups = groups < div_up(N, rows) ? groups : div_up(N, rows);
  int knots = div_up(N, groups > 0 ? groups : 1);
#ifdef K9_PLAN_OVERRIDE
  if (price_plan_override[0] > 0) S = price_plan_override[0], rows = price_plan_override[1];
  if (price_plan_override[2] > 0) knots = price_plan_override[2];
#endif
  const int stage_knots = priced ? N : (knots < N ? knots : N);
  const bool cb_per_knot = flags & FLAG_CB_PER_KNOT;
  for (;;) {
    p.S = S, p.rows = rows, p.threads = LANES * S * rows;
    p.knots = priced ? N + 1 : knots;
    p.groups = priced ? 1 : div_up(N, knots);
    p.tiles = div_up(B, S);
    p.blocks = p.tiles * p.groups;
    p.pitch = bank_pitch(S, M::NU);
    p.lpitch = bank_pitch(S, 1);
    // in elements: Cu (nc·nu rows), cb (nc, or a knot's each), λ (a knot's nc
    // each), the costs and the AL terms
    const long long cu = static_cast<long long>(nc) * M::NU * (in[IN_CU].bs == 0 ? 1 : p.pitch),
                    cb = static_cast<long long>(cb_per_knot ? stage_knots : 1) * nc *
                         (in[IN_CB].bs == 0 ? 1 : p.lpitch),
                    lam = in[IN_LAM].p == nullptr
                              ? 0
                              : static_cast<long long>(stage_knots) * nc *
                                    (in[IN_LAM].bs == 0 ? 1 : p.lpitch),
                    costs = priced ? static_cast<long long>(2 * N + 1) * S : 0;
    const long long limit = static_cast<long long>(SMEM_LIMIT / sizeof(T));
    const bool all = costs + cu + cb + lam <= limit;
    if (all || S == GROUP) {
      long long at = costs;
      p.cost_at = 0;
      const long long sizes[3] = {cu, cb, lam};
      int* where[3] = {&p.cu_at, &p.cb_at, &p.lam_at};
      for (int i = 0; i < 3; ++i) {
#ifdef K9_UNSTAGED
        const bool fits = false;
#else
        const bool fits = at + sizes[i] <= limit && sizes[i] > 0;
#endif
        *where[i] = fits ? static_cast<int>(at) : -1;
        at += fits ? sizes[i] : 0;
      }
      p.bytes = static_cast<size_t>(at) * sizeof(T);
      return p;
    }
    S /= 2;
    rows *= 2;
  }
}

// The kernel's arguments from the wrapper's tables, with model M's plans.
// The rollout's (PRICE false) or the pricing's kernel's registers a thread
// (asked of the card once; 0 in the emulation, where nothing limits the
// blocks).
template <typename T, typename M, bool PRICE>
int kernel_regs() {
#ifdef __CUDACC__
  static int regs = 0;
  if (regs == 0) {
    cudaFuncAttributes attributes;
    if (cudaFuncGetAttributes(&attributes, PRICE ? price_kernel<T, M> : rollout_kernel<T, M>) ==
        cudaSuccess)
      regs = attributes.numRegs;
  }
  return regs;
#else
  return 0;
#endif
}

template <typename T, typename M>
Args<T> make_args(const void* const* in, const long long* st, void* const* out, int N, int B,
                  int nc, int flags, int sms) {
  Args<T> a;
  for (int i = 0; i < INPUTS; ++i)
    a.in[i] = In<T>{static_cast<const T*>(in[i]), st[2 * i], st[2 * i + 1]};
  a.xs = static_cast<T*>(out[OUT_XS]);
  a.J = static_cast<T*>(out[OUT_J]);
  a.lam_bar = static_cast<T*>(out[OUT_LAM]);
  a.N = N, a.B = B, a.nc = nc, a.flags = flags;
  a.roll = roll_plan<T, M>(N, B, sms, kernel_regs<T, M, false>());
  a.price = price_plan<T, M>(a.in, N, B, nc, flags, a.J != nullptr, sms, kernel_regs<T, M, true>());
  return a;
}

// A plan's validity: threads a whole number of warps, at most MAX_THREADS,
// the scenarios a multiple of what a warp holds, shared memory in range.
inline bool valid(const RollPlan& p) {
  return p.S >= 1 && p.threads % 32 == 0 && p.threads % p.S == 0 && p.threads <= MAX_THREADS &&
         p.chunk >= 1 && p.bytes <= SMEM_LIMIT;
}
inline bool valid(const PricePlan& p) {
  return p.S >= GROUP && p.S % GROUP == 0 && p.rows >= 1 && p.threads <= MAX_THREADS &&
         p.knots >= 1 && p.bytes <= SMEM_LIMIT;
}

// with_model's fn writing the plans of a launch (rollout_plans)
template <typename T>
struct PlanOf {
  const void* const* in;
  const long long* st;
  void* const* out;
  int N, B, nc, flags, sms;
  int* plan;

  template <typename M>
  int run() {
    const Args<T> a = make_args<T, M>(in, st, out, N, B, nc, flags, sms);
    const int values[] = {a.roll.S, a.roll.threads, a.roll.chunk, a.roll.blocks,
                          static_cast<int>(a.roll.bytes), a.price.S, a.price.rows, a.price.knots,
                          a.price.groups, a.price.blocks, a.price.threads,
                          static_cast<int>(a.price.bytes), a.price.cu_at, a.price.cb_at,
                          a.price.lam_at};
    for (int i = 0; i < 15; ++i) plan[i] = values[i];
    return 0;
  }
};

}  // namespace

// The tables' sizes, so that the wrapper checks its order against the one
// compiled.
extern "C" void rollout_table(int* out) {
  out[0] = INPUTS;
  out[1] = OUTPUTS;
}

// The instantiations' tags, space-separated, in the order of their indices
// (the flags' model bits).
extern "C" const char* rollout_tags() { return TAGS; }

// The plans of a launch on these tables for a card of `sms` SMs, 15 values to
// plan: the rollout's S, threads, chunk, blocks, bytes; the pricing's S,
// rows, knots, groups, blocks, threads, bytes and where Cu, cb and λ are
// staged (-1: read from device memory). Returns -1 for no such model.
extern "C" int rollout_plans(int is_f64, const void* const* in, const long long* st,
                             void* const* out, int N, int B, int n_feet, int nc, int flags,
                             int sms, int* plan) {
  if (is_f64) {
    PlanOf<double> fn{in, st, out, N, B, nc, flags, sms, plan};
    return with_model<AsTorch>(flags >> MODEL_SHIFT, n_feet, fn);
  }
  PlanOf<float> fn{in, st, out, N, B, nc, flags, sms, plan};
  return with_model<AsTorch>(flags >> MODEL_SHIFT, n_feet, fn);
}

#ifdef __CUDACC__  // the host side: the launches and the C interface

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

// Above 48 KB a block's dynamic shared memory has to be asked for, on every
// launch: the attribute is the current card's.
template <typename K>
cudaError_t allow(K kernel, size_t bytes) {
  if (bytes <= (48 << 10)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// One launch of model M's rollout or pricing (with_model's fn).
template <typename T, bool PRICE>
struct Launch {
  const void* const* in;
  const long long* st;
  void* const* out;
  int N, B, nc, flags;
  void* stream;

  template <typename M>
  int run() {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Args<T> a = make_args<T, M>(in, st, out, N, B, nc, flags, multiprocessors());
    if constexpr (PRICE) {
      if (!valid(a.price)) return static_cast<int>(cudaErrorInvalidValue);
      const cudaError_t allowed = allow(price_kernel<T, M>, a.price.bytes);
      if (allowed != cudaSuccess) return static_cast<int>(allowed);
      price_kernel<T, M><<<a.price.blocks, a.price.threads, a.price.bytes, s>>>(a);
    } else {
      if (!valid(a.roll)) return static_cast<int>(cudaErrorInvalidValue);
      rollout_kernel<T, M><<<a.roll.blocks, a.roll.threads, a.roll.bytes, s>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, bool PRICE>
int launch(const void* const* in, const long long* st, void* const* out, int N, int B,
           int n_feet, int nc, int flags, void* stream) {
  if (N < 1 || B < 1 || nc < 0 || n_feet < 1 || n_feet > 4 ||
      (PRICE ? out[OUT_J] == nullptr && out[OUT_LAM] == nullptr : out[OUT_XS] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch<T, PRICE> fn{in, st, out, N, B, nc, flags, stream};
  const int err = with_model<AsTorch>(flags >> MODEL_SHIFT, n_feet, fn);
  return err < 0 ? static_cast<int>(cudaErrorInvalidValue) : err;
}

}  // namespace

#define K9_ENTRY(name, T, PRICE)                                                            \
  extern "C" int name(const void* const* in, const long long* st, void* const* out, int N, \
                      int B, int n_feet, int nc, int flags, void* stream) {                \
    return launch<T, PRICE>(in, st, out, N, B, n_feet, nc, flags, stream);                 \
  }
K9_ENTRY(rollout_f32, float, false)
K9_ENTRY(rollout_f64, double, false)
K9_ENTRY(price_f32, float, true)
K9_ENTRY(price_f64, double, true)
#undef K9_ENTRY

#ifdef K9_PLAN_OVERRIDE
// The rollout's (S, threads) of the following launches (0: the policy's).
extern "C" void rollout_override(int S, int threads) {
  roll_plan_override[0] = S;
  roll_plan_override[1] = threads;
}
// The pricing's (S, rows) and the multiplier update's knots a block of the
// following launches (0: the policy's).
extern "C" void price_override(int S, int rows, int knots) {
  price_plan_override[0] = S;
  price_plan_override[1] = rows;
  price_plan_override[2] = knots;
}
#endif

#ifdef K9_PHASE_CLOCKS
// The block whose thread 0 stamps in the launches after it; every stamp set
// to 0.
extern "C" int rollout_clock_block(int block) {
  static const long long zeros[CLOCK_SLOTS] = {};
  cudaError_t err = cudaMemcpyToSymbol(phase_clocks, zeros, sizeof(zeros));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(clock_block, &block, sizeof(int));
  return static_cast<int>(err);
}
// The first n stamps since (CLOCK_SLOTS at most), to host memory
// (synchronises).
extern "C" int rollout_clocks(long long* out, int n) {
  if (n > CLOCK_SLOTS) n = CLOCK_SLOTS;
  return static_cast<int>(cudaMemcpyFromSymbol(out, phase_clocks, sizeof(long long) * n));
}
#endif

#endif  // __CUDACC__
