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
// references and Cu, and writes J and λ̄). The rollout is a serial chain of N
// steps a scenario, so its time is that chain's latency below many waves.
//
// Design (a simple kernel, right first):
// - rollout: a thread a scenario keeps x in registers over the N knots and
//   the model's constants (M::load, once) in a local array whose indices
//   are all known when it compiles; it reads us[k] and writes each row of
//   xs[k+1] coalesced along the batch-last axis (neighbouring threads,
//   neighbouring scenarios);
// - price: a block of PRICE_LANES scenarios x PRICE_KNOTS knot rows; thread
//   (lane, row) takes its lane's scenario at the knots row, row +
//   PRICE_KNOTS, ... <= N: a stage knot's cost and λ̄, or the terminal's, the
//   costs to shared memory; after a barrier the first row sums each
//   scenario's knots into J.
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
// that the wrapper checks them.
//
// The device code also compiles as plain C++ (no __CUDACC__) against
// tests/cuda_emulation.h; tests/test_torch_line_search_emulation.py holds it
// against the plain version that way.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#include <cmath>
#endif

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

// A rollout's block: scenarios, a thread each. A pricing's block: PRICE_LANES
// scenarios (a warp's lanes, so that its loads of a batch-last row are
// coalesced) x PRICE_KNOTS knot rows.
constexpr int ROLL_THREADS = 64;
constexpr int PRICE_LANES = 32, PRICE_KNOTS = 8, PRICE_THREADS = PRICE_LANES * PRICE_KNOTS;

template <typename T>
struct Args {
  In<T> in[INPUTS];
  T* xs;       // (N+1, nx, B) or null
  T* J;        // (B) or null
  T* lam_bar;  // (N, nc, B) or null
  int N, B, nc, flags;
};

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

template <typename T>
__device__ __forceinline__ T k_fabs(T x) {
#ifdef __CUDACC__
  return fabs(x);
#else
  return std::fabs(x);
#endif
}

// Σ Qd·(x − x_ref)² over the state's rows (solver/fleet.stage_cost_terms and
// total_cost's terminal term), in the plain version's operations.
template <typename M, typename T>
__device__ __forceinline__ T state_sum(const T* x, const Col<T>& x_ref, const Col<T>& Qd) {
  return torch_sum<T>(M::NX, [&](int i) {
    const T d = x[i] - x_ref[i];
    return Qd[i] * d * d;
  });
}

// The geodesic term w·(1 − |q·q_ref|) of a state holding a quaternion q at
// M::QI.
template <typename M, typename T>
__device__ __forceinline__ T geodesic(const T* x, const Col<T>& x_ref, T w) {
  const T dot = torch_sum<T>(4, [&](int i) { return x[M::QI + i] * x_ref[M::QI + i]; });
  return w * (T(1) - k_fabs(dot));
}

template <typename T, typename M>
__global__ void __launch_bounds__(ROLL_THREADS) rollout_kernel(const Args<T> a) {
  constexpr int NX = M::NX, NU = M::NU;
  const long long B = a.B;
  const long long b = static_cast<long long>(blockIdx.x) * ROLL_THREADS + threadIdx.x;
  if (b >= B) return;
  T constants[M::VALUES];
  M::load(a.in + IN_FOOT, b, constants);
  const Sm<T> model{constants};
  const T h = column(a.in[IN_H], b)[0];
  const Col<T> x0 = column(a.in[IN_XS], b), us = column(a.in[IN_US], b);
  T* xs = a.xs + b;
  T x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x[i] = x0[i];
    xs[i * B] = x[i];
  }
#pragma unroll 1
  for (int k = 0; k < a.N; ++k) {
    T u[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = us[static_cast<long long>(k) * NU + i];
    M::step(x, u, model, h);
    T* row = xs + static_cast<long long>(k + 1) * NX * B;
#pragma unroll
    for (int i = 0; i < NX; ++i) row[i * B] = x[i];
  }
}

template <typename T, typename M>
__global__ void __launch_bounds__(PRICE_THREADS) price_kernel(const Args<T> a) {
  constexpr int NX = M::NX, NU = M::NU;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* costs = reinterpret_cast<T*>(smem_raw);  // (N+1) x PRICE_LANES: each knot's cost
  const long long B = a.B;
  const int N = a.N, nc = a.nc, lane = threadIdx.x % PRICE_LANES, row = threadIdx.x / PRICE_LANES;
  const long long b = static_cast<long long>(blockIdx.x) * PRICE_LANES + lane;
  const bool priced = a.J != nullptr;
  if (b < B) {
    const bool w_per_knot = a.flags & FLAG_W_PER_KNOT, cb_per_knot = a.flags & FLAG_CB_PER_KNOT;
    const Col<T> xs = column(a.in[IN_XS], b), x_ref = column(a.in[IN_X_REF], b),
                 w = column(a.in[IN_W], b);
    for (int j = row; j <= N; j += PRICE_KNOTS) {
      const long long jl = j;
      T x[NX];
      if (priced) {
#pragma unroll
        for (int i = 0; i < NX; ++i) x[i] = xs[jl * NX + i];
      }
      const Col<T> x_ref_j = x_ref.at(jl * NX);
      const T w_j = w[w_per_knot ? jl : 0];
      if (j == N) {  // the terminal cost
        if (priced) {
          T term = T(0.5) * state_sum<M>(x, x_ref_j, column(a.in[IN_QDF], b));
          if constexpr (M::QI >= 0) term = term + geodesic<M>(x, x_ref_j, w_j);
          costs[N * PRICE_LANES + lane] = term;
        }
        continue;
      }
      const Col<T> us = column(a.in[IN_US], b), Cu = column(a.in[IN_CU], b),
                   cb = column(a.in[IN_CB], b).at(cb_per_knot ? jl * nc : 0),
                   lam = column(a.in[IN_LAM], b).at(jl * nc);
      const bool has_lam = a.in[IN_LAM].p != nullptr;
      const T rho = column(a.in[IN_RHO], b)[0];
      T u[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) u[i] = us[jl * NU + i];
      // the inequality's rows: c = Cu·u + cb, λ̄ = max(λ + ρ·c, 0) (a NaN
      // kept, as torch.clamp), and the sums of λ̄² and λ² over the rows
      T bars[4] = {T(0), T(0), T(0), T(0)}, lams[4] = {T(0), T(0), T(0), T(0)};
      for (int r0 = 0; r0 < nc; r0 += 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // row r into accumulator q = r mod 4, as torch_sum
          const int r = r0 + q;
          if (r >= nc) break;
          const T c = torch_sum<T>(NU, [&](int i) { return Cu[r * NU + i] * u[i]; }) + cb[r];
          const T l = has_lam ? lam[r] : T(0);
          T z = l + rho * c;
          z = z < T(0) ? T(0) : z;
          if (a.lam_bar != nullptr) a.lam_bar[(jl * nc + r) * B + b] = z;
          bars[q] = bars[q] + z * z;
          lams[q] = lams[q] + l * l;
        }
      }
      if (!priced) continue;
      // stage_cost_terms: the state's sum, the input's, then the geodesic term
      const Col<T> u_ref = column(a.in[IN_U_REF], b).at(jl * NU), Rd = column(a.in[IN_RD], b);
      T val = T(0.5) * state_sum<M>(x, x_ref_j, column(a.in[IN_QD], b));
      val = val + T(0.5) * torch_sum<T>(NU, [&](int i) {
              const T d = u[i] - u_ref[i];
              return Rd[i] * d * d;
            });
      if constexpr (M::QI >= 0) val = val + geodesic<M>(x, x_ref_j, w_j);
      // + al_value: (Σ λ̄² − Σ λ²) / (2ρ)
      const T s_bar = ((bars[0] + bars[1]) + bars[2]) + bars[3];
      const T s_lam = ((lams[0] + lams[1]) + lams[2]) + lams[3];
      costs[j * PRICE_LANES + lane] = val + (s_bar - s_lam) / (T(2) * rho);
    }
  }
  if (!priced) return;  // every thread of the launch alike
  __syncthreads();
  if (row == 0 && b < B) {
    const T* mine = costs + lane;
    a.J[b] = torch_sum<T>(N, [&](int j) { return mine[j * PRICE_LANES]; }) +
             mine[N * PRICE_LANES];
  }
}

// The kernel's arguments from the wrapper's tables.
template <typename T>
Args<T> make_args(const void* const* in, const long long* st, void* const* out, int N, int B,
                  int nc, int flags) {
  Args<T> a;
  for (int i = 0; i < INPUTS; ++i)
    a.in[i] = In<T>{static_cast<const T*>(in[i]), st[2 * i], st[2 * i + 1]};
  a.xs = static_cast<T*>(out[OUT_XS]);
  a.J = static_cast<T*>(out[OUT_J]);
  a.lam_bar = static_cast<T*>(out[OUT_LAM]);
  a.N = N, a.B = B, a.nc = nc, a.flags = flags;
  return a;
}

// A pricing's dynamic shared memory: each knot's cost of the block's scenarios.
template <typename T>
size_t price_bytes(int N) {
  return static_cast<size_t>(N + 1) * PRICE_LANES * sizeof(T);
}

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

#ifdef __CUDACC__  // the host side: the launches and the C interface

namespace {

// One launch of model M's rollout or pricing (with_model's fn).
template <typename T, bool PRICE>
struct Launch {
  Args<T> a;
  void* stream;

  template <typename M>
  int run() {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if constexpr (PRICE) {
      const size_t bytes = price_bytes<T>(a.N);
      if (bytes > (48 << 10)) {
        const cudaError_t allowed = cudaFuncSetAttribute(
            price_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes));
        if (allowed != cudaSuccess) return static_cast<int>(allowed);
      }
      const int blocks = static_cast<int>((static_cast<long long>(a.B) + PRICE_LANES - 1) /
                                          PRICE_LANES);
      price_kernel<T, M><<<blocks, PRICE_THREADS, bytes, s>>>(a);
    } else {
      const int blocks = static_cast<int>((static_cast<long long>(a.B) + ROLL_THREADS - 1) /
                                          ROLL_THREADS);
      rollout_kernel<T, M><<<blocks, ROLL_THREADS, 0, s>>>(a);
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
  Launch<T, PRICE> fn{make_args<T>(in, st, out, N, B, nc, flags), stream};
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

#endif  // __CUDACC__
