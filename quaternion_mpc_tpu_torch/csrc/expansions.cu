// K8 — the knot expansions of the quaternion SRB's backward pass: every
// stage knot's error-state discrete Jacobians and AL cost expansion, and the
// terminal cost expansion, of every scenario in one launch an iLQR iteration.
//
// Replaces the region XLA fused for the JAX package at
// quaternion_mpc_tpu/solver/fleet.py:642 (`knot_expansions`, a jax.vmap over
// the knots of error_discrete_jac :491 with the structured quat_srb_error_
// discrete_jac_fleet, models/srb.py:350-473, and cost_expansion :471 with
// _state_expansion_structured :411) and terminal_expansion :484. There is no
// Pallas kernel for it: experiments/pallas_fleet.py:212 computes the
// expansions outside its kernel too. Eager PyTorch runs it
// (solver/fleet.knot_expansions_with_cross and terminal_expansion, the plain
// version) as ~360 launches an iteration.
//
// What it computes, for knot k < N of scenario b, with x = xs[k], x1 = xs[k+1],
// u = us[k] (x = [p 3, q 4 (w first), v 3, ω 3], u the feet's body-frame
// forces, 3 a foot):
// - the blocks of models/srb.py SrbEdjBlocks under the midpoint rule: the
//   moment Σ rᵢ×fᵢ + c×(m_c·g_body) (g_body from the frozen rotation's third
//   row, no gyroscopic term), ω̇ = I⁻¹·moment (the adjugate inverse), q̇ =
//   ½G(q)ω, q_m = q + ½h·q̇, ω_m = ω + ½h·ω̇; D_qq = I₄ + h·½R(ω_m) +
//   ½h²·½R(ω_m)·½R(ω), D_qω = h·½G(q_m) + ½h²·½R(ω_m)·½G(q); A_phi =
//   G(q1)ᵀ·D_qq·G(q), A_pw = G(q1)ᵀ·D_qω, Bw = [I⁻¹·skew(rᵢ) …] and B_phi =
//   G(q1)ᵀ·(½h²·½G(q_m)·Bw), written dense:
//     As = [[I, 0, h·I, 0], [0, A_phi, 0, A_pw], [0, 0, I, 0], [0, 0, 0, I]]
//     Bs = [[½h²/m·(I…I)], [B_phi], [h/m·(I…I)], [h·Bw]];
// - the state cost's expansion (solver/fleet._state_expansion_structured):
//   g = Qd·(x − x_ref), the geodesic term's gradient −w·sign(q·q_ref)·q_ref
//   on g's quaternion rows (sign(0) = 0), corr = −q·g_q; lx = [g_p, G(q)ᵀg_q,
//   g_v, g_ω] and lxx = diag(Qd_p) ⊕ (G(q)ᵀdiag(Qd_q)G(q) + corr·I₃) ⊕
//   diag(Qd_v, Qd_ω);
// - the input cost and the AL terms of Cu·u + cb ≤ 0: c = Cu·u + cb, a row
//   active where λ + ρc >= 0 (ties included), λ̄ = max(λ + ρc, 0);
//   lu = Rd·(u − u_ref) + Cuᵀλ̄ and luu = diag(Rd) + ρ·Cuᵀ·diag(active)·Cu;
// and at k = N the terminal lxN, lxxN: the state cost's expansion with Qdf
// and the last knot's w.
// Every value is computed by the operations of the plain version as PyTorch
// runs them on the card, each rounded alike
// (-fmad=false, kernels/expansions.FLAGS, and explicit fused multiply-adds
// where PyTorch's own kernels have them): a sum of up to four terms in index
// order, a longer one (Cu·u, Cuᵀλ̄, Cuᵀ·diag(active)·Cu) in PyTorch's order
// over a dimension of stride > 1 (`sum4`), the moment's cross products as
// torch.linalg.cross's fused terms (`fused`). So on the card K8's outputs
// equal the plain version's bit for bit wherever B > 1 (chip_smoke.py holds
// them so); at B = 1 PyTorch reduces the rows of a sum that lie next to each
// other in memory by another scheme, and the last bits may differ.
//
// What bounds it on an H100: bytes. A stage knot writes 12·12 + 12·nu + 12
// + 12·12 + nu + nu² values (600 at nu = 12: the dense slabs K1 and K4 read,
// zeros included) and reads ~80; the operations (10,258 a knot at nu = 12
// and 24 inequality rows, 7,488 of them ρ·Cuᵀ·diag(active)·Cu) take less
// time at the card's peak (kernels/expansions.work).
//
// Design: a knot's work split over the warps of a block. A block takes one
// knot index k < N and TILE = 32 consecutive scenarios, lane ℓ of every warp
// the scenario tile·32 + ℓ, so that each store of a warp is one 128-byte
// row (256 in f64) of neighbouring scenarios. First the whole block stages
// into shared memory the leaves every scenario shares (batch stride 0: cb's
// row of the knot, Rd, Qd, Qdf, w's value of the knot, the model's
// parameters; each thread loads its elements before it stores any). A
// barrier, then the knot's pieces, a warp each, each loading its own
// operands:
//   P_AS    the dynamics to As: the moment, ω_m, D_qq·G, A_phi, A_pw;
//   P_BS    the dynamics to Bs: q_m, Bw, B_phi (no moment); it computes the
//           inverse inertia, ½h, ½h², q_m and ½G(q_m) again
//           (kernels/expansions.RECOMPUTED_FLOPS, not counted by `work`);
//   P_STATE the state cost to lx, lxx;
//   P_ROWS.. the AL rows, dealt over the remaining warps. These first copy
//           the tile's Cu (shared or per scenario: each of its rows is read
//           by several warps, then at a stride the compiler knows) to shared
//           memory, a row of 32 scenarios at a time, by cp.async, and wait
//           at a barrier of their own while the other pieces go on; then
//           c = Cu·u + cb and λ̄ = max(λ + ρc, 0) to shared memory, and which
//           rows are active (each warp's rows as the bits of a word).
// A second barrier, then the sums over the rows in four passes: luu's rows
// and Cuᵀλ̄ (lu's, a row whose coefficient is λ̄ in place of Cu[r, i]·active)
// are NU + 1 rows of the same shape, dealt over every warp of the block (the
// AL rows' warps first, then P_STATE's, P_BS's and P_AS's, which have more
// to do before the barrier). A thread takes the passes m and the rows r ≡ m
// (mod 4) as the outer loops and its own rows as the inner one, so that it
// loads each row of Cu once. Blocks past the N·tiles stage blocks hold the
// terminal knot only, a tile a warp. Lanes past the last scenario compute
// nothing and reach both barriers. At B = 1 the pieces run side by side, so
// the serial chain is a piece, not the whole knot.
//
// Layout: an input is read through a row stride and a batch stride (In,
// below): batch-last leaves have row stride B (or 1) and batch stride 1 (or
// 0: a value every scenario shares); the batch-first model parameters
// (params_to_fleet's movedim) are read in place, row stride 1 and batch
// stride their row count. The wrapper (kernels/expansions.py) hands a table
// of input pointers and a table of (row stride, batch stride) pairs in the
// order of enum Input below, and a table of output pointers in the order of
// enum Output (each batch-last and contiguous).
//
// C interface (bound with ctypes): expansions_f32 / _f64 take the input
// table, its strides, the output table, N, B, n_feet (1-4), nc (at most
// MAX_ROWS) and flags (FLAG_*), and a cudaStream_t; they launch on that
// stream and return the CUDA error of the launch. expansions_table(out)
// writes the tables' sizes, so that the wrapper checks them.
//
// Build option: -DK8_PHASE_CLOCKS makes lane 0 of every warp of one block
// stamp clock64() at the ends of its piece's parts, read back by
// expansions_clocks (k1_phase_clocks.py k8).
//
// The device code also compiles as plain C++ (no __CUDACC__) against
// tests/cuda_emulation.h; tests/test_torch_expansions_emulation.py holds it
// against the plain version that way.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include <cstdint>
#ifndef __CUDACC__
#include <cmath>
#endif

#include "batch_last.cuh"

// Marks the operations that a piece computes again (the emulation's counting
// number type counts them apart); nothing on the card.
#ifndef K8_RECOMPUTE
#define K8_RECOMPUTE(on)
#endif

namespace {

// the inputs, in the order of the wrapper's table
enum Input {
  IN_XS, IN_US,               // xs (N+1, 13), us (N, nu): batch extent B
  IN_X_REF, IN_U_REF,         // (N+1, 13), (N+1, nu)
  IN_QD, IN_QDF, IN_RD, IN_W,  // (13), (13), (nu), w (1) or per knot (N+1)
  IN_CU, IN_CB, IN_LAM,        // (nc, nu), cb (nc) or per knot (N+1, nc), λ (N, nc)
  // the model's parameters: (n_feet, 3), (3, 3), (1), (3), (1), (3, 3)
  IN_FOOT, IN_INERTIA, IN_MASS, IN_COM_OFFSET, IN_COM_MASS, IN_ROT,
  IN_H, IN_RHO,                // one value a scenario, shared or not
  INPUTS
};
// the outputs: As (N, 12, 12), Bs (N, 12, nu), lxs (N, 12), lxxs (N, 12, 12),
// lus (N, nu), luus (N, nu, nu), lxN (12), lxxN (12, 12), each with batch axis B
enum Output { AS, BS, LXS, LXXS, LUS, LUUS, LXN, LXXN, OUTPUTS };
// flags: w or cb per knot
constexpr int FLAG_W_PER_KNOT = 1, FLAG_CB_PER_KNOT = 2;
constexpr int NX = 13, NE = 12;
constexpr int MAX_ROWS = 64;  // the bits of the word that holds which rows are active
constexpr int MAX_FEET = 4, MAX_NU = 3 * MAX_FEET;
constexpr int TILE = 32;      // scenarios a block: one a lane

// the warps of a stage block, in order; from P_ROWS on, the AL rows'
enum Piece { P_AS, P_BS, P_STATE, P_ROWS };

// A block's shape at NF feet, as measured on an H100 (PERF.md): its
// warps (f32 6, f64 8), the blocks an SM that __launch_bounds__ asks for (f32
// 3: at 4 it spilled, and 7 warps at 4 ran slower; f64 2, and only at four
// feet, the fleet's: at 128 registers a thread the three- or two-foot
// instantiation spilled 8 bytes), and the rows of Cu a sums loop takes a turn
// (f64 2; in f32 a second row spilled).
template <typename T, int NF>
struct Shape {
  static constexpr int NU = 3 * NF;
  static constexpr int WARPS = sizeof(T) == 4 ? 6 : 8;
  static constexpr int ROW_WARPS = WARPS - P_ROWS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 3 : NF == MAX_FEET ? 2 : 1;
  static constexpr int SUM_UNROLL = sizeof(T) == 4 ? 1 : 2;
};

// The sums after the second barrier: NU + 1 rows, luu's i < NU and lu's
// (Cuᵀλ̄) NU; row t goes to the warp at place t mod WARPS, the places being
// the AL rows' warps, then P_STATE, P_BS, P_AS. Warp W takes the rows
// PLACE, PLACE + WARPS, ...: R of them, the last one lu's where HAS_LU.
template <typename T, int NF, int W>
struct Sums {
  using S = Shape<T, NF>;
  static constexpr int NU = S::NU;
  static constexpr int PLACE = W >= P_ROWS ? W - P_ROWS : S::WARPS - 1 - W;
  static constexpr int R = PLACE <= NU ? (NU - PLACE) / S::WARPS + 1 : 0;
  static constexpr bool HAS_LU = R > 0 && (NU - PLACE) % S::WARPS == 0;
  static constexpr int LUU = HAS_LU ? R - 1 : R;  // rows of luu
};

// Shared memory: the staged shared leaves (offsets in values), then (Args'
// offsets in bytes) the AL-row warps' words of active rows, λ̄, and the
// tile's Cu.
constexpr int SM_CB = 0, SM_RD = SM_CB + MAX_ROWS,
              SM_QD = SM_RD + MAX_NU, SM_QDF = SM_QD + NX, SM_W = SM_QDF + NX,
              SM_FOOT = SM_W + 1, SM_INERTIA = SM_FOOT + MAX_NU, SM_MASS = SM_INERTIA + 9,
              SM_COM = SM_MASS + 1, SM_COM_MASS = SM_COM + 3, SM_ROT = SM_COM_MASS + 1,
              SM_VALUES = SM_ROT + 9;

#ifdef K8_PHASE_CLOCKS
constexpr int CLOCK_SLOTS = 8, CLOCK_WARPS = 32;
__device__ long long phase_clocks[CLOCK_WARPS * CLOCK_SLOTS];
__device__ int clock_block = -1;  // the block whose warps stamp (lane 0 of each)
#define K8_STAMP(slot)                                                                  \
  do {                                                                                  \
    if (static_cast<int>(blockIdx.x) == clock_block && (threadIdx.x & 31) == 0)         \
      phase_clocks[(threadIdx.x >> 5) * CLOCK_SLOTS + (slot)] = clock64();              \
  } while (0)
#else
#define K8_STAMP(slot)
#endif

// An input: its values, the step between its rows and the step between
// scenarios (0 where every scenario shares them).
template <typename T>
struct In {
  const T* p;
  long long rs, bs;
};

template <typename T>
__device__ __forceinline__ Col<T> column(const In<T>& v, long long b) {
  return Col<T>{v.p + b * v.bs, v.rs};
}

// One scenario's rows of an output slab: row i at p[i * B]. The slabs are
// stored evict-first: they are written once and read once, by the next
// kernel.
template <typename T>
struct Slab {
  T* p;
  long long B;
  __device__ __forceinline__ void put(int i, T v) const {
#ifdef __CUDACC__
    __stcs(p + i * B, v);
#else
    p[i * B] = v;
#endif
  }
};

template <typename T>
struct Args {
  In<T> in[INPUTS];
  T* out[OUTPUTS];
  int N, B, nc, flags, tiles;  // tiles: the blocks of TILE scenarios a stage knot takes
  // shared memory, in bytes: where the words of active rows, λ̄ and the
  // tile's Cu start, and its size
  int words_at, lam_at, cu_at, smem;
};

// Input i of scenario b from row `at` on: its staged copy in shared memory
// (at sm + off, already from that row) where every scenario shares it.
template <typename T>
__device__ __forceinline__ Col<T> leaf(const Args<T>& a, const T* sm, int i, int off, long long b,
                                       long long at = 0) {
  return a.in[i].bs == 0 ? Col<T>{sm + off, 1} : column(a.in[i], b).at(at);
}

// Where element e of the staged shared leaves comes from (knot k, NU
// inputs), or null where its leaf is per scenario or shorter.
template <typename T, int NU>
__device__ __forceinline__ const T* staged_from(const Args<T>& a, int k, int e) {
  int i, at, n;
  long long first = 0;
  if (e < SM_RD) {
    i = IN_CB, at = SM_CB, n = a.nc;
    if (a.flags & FLAG_CB_PER_KNOT) first = static_cast<long long>(k) * a.nc;
  } else if (e < SM_QD) {
    i = IN_RD, at = SM_RD, n = NU;
  } else if (e < SM_QDF) {
    i = IN_QD, at = SM_QD, n = NX;
  } else if (e < SM_W) {
    i = IN_QDF, at = SM_QDF, n = NX;
  } else if (e < SM_FOOT) {
    i = IN_W, at = SM_W, n = 1;
    if (a.flags & FLAG_W_PER_KNOT) first = k;
  } else if (e < SM_INERTIA) {
    i = IN_FOOT, at = SM_FOOT, n = NU;
  } else if (e < SM_MASS) {
    i = IN_INERTIA, at = SM_INERTIA, n = 9;
  } else if (e < SM_COM) {
    i = IN_MASS, at = SM_MASS, n = 1;
  } else if (e < SM_COM_MASS) {
    i = IN_COM_OFFSET, at = SM_COM, n = 3;
  } else if (e < SM_ROT) {
    i = IN_COM_MASS, at = SM_COM_MASS, n = 1;
  } else {
    i = IN_ROT, at = SM_ROT, n = 9;
  }
  const In<T>& v = a.in[i];
  return v.bs == 0 && e - at < n ? v.p + (first + e - at) * v.rs : nullptr;
}

// The leaves every scenario shares, of knot k, to shared memory at sm, by
// the whole block; each thread loads its elements before it stores them.
template <typename T, int NF>
__device__ void stage_leaves(const Args<T>& a, T* sm, int k) {
  constexpr int NU = 3 * NF, THREADS = Shape<T, NF>::THREADS;
  constexpr int Q = (SM_VALUES + THREADS - 1) / THREADS;
  const int t = static_cast<int>(threadIdx.x);
  const T* from[Q];
  T v[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int e = t + q * THREADS;
    from[q] = e < SM_VALUES ? staged_from<T, NU>(a, k, e) : nullptr;
    if (from[q]) v[q] = *from[q];
  }
#pragma unroll
  for (int q = 0; q < Q; ++q)
    if (from[q]) sm[t + q * THREADS] = v[q];
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

// The AL rows' warps (thread t of `threads`) copy the tile's Cu to cu,
// element e (row e / TILE, lane e mod TILE) at cu[e], and wait at a barrier
// of their own until every copy has landed; the other warps go on.
template <typename T, int NF>
__device__ void copy_cu(const Args<T>& a, T* cu, long long b0, int t, int threads) {
  constexpr int NU = 3 * NF;
  const In<T>& C = a.in[IN_CU];
  const int n = a.nc * NU * TILE;
  for (int e = t; e < n; e += threads) {
    const long long b = b0 + (e & (TILE - 1));
    if (b < a.B) cp_async(cu + e, C.p + static_cast<long long>(e / TILE) * C.rs + b * C.bs);
  }
#ifdef __CUDACC__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
#else
  __named_sync(1, threads);
#endif
}

// G(q) = [[−x, −y, −z], [w, −z, y], [z, w, −x], [−y, x, w]] (models/srb._quat_G_bl)
template <typename T>
__device__ __forceinline__ void quat_G(const T* q, T G[4][3]) {
  G[0][0] = -q[1], G[0][1] = -q[2], G[0][2] = -q[3];
  G[1][0] = q[0], G[1][1] = -q[3], G[1][2] = q[2];
  G[2][0] = q[3], G[2][1] = q[0], G[2][2] = -q[1];
  G[3][0] = -q[2], G[3][1] = q[1], G[3][2] = q[0];
}

// a·b + c rounded once. PyTorch's CUDA cross product (torch.linalg.cross, the
// plain version's moment) computes each term a_j·b_k − a_k·b_j as
// fma(a_j, b_k, −(a_k·b_j)), so the moment's terms are written so
// (chip_smoke.py holds the outputs equal to the plain version's).
template <typename T>
__device__ __forceinline__ T fused(T a, T b, T c) {
#ifdef __CUDACC__
  if constexpr (sizeof(T) == 4)
    return __fmaf_rn(a, b, c);
  else
    return __fma_rn(a, b, c);
#else
  return std::fma(a, b, c);
#endif
}

// Σ p[j], j < N, in the order of PyTorch's CUDA reduction over a dimension of
// stride > 1 (the plain version's sums at a batch of B > 1): term j into
// accumulator j mod 4, each in index order, then the accumulators added in
// order; at N <= 4 the index order.
template <typename T, int N>
__device__ __forceinline__ T sum4(const T* p) {
  T acc[4];
#pragma unroll
  for (int i = 0; i < 4 && i < N; ++i) {
    acc[i] = p[i];
#pragma unroll
    for (int j = i + 4; j < N; j += 4) acc[i] = acc[i] + p[j];
  }
  T s = acc[0];
#pragma unroll
  for (int i = 1; i < 4 && i < N; ++i) s = s + acc[i];
  return s;
}

// ½·R([0, ω]), the right-multiplication matrix of a pure-vector quaternion
// (models/srb._half_Rw): ½ times [[0, −ωx, −ωy, −ωz], [ωx, 0, ωz, −ωy],
// [ωy, −ωz, 0, ωx], [ωz, ωy, −ωx, 0]].
template <typename T>
__device__ __forceinline__ void half_Rw(const T* w, T R[4][4]) {
  const T h = T(0.5), z = T(0);  // ½·0 is 0
  R[0][0] = z, R[0][1] = h * -w[0], R[0][2] = h * -w[1], R[0][3] = h * -w[2];
  R[1][0] = h * w[0], R[1][1] = z, R[1][2] = h * w[2], R[1][3] = h * -w[1];
  R[2][0] = h * w[1], R[2][1] = h * -w[2], R[2][2] = z, R[2][3] = h * w[0];
  R[3][0] = h * w[2], R[3][1] = h * w[1], R[3][2] = h * -w[0], R[3][3] = z;
}

// lx (12) and lxx (12 x 12) of ½Σ Qd·(x − x_ref)² + w·(1 − |q·q_ref|) at x
// (solver/fleet._state_expansion_structured), written to lx and lxx.
template <typename T>
__device__ void state_expansion(const T* x, const Col<T>& x_ref, const Col<T>& Qd, T w,
                                const Slab<T>& lx, const Slab<T>& lxx) {
  T g[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) g[i] = Qd[i] * (x[i] - x_ref[i]);
  const T* q = x + 3;
  const T r[4] = {x_ref[3], x_ref[4], x_ref[5], x_ref[6]};
  const T dot = ((q[0] * r[0] + q[1] * r[1]) + q[2] * r[2]) + q[3] * r[3];
  const T s = dot > T(0) ? T(1) : dot < T(0) ? T(-1) : T(0);  // sign(0) = 0
  const T ws = w * s;
  T gq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) gq[i] = g[3 + i] - ws * r[i];
  const T corr = -(((q[0] * gq[0] + q[1] * gq[1]) + q[2] * gq[2]) + q[3] * gq[3]);
  T G[4][3];
  quat_G(q, G);
  K8_STAMP(2);
#pragma unroll
  for (int i = 0; i < 3; ++i) lx.put(i, g[i]);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    lx.put(3 + j, ((G[0][j] * gq[0] + G[1][j] * gq[1]) + G[2][j] * gq[2]) + G[3][j] * gq[3]);
#pragma unroll
  for (int i = 6; i < NE; ++i) lx.put(i, g[i + 1]);
  // the attitude block Gᵀ·diag(Qd_q)·G + corr·I₃, the rest diagonal
  T GQ[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c) GQ[i][c] = Qd[3 + i] * G[i][c];
#pragma unroll
  for (int i = 0; i < NE; ++i)
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      T v = T(0);
      if (i >= 3 && i < 6 && j >= 3 && j < 6) {
        const int a = i - 3, c = j - 3;
        v = ((G[0][a] * GQ[0][c] + G[1][a] * GQ[1][c]) + G[2][a] * GQ[2][c]) + G[3][a] * GQ[3][c];
        if (a == c) v = v + corr;
      } else if (i == j) {
        v = Qd[i < 3 ? i : i + 1];
      }
      lxx.put(NE * i + j, v);
    }
}

// x's quaternion and ω at knot k of scenario xs
template <typename T>
__device__ __forceinline__ void load_q_w(const Col<T>& xs, int k, T q[4], T w[3]) {
  const long long at = static_cast<long long>(k) * NX;
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = xs[at + 3 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = xs[at + 10 + i];
}

// q_m = q + ½h·(½G(q)ω), from G0 = G(q)
template <typename T>
__device__ __forceinline__ void midpoint_q(const T q[4], const T w[3], const T G0[4][3], T half_h,
                                           T q_m[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)  // q̇ = ½G(q)ω
    q_m[i] = q[i] + half_h * (T(0.5) * ((G0[i][0] * w[0] + G0[i][1] * w[1]) + G0[i][2] * w[2]));
}

// Piece P_AS of stage knot k, scenario b: the dynamics to As.
template <typename T, int NF>
__device__ void dynamics_As(const Args<T>& a, const T* sm, int k, long long b) {
  constexpr int NU = 3 * NF;
  const long long B = a.B;
  const Col<T> xs = column(a.in[IN_XS], b), us = column(a.in[IN_US], b);
  T q[4], w[3];
  load_q_w(xs, k, q, w);
  const T h = column(a.in[IN_H], b)[0];
  const Col<T> foot = leaf(a, sm, IN_FOOT, SM_FOOT, b);
  T inv[9];
  inverse3(leaf(a, sm, IN_INERTIA, SM_INERTIA, b), inv);
  T moment[3];
#pragma unroll
  for (int f = 0; f < NF; ++f) {  // Σ rᵢ × fᵢ over the feet in order
    const T r0 = foot[3 * f], r1 = foot[3 * f + 1], r2 = foot[3 * f + 2];
    const long long at = static_cast<long long>(k) * NU + 3 * f;
    const T F[3] = {us[at], us[at + 1], us[at + 2]};
    const T t0 = fused(r1, F[2], -(r2 * F[1])), t1 = fused(r2, F[0], -(r0 * F[2])),
            t2 = fused(r0, F[1], -(r1 * F[0]));
    if (f == 0) {
      moment[0] = t0, moment[1] = t1, moment[2] = t2;
    } else {
      moment[0] = moment[0] + t0, moment[1] = moment[1] + t1, moment[2] = moment[2] + t2;
    }
  }
  {  // + c × (m_c·g_body), g_body = Rᵀ·g_world from the rotation's third row
    const Col<T> com = leaf(a, sm, IN_COM_OFFSET, SM_COM, b), rot = leaf(a, sm, IN_ROT, SM_ROT, b);
    const T com_mass = leaf(a, sm, IN_COM_MASS, SM_COM_MASS, b)[0];
    T mg[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) mg[c] = com_mass * (T(-GRAVITY) * rot[6 + c]);
    const T c0 = com[0], c1 = com[1], c2 = com[2];
    moment[0] = moment[0] + fused(c1, mg[2], -(c2 * mg[1]));
    moment[1] = moment[1] + fused(c2, mg[0], -(c0 * mg[2]));
    moment[2] = moment[2] + fused(c0, mg[1], -(c1 * mg[0]));
  }
  const T half_h = T(0.5) * h;
  const T hh = half_h * h;
  T G0[4][3], q_m[4], w_m[3];
  quat_G(q, G0);
  midpoint_q(q, w, G0, half_h, q_m);
#pragma unroll
  for (int r = 0; r < 3; ++r) {  // ω̇ = I⁻¹·moment
    const T w_dot =
        (inv[3 * r] * moment[0] + inv[3 * r + 1] * moment[1]) + inv[3 * r + 2] * moment[2];
    w_m[r] = w[r] + half_h * w_dot;
  }
  T Qq[4][4], Qq_m[4][4], G1[4][3], Qw[4][3], Qw_m[4][3];
  half_Rw(w, Qq);
  half_Rw(w_m, Qq_m);
  {
    T q1[4], Gm[4][3];
    const long long at = static_cast<long long>(k + 1) * NX;
#pragma unroll
    for (int i = 0; i < 4; ++i) q1[i] = xs[at + 3 + i];
    quat_G(q1, G1);
    quat_G(q_m, Gm);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) Qw[i][c] = T(0.5) * G0[i][c], Qw_m[i][c] = T(0.5) * Gm[i][c];
  }
  // D_qq·G(q) (4 x 3), A_phi = G1ᵀ·(D_qq·G0) and the rest of As but A_pw;
  // then D_qω (4 x 3) and A_pw = G1ᵀ·D_qω (Qw = ½G(q), Qw_m = ½G(q_m)), so
  // that D_qq·G(q) and D_qω are not held at once
  T DG[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T D[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const T mm = ((Qq_m[i][0] * Qq[0][j] + Qq_m[i][1] * Qq[1][j]) + Qq_m[i][2] * Qq[2][j]) +
                   Qq_m[i][3] * Qq[3][j];
      D[j] = ((i == j ? T(1) : T(0)) + h * Qq_m[i][j]) + hh * mm;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      DG[i][c] = ((D[0] * G0[0][c] + D[1] * G0[1][c]) + D[2] * G0[2][c]) + D[3] * G0[3][c];
  }
  K8_STAMP(2);
  const Slab<T> As{a.out[AS] + static_cast<long long>(k) * NE * NE * B + b, B};
#pragma unroll
  for (int r = 0; r < NE; ++r)
#pragma unroll
    for (int c = 0; c < NE; ++c) {
      T v;
      if (r >= 3 && r < 6 && c >= 3 && c < 6) {
        const int i = r - 3, j = c - 3;
        v = ((G1[0][i] * DG[0][j] + G1[1][i] * DG[1][j]) + G1[2][i] * DG[2][j]) +
            G1[3][i] * DG[3][j];
      } else if (r >= 3 && r < 6 && c >= 9) {
        continue;  // A_pw, below
      } else if (r < 3 && c == r + 6) {
        v = h;  // h·1
      } else {
        v = r == c ? T(1) : T(0);
      }
      As.put(NE * r + c, v);
    }
  T Dw[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T mm = ((Qq_m[i][0] * Qw[0][c] + Qq_m[i][1] * Qw[1][c]) + Qq_m[i][2] * Qw[2][c]) +
                   Qq_m[i][3] * Qw[3][c];
      Dw[i][c] = h * Qw_m[i][c] + hh * mm;
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      As.put(NE * (3 + i) + 9 + j, ((G1[0][i] * Dw[0][j] + G1[1][i] * Dw[1][j]) +
                                    G1[2][i] * Dw[2][j]) + G1[3][i] * Dw[3][j]);
}

// Piece P_BS of stage knot k, scenario b: the dynamics to Bs. The inverse
// inertia, ½h, ½h², q_m and ½G(q_m) are P_AS's values, computed again by
// the same operations.
template <typename T, int NF>
__device__ void dynamics_Bs(const Args<T>& a, const T* sm, int k, long long b) {
  constexpr int NU = 3 * NF;
  const long long B = a.B;
  const Col<T> xs = column(a.in[IN_XS], b);
  T q[4], w[3];
  load_q_w(xs, k, q, w);
  const T h = column(a.in[IN_H], b)[0];
  T inv[9], Qw_m[4][3];
  K8_RECOMPUTE(true);
  inverse3(leaf(a, sm, IN_INERTIA, SM_INERTIA, b), inv);
  const T half_h = T(0.5) * h;
  const T hh = half_h * h;
  {
    T G0[4][3], q_m[4], Gm[4][3];
    quat_G(q, G0);
    midpoint_q(q, w, G0, half_h, q_m);
    quat_G(q_m, Gm);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) Qw_m[i][c] = T(0.5) * Gm[i][c];
  }
  K8_RECOMPUTE(false);
  const T inv_m = T(1) / leaf(a, sm, IN_MASS, SM_MASS, b)[0];
  T G1[4][3];
  {
    T q1[4];
    const long long at = static_cast<long long>(k + 1) * NX;
#pragma unroll
    for (int i = 0; i < 4; ++i) q1[i] = xs[at + 3 + i];
    quat_G(q1, G1);
  }
  K8_STAMP(2);
  // Bs column by column (j = 3·foot + axis): the column of Bw = I⁻¹·skew(r),
  // then B_phi = G1ᵀ·(½h²·(½G(q_m)·Bw)) and the rows ½h²/m, h/m and h·Bw
  const Col<T> foot = leaf(a, sm, IN_FOOT, SM_FOOT, b);
  const Slab<T> Bs{a.out[BS] + static_cast<long long>(k) * NE * NU * B + b, B};
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const T r0 = foot[3 * f], r1 = foot[3 * f + 1], r2 = foot[3 * f + 2];
    const T S[3][3] = {{T(0), -r2, r1}, {r2, T(0), -r0}, {-r1, r0, T(0)}};  // skew(r)
#pragma unroll
    for (int axis = 0; axis < 3; ++axis) {
      const int j = 3 * f + axis;
      T Bw[3], QB[4];
#pragma unroll
      for (int m = 0; m < 3; ++m)
        Bw[m] = (inv[3 * m] * S[0][axis] + inv[3 * m + 1] * S[1][axis]) +
                inv[3 * m + 2] * S[2][axis];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        QB[i] = hh * ((Qw_m[i][0] * Bw[0] + Qw_m[i][1] * Bw[1]) + Qw_m[i][2] * Bw[2]);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const T v = r == axis ? inv_m : T(0);
        Bs.put(NU * r + j, hh * v);
        Bs.put(NU * (3 + r) + j,
               ((G1[0][r] * QB[0] + G1[1][r] * QB[1]) + G1[2][r] * QB[2]) + G1[3][r] * QB[3]);
        Bs.put(NU * (6 + r) + j, h * v);
        Bs.put(NU * (9 + r) + j, h * Bw[r]);
      }
    }
  }
}

// Piece P_STATE: the state cost's expansion of knot k (< N: Qd, to lx and
// lxx; N: Qdf, to lxN and lxxN) of scenario b.
template <typename T>
__device__ void state_cost(const Args<T>& a, const T* sm, int k, long long b) {
  const long long B = a.B, kk = k;
  const bool terminal = k == a.N;
  const Col<T> xs = column(a.in[IN_XS], b);
  T x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xs[kk * NX + i];
  const T w = leaf(a, sm, IN_W, SM_W, b, a.flags & FLAG_W_PER_KNOT ? kk : 0)[0];
  const Col<T> x_ref = column(a.in[IN_X_REF], b).at(kk * NX);
  if (terminal)
    state_expansion(x, x_ref, leaf(a, sm, IN_QDF, SM_QDF, b), w, Slab<T>{a.out[LXN] + b, B},
                    Slab<T>{a.out[LXXN] + b, B});
  else
    state_expansion(x, x_ref, leaf(a, sm, IN_QD, SM_QD, b), w,
                    Slab<T>{a.out[LXS] + kk * NE * B + b, B},
                    Slab<T>{a.out[LXXS] + kk * NE * NE * B + b, B});
}

// The AL rows of warp P_ROWS + w (rows w, w + ROW_WARPS, ...) of stage knot
// k, scenario b (Cu[r, j] at cu[(r·NU + j)·TILE]): c = Cu·u + cb and λ̄ =
// max(λ + ρc, 0), to lam_bar (row r at lam_bar[r·TILE]); returns the word of
// those rows that are active (bit r: row r).
template <typename T, int NF>
__device__ uint64_t al_rows(const Args<T>& a, const T* sm, const T* cu, T* lam_bar, int w, int k,
                            long long b) {
  constexpr int NU = 3 * NF, STEP = Shape<T, NF>::ROW_WARPS;
  const long long kk = k;
  const Col<T> us = column(a.in[IN_US], b);
  T u[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) u[j] = us[kk * NU + j];
  const T rho = column(a.in[IN_RHO], b)[0];
  const int nc = a.nc;
  const Col<T> cb = leaf(a, sm, IN_CB, SM_CB, b, a.flags & FLAG_CB_PER_KNOT ? kk * nc : 0),
               lam = column(a.in[IN_LAM], b).at(kk * nc);
  uint64_t active = 0;
  for (int r = w; r < nc; r += STEP) {
    const T* Cr = cu + r * NU * TILE;
    T p[NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) p[j] = Cr[j * TILE] * u[j];
    const T c = sum4<T, NU>(p) + cb[r];
    const T z = lam[r] + rho * c;
    lam_bar[r * TILE] = z < T(0) ? T(0) : z;
    if (z >= T(0)) active |= uint64_t(1) << r;
  }
  return active;
}

// One row r of Cu into warp W's sums (Sums): for each of its rows the term
// of column j, (Cu[r, i]·active_r)·Cu[r, j] for luu's row i and Cu[r, j]·λ̄_r
// (the plain version's order) for lu's, to acc (FIRST: the pass's first
// term) or added to it. Each element of Cu's row r is loaded once.
template <bool FIRST, typename T, int NF, int W, int R>
__device__ __forceinline__ void add_row(const T* cu, const T* lam_bar, uint64_t active, int r,
                                        T (&acc)[R][3 * NF]) {
  using M = Sums<T, NF, W>;
  constexpr int NU = 3 * NF, LUU = M::LUU, PLACE = M::PLACE, STEP = Shape<T, NF>::WARPS;
  const T* Cr = cu + r * NU * TILE;
  const T on = (active >> r) & 1 ? T(1) : T(0);
  T own[LUU > 0 ? LUU : 1], ar[R];
#pragma unroll
  for (int q = 0; q < LUU; ++q) {
    own[q] = Cr[(PLACE + q * STEP) * TILE];
    ar[q] = own[q] * on;
  }
  if constexpr (M::HAS_LU) ar[R - 1] = lam_bar[r * TILE];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    // Cu[r, j]: the value loaded above where j is one of the warp's rows of luu
    const int q_own = j >= PLACE && (j - PLACE) % STEP == 0 ? (j - PLACE) / STEP : LUU;
    const T c = q_own < LUU ? own[q_own < LUU ? q_own : 0] : Cr[j * TILE];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const T p = M::HAS_LU && q == R - 1 ? c * ar[q] : ar[q] * c;
      if constexpr (FIRST)
        acc[q][j] = p;
      else
        acc[q][j] = acc[q][j] + p;
    }
  }
}

// Warp W's sums (Sums) of stage knot k, scenario b: its rows of luu =
// diag(Rd) + ρ·Σ_r (Cu[r, i]·active_r)·Cu[r, :] and, where it has it, lu =
// Rd·(u − u_ref) + Σ_r Cu[r, :]·λ̄_r; each sum over the rows in four passes
// (pass m the rows r ≡ m mod 4, `sum4`'s order), a pass's terms in row
// order, then the passes added in order.
template <typename T, int NF, int W>
__device__ void sums(const Args<T>& a, const T* sm, const T* cu, const T* lam_bar,
                     uint64_t active, int k, long long b) {
  using M = Sums<T, NF, W>;
  constexpr int NU = 3 * NF, R = M::R, LUU = M::LUU, PLACE = M::PLACE,
                STEP = Shape<T, NF>::WARPS, UNROLL = Shape<T, NF>::SUM_UNROLL;
  if constexpr (R > 0) {
    const long long B = a.B, kk = k;
    const int nc = a.nc;
    T tot[R][NU];
#pragma unroll 1
    for (int m = 0; m < 4 && m < nc; ++m) {
      T acc[R][NU];
      add_row<true, T, NF, W, R>(cu, lam_bar, active, m, acc);
#pragma unroll UNROLL
      for (int r = m + 4; r < nc; r += 4) add_row<false, T, NF, W, R>(cu, lam_bar, active, r, acc);
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int j = 0; j < NU; ++j) tot[q][j] = m == 0 ? acc[q][j] : tot[q][j] + acc[q][j];
    }
    K8_STAMP(5);
    const Col<T> Rd = leaf(a, sm, IN_RD, SM_RD, b);
    if constexpr (LUU > 0) {
      const T rho = column(a.in[IN_RHO], b)[0];
      const Slab<T> luu{a.out[LUUS] + kk * NU * NU * B + b, B};
#pragma unroll
      for (int q = 0; q < LUU; ++q)
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          const int i = PLACE + q * STEP;
          const T d = i == j ? Rd[j] : T(0);
          luu.put(NU * i + j, nc > 0 ? d + rho * tot[q][j] : d);
        }
    }
    if constexpr (M::HAS_LU) {
      const Col<T> us = column(a.in[IN_US], b), u_ref = column(a.in[IN_U_REF], b).at(kk * NU);
      const Slab<T> lu{a.out[LUS] + kk * NU * B + b, B};
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        const T v = Rd[j] * (us[kk * NU + j] - u_ref[j]);
        lu.put(j, nc > 0 ? v + tot[R - 1][j] : v);
      }
    }
  }
}

// The sums of warp `warp` (W a constant in each branch).
template <typename T, int NF, int W = 0>
__device__ __forceinline__ void sums_of_warp(int warp, const Args<T>& a, const T* sm,
                                             const T* cu, const T* lam_bar, uint64_t active,
                                             int k, long long b) {
  if constexpr (W < Shape<T, NF>::WARPS) {
    if (warp == W)
      sums<T, NF, W>(a, sm, cu, lam_bar, active, k, b);
    else
      sums_of_warp<T, NF, W + 1>(warp, a, sm, cu, lam_bar, active, k, b);
  }
}

template <typename T, int NF>
__global__ void __launch_bounds__(Shape<T, NF>::THREADS, Shape<T, NF>::MIN_BLOCKS)
    expansions_kernel(const Args<T> a) {
  using S = Shape<T, NF>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  uint64_t* words = reinterpret_cast<uint64_t*>(smem_raw + a.words_at);
  T* lam_bar = reinterpret_cast<T*>(smem_raw + a.lam_at);
  T* cu_tile = reinterpret_cast<T*>(smem_raw + a.cu_at);
  const int warp = static_cast<int>(threadIdx.x) >> 5, lane = static_cast<int>(threadIdx.x) & 31;
  const int stage_blocks = a.N * a.tiles;
  const int block = static_cast<int>(blockIdx.x);
  const bool terminal = block >= stage_blocks;
  const int k = terminal ? a.N : block / a.tiles;
  const long long b0 = static_cast<long long>(block % a.tiles) * TILE;
  K8_STAMP(0);
  stage_leaves<T, NF>(a, sm, k);
  __syncthreads();  // the staged leaves have landed
  K8_STAMP(1);
  if (terminal) {  // a tile a warp
    const long long tile = static_cast<long long>(block - stage_blocks) * S::WARPS + warp;
    const long long b = tile * TILE + lane;
    if (tile < a.tiles && b < a.B) state_cost(a, sm, k, b);
    K8_STAMP(3);
    return;
  }
  const long long b = b0 + lane;
  const bool live = b < a.B;
  if (warp == P_AS) {
    if (live) dynamics_As<T, NF>(a, sm, k, b);
  } else if (warp == P_BS) {
    if (live) dynamics_Bs<T, NF>(a, sm, k, b);
  } else if (warp == P_STATE) {
    if (live) state_cost(a, sm, k, b);
  } else {
    constexpr int ROW_THREADS = 32 * S::ROW_WARPS;
    copy_cu<T, NF>(a, cu_tile, b0, static_cast<int>(threadIdx.x) - 32 * P_ROWS, ROW_THREADS);
    words[(warp - P_ROWS) * TILE + lane] =
        live ? al_rows<T, NF>(a, sm, cu_tile + lane, lam_bar + lane, warp - P_ROWS, k, b) : 0;
  }
  K8_STAMP(3);
  __syncthreads();  // λ̄ and the words of active rows have landed
  K8_STAMP(4);
  if (live) {
    uint64_t active = 0;
#pragma unroll
    for (int w = 0; w < S::ROW_WARPS; ++w) active |= words[w * TILE + lane];
    sums_of_warp<T, NF>(warp, a, sm, cu_tile + lane, lam_bar + lane, active, k, b);
    K8_STAMP(6);
  }
}

// The launch's arguments; nu sizes the tile's Cu in shared memory.
template <typename T>
Args<T> make_args(const void* const* in, const long long* strides, void* const* out, int N,
                  int B, int nc, int flags, int nu) {
  Args<T> a{};
  for (int i = 0; i < INPUTS; ++i)
    a.in[i] = In<T>{static_cast<const T*>(in[i]), strides[2 * i], strides[2 * i + 1]};
  for (int i = 0; i < OUTPUTS; ++i) a.out[i] = static_cast<T*>(out[i]);
  a.N = N, a.B = B, a.nc = nc, a.flags = flags;
  a.tiles = (B + TILE - 1) / TILE;
  const int row_warps = Shape<T, MAX_FEET>::ROW_WARPS;  // as many as any feet's
  a.words_at = (SM_VALUES * static_cast<int>(sizeof(T)) + 7) / 8 * 8;
  a.lam_at = a.words_at + row_warps * TILE * 8;
  a.cu_at = a.lam_at + nc * TILE * static_cast<int>(sizeof(T));
  a.smem = a.cu_at + nc * nu * TILE * static_cast<int>(sizeof(T));
  return a;
}

// The blocks of a launch: N·tiles stage blocks, then the terminal knot's, a
// tile a warp.
template <typename T, int NF>
int launch_blocks(const Args<T>& a) {
  constexpr int WARPS = Shape<T, NF>::WARPS;
  return a.N * a.tiles + (a.tiles + WARPS - 1) / WARPS;
}

// fn.template run<NF>() for n_feet = NF in 1..4, or -1.
template <typename Fn>
int with_feet(int n_feet, Fn& fn) {
  switch (n_feet) {
    case 1: return fn.template run<1>();
    case 2: return fn.template run<2>();
    case 3: return fn.template run<3>();
    case 4: return fn.template run<4>();
    default: return -1;
  }
}

}  // namespace

extern "C" void expansions_table(int* out) {
  out[0] = INPUTS;
  out[1] = OUTPUTS;
  out[2] = MAX_ROWS;
}

#ifdef __CUDACC__  // the host side: the launch and the C interface

namespace {

template <typename T>
struct Launch {
  Args<T> a;
  void* stream;

  template <int NF>
  int run() {
    // beyond 48 KB a block asks, on every launch: the attribute is the
    // current card's, and a launch may be on another card than the last
    if (a.smem > (48 << 10)) {
      const cudaError_t err = cudaFuncSetAttribute(
          expansions_kernel<T, NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    expansions_kernel<T, NF><<<launch_blocks<T, NF>(a), Shape<T, NF>::THREADS, a.smem,
                               static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T>
int launch(const void* const* in, const long long* strides, void* const* out, int N, int B,
           int n_feet, int nc, int flags, void* stream) {
  if (N < 1 || B < 1 || nc < 0 || nc > MAX_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  Launch<T> fn{make_args<T>(in, strides, out, N, B, nc, flags, 3 * n_feet), stream};
  const int err = with_feet(n_feet, fn);
  return err < 0 ? static_cast<int>(cudaErrorInvalidValue) : err;
}

}  // namespace

extern "C" int expansions_f32(const void* const* in, const long long* strides, void* const* out,
                              int N, int B, int n_feet, int nc, int flags, void* stream) {
  return launch<float>(in, strides, out, N, B, n_feet, nc, flags, stream);
}

extern "C" int expansions_f64(const void* const* in, const long long* strides, void* const* out,
                              int N, int B, int n_feet, int nc, int flags, void* stream) {
  return launch<double>(in, strides, out, N, B, n_feet, nc, flags, stream);
}

#ifdef K8_PHASE_CLOCKS
// The block whose warps stamp in the launches after it; every stamp set to 0.
extern "C" int expansions_clock_block(int block) {
  static const long long zeros[CLOCK_WARPS * CLOCK_SLOTS] = {};
  cudaError_t err = cudaMemcpyToSymbol(phase_clocks, zeros, sizeof(zeros));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(clock_block, &block, sizeof(int));
  return static_cast<int>(err);
}
// The stamps since, [warp][slot] (CLOCK_WARPS x CLOCK_SLOTS; 0 where a warp
// reaches no such slot), to host memory (synchronises).
extern "C" int expansions_clocks(long long* out, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, phase_clocks, sizeof(long long) * n));
}
#endif

#endif  // __CUDACC__
