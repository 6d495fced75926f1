// K1 — fleet Riccati backward sweep over staged tiles, at the problem's own
// (ne, nu).
//
// Replaces experiments/pallas_fleet.py::riccati_sweep_pallas (body
// _sweep_kernel, solve gj_solve2): the N-knot Riccati recursion of the
// batch-last AL-iLQR backward pass (quaternion_mpc_tpu/solver/fleet.py
// riccati_step), run over expansions computed beforehand. The TPU kernel is
// compiled at the problem's (ne, nu); so is this one: one body templated on
// the shape (`Shape`), instantiated at every shape a problem of the repo
// solves at (`K1_SHAPES`).
//
// What bounds it on an H100: bytes. At 12 x 12, per scenario and knot it reads
// 600 values (A 144, B 144, lx 12, lxx 144, lu 12, luu 144) and writes 156 (K
// 144, d 12); per scenario it reads 157 more (lxN, lxxN, reg) and writes 3.
// Its arithmetic is ~18.9k multiply-adds a knot (nine 12x12x12 products, a
// 12x25 Gauss-Jordan elimination, a few matrix-vector products), which the
// card does in less time than it moves those bytes (kernels/riccati_sweep.py
// `work` counts both, at any shape). Each scenario is a serial chain of N
// knots, so what the design has to hide is the latency of that chain and of
// its loads.
//
// Design:
// - A scenario has G lanes: a warp at 12 error states, a width-G group of a
//   warp below (8 at ne = 6, 4 at ne <= 4), 32 / G scenarios a warp. A block
//   has 256 threads and owns a tile of TILE = 256 / G consecutive scenarios.
// - At 12 x 12 (`knot`) lanes 0..23 each own a 2x3 block of the 144 outputs of
//   a product (six accumulators in registers, five operand loads for six
//   multiply-adds). At any other shape (`knot_group`) each product is cut into
//   blocks of at most 2x3 (`Tiling`) dealt over the group's lanes.
// - The Gauss-Jordan elimination runs in registers: a lane holds a column (or
//   two) of the NU x (NU + 1 + NE) system [Quu + reg·I | Qu | Qux] and a
//   pivot step broadcasts the pivot column by shuffles inside the group, in
//   the plain version's order (columns 0..NU-1, no pivoting: the regularised
//   Quu is SPD), so kernel and `riccati_sweep_ref` differ by rounding only
//   (the pivot row is scaled by the pivot's reciprocal, not divided by it:
//   the division sat on the chain from one pivot to the next).
// - Every product and sum runs its terms in the order the 12 x 12 body does
//   over the live indices, and the dV sums reduce over the group by the same
//   butterfly: a problem embedded in 12 x 12 (kernels/riccati_sweep.py
//   `embed`) only adds exact zeros to those sums, so its native launch and its
//   embedded one differ at most where the compiler contracts differently.
// - The working set of a scenario (Vxx, Vx, AᵀVxx, BᵀVxx, Qxx, Quu, Qux,
//   KᵀQuu, Qx, Qu, the staged knots and the gains on their way out, ~2.5k
//   values at 12 x 12, ~450 at 6 x 3) lives in shared memory: at 12 x 12
//   80,640 bytes a block in f32 (two blocks an SM) and 160,640 in f64 (one).
//   Matrices the kernel forms itself have a row stride of NE + 1 values.
//   Nothing spills.
// - Each knot's slabs are staged once: all threads of the block copy the
//   tile's values with cp.async, thread t taking scenario t % TILE and every
//   (256 / TILE)th row from row t / TILE on, so that neighbouring threads read
//   consecutive scenarios of a batch-last slab. The passes are unrolled: in a
//   rolled loop each copy waited until the one before had read its address
//   registers. The copy transposes on the way in (scenario s of the tile lands
//   s·stride values in, the stride chosen so that a warp's copies fall into
//   distinct banks: `Layout`), which is why every copy is one element wide (4
//   bytes in f32, 8 in f64) and not 16: a 16-byte copy would keep four
//   scenarios side by side in shared memory, where a warp reading one
//   scenario's matrix would hit each bank eight times. One-element copies
//   need no alignment, so any B takes the same path and the ragged last tile
//   is masked element by element.
// - A problem whose inequality has state rows carries a cost cross term lux
//   (NU x NE a knot), so that Qux = lux + BᵀVxxA. The shapes such problems
//   solve at are instantiated with it too (LUX): a knot stages one more slab
//   (at 12 x 12 90,880 bytes a block in f32, 179,072 in f64, the same blocks
//   an SM) and the Qux accumulators start from it; without it none of that is
//   compiled in, so a problem with no state rows pays nothing for it.
// - Two stages: right after the barrier that opens knot k the block starts
//   the copies of knot k-1 into the other stage, so they fly under knot k's
//   arithmetic. Only Vx and Vxx carry from knot to knot. K and d of a knot
//   go to a double-buffered shared tile and the whole block writes them out,
//   coalesced along B, after the next barrier: one __syncthreads() a knot.
//
// C interface (bound with ctypes): riccati_sweep_f32 / riccati_sweep_f64 take
// ne, nu, the 15 device pointers (luxs null for a problem without the cross
// term), N, B and a cudaStream_t, launch the instantiation at (ne, nu, lux) on
// that stream and return the CUDA error of the launch (0 when it was accepted;
// -1 where there is no such instantiation). riccati_sweep_smem_bytes(is_f64,
// ne, nu, has_lux) is the dynamic shared memory of a block (-1: none), and
// riccati_sweep_shapes(out, n) writes the instantiations' (ne, nu, lux)
// triples and returns their count.
//
// Built with -DK1_PHASE_CLOCKS (k1_phase_clocks.py does), lane 0 of the first
// scenario of the middle block stamps clock64() after every phase of every
// knot, and riccati_sweep_clocks(out, n) copies the stamps to the host: the
// card's profilers for this do not run everywhere.
//
// The device code also compiles as plain C++ (no __CUDACC__): a host compiler
// given stand-ins for the warp and block primitives (tests/cuda_emulation.h)
// runs a block with one fiber a thread, and cp_async then copies at once.
// That is how tests/test_torch_sweep_emulation.py checks the kernel's
// indexing and barriers against the plain version where there is no card.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include <cstddef>

#include "warp_tile.cuh"  // FULL, the block products, abs_t, max_nan

// The instantiations, (ne, nu, lux): the Go1 fleets, the convex baseline,
// spider_dog and the drawn mixed rows at 12 x 12; the humanoid and the
// two-foot trot at 12 x 6; falling_cat at 6 x 3; the bicycle (with state rows)
// and the double integrator at 4 x 2; the pendulum at 2 x 1. Any other shape
// up to 12 x 12 is embedded by the wrapper in the smallest that holds it.
#define K1_SHAPES(X)                                                                        \
  X(12, 12, false) X(12, 12, true) X(12, 6, false) X(6, 3, false) X(4, 2, false) \
  X(4, 2, true) X(2, 1, false)

namespace {

// A problem's shape and where a scenario's values sit, in values.
template <int NE_, int NU_, bool LUX_>
struct Shape {
  static constexpr int NE = NE_, NU = NU_;
  static constexpr bool LUX = LUX_;
  static constexpr bool WARP12 = NE == 12 && NU == 12;  // the 12 x 12 body (`knot`)
  static constexpr int G = NE > 8 ? 32 : NE > 4 ? 8 : 4;  // lanes a scenario
  static constexpr int THREADS = 256;
  static constexpr int TILE = THREADS / G;  // scenarios of a block
  static constexpr int LD = NE + 1;  // row stride of the matrices the kernel forms itself
  static constexpr int MAT = NE * NE, BMAT = NE * NU;
  // A staged knot: dense row-major slabs, then with the cross term lux (NU x NE).
  static constexpr int IN_A = 0, IN_B = MAT, IN_LXX = IN_B + BMAT, IN_LUU = IN_LXX + MAT;
  static constexpr int IN_LX = IN_LUU + NU * NU, IN_LU = IN_LX + NE, IN_LUX = IN_LU + NU;
  static constexpr int IN_VALUES = IN_LUX + (LUX ? BMAT : 0);
  // The gains of one knot on their way out: K (NU x NE, dense), then d.
  static constexpr int OUT_K = 0, OUT_D = BMAT, OUT_VALUES = OUT_D + NU;
  // The value function: Vxx (dense), then Vx.
  static constexpr int V_XX = 0, V_X = MAT, V_VALUES = V_X + NE;
  // A scenario's own matrices (row stride LD). AᵀVxx is dead when KᵀQuu is
  // formed, BᵀVxx when the unsymmetrised Vxx is, so each pair shares its place.
  static constexpr int W_ATV = 0, W_KTQUU = W_ATV, W_BTV = NE * LD, W_VUN = W_BTV;
  static constexpr int W_QXX = 2 * NE * LD, W_QUU = 3 * NE * LD, W_QUX = W_QUU + NU * LD;
  static constexpr int W_QX = W_QUX + NU * LD, W_QU = W_QX + NE, W_VALUES = W_QU + NU;
};

// Where each region of a block's shared memory starts, in values of T. The
// regions the whole block copies into or out of keep scenario s of the tile
// s·stride values in. A warp's copies move TILE scenarios x 32/TILE rows at
// once where TILE < 32 (a half-warp's 16/TILE rows in f64, whose banks are
// eight bytes wide): stride ≡ 32/TILE (mod 32) in f32, ≡ 16/TILE (mod 16) in
// f64 puts them into distinct banks. With a tile of 32 scenarios or more a
// warp's copies are 32 scenarios of one row, and an odd stride does.
template <class S, typename T>
struct Layout {
  static constexpr int BANKS = 128 / static_cast<int>(sizeof(T));
  static constexpr int pad(int n) {
    return S::TILE >= BANKS ? n | 1 : n + (BANKS / S::TILE - n % BANKS + BANKS) % BANKS;
  }
  static constexpr int IN = pad(S::IN_VALUES);
  static constexpr int OUT = pad(S::OUT_VALUES);
  static constexpr int V = pad(S::V_VALUES);
  static constexpr int IN_AT = 0;                            // two stages
  static constexpr int OUT_AT = IN_AT + 2 * S::TILE * IN;    // two buffers
  static constexpr int V_AT = OUT_AT + 2 * S::TILE * OUT;
  static constexpr int WORK_AT = V_AT + S::TILE * V;
  static constexpr int VALUES = WORK_AT + S::TILE * S::W_VALUES;
  static constexpr size_t BYTES = static_cast<size_t>(VALUES) * sizeof(T);
};

#ifdef K1_PHASE_CLOCKS
__device__ long long phase_clocks[1 << 14];
struct Stamp {
  int n = 0;
  bool on;
  __device__ explicit Stamp(bool on_) : on(on_) {}
  __device__ __forceinline__ void operator()() {
    if (on) phase_clocks[n++] = clock64();
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

// Waits for every copy this thread has started.
__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// The block copies ROWS rows of a batch-last slab (row r of scenario b at
// src[r·B + b]) for the tile's scenarios b0..b0+TILE-1 to dst[s·stride + r].
// A thread keeps one scenario and takes every (THREADS/TILE)th row; the
// passes are unrolled so that each copy has address registers of its own and
// none waits for the one before to have read them.
template <class S, int ROWS, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int stride, const T* src, int B, int b0) {
  const int s = threadIdx.x % S::TILE, row0 = threadIdx.x / S::TILE;
  if (b0 + s >= B) return;
  dst += s * stride;
  src += b0 + s;
#pragma unroll
  for (int row = 0; row < ROWS; row += S::THREADS / S::TILE)
    if (row0 + row < ROWS) cp_async(dst + row0 + row, src + static_cast<size_t>(row0 + row) * B);
}

// The reverse, with plain stores: rows of src[s·stride + r] to dst[r·B + b].
template <class S, int ROWS, typename T>
__device__ __forceinline__ void unstage_rows(T* dst, const T* src, int stride, int B, int b0) {
  const int s = threadIdx.x % S::TILE, row0 = threadIdx.x / S::TILE;
  if (b0 + s >= B) return;
  src += s * stride;
  dst += b0 + s;
#pragma unroll
  for (int row = 0; row < ROWS; row += S::THREADS / S::TILE)
    if (row0 + row < ROWS) dst[static_cast<size_t>(row0 + row) * B] = src[row0 + row];
}

// One knot of one scenario at 12 x 12, by its warp. `in` is the staged knot,
// `out` receives K and d, `V` holds (Vxx, Vx) and is updated in place, `W` is
// the warp's own scratch. dV1, dV2 and gmax accumulate in every lane alike.
template <class S, typename T>
__device__ __forceinline__ void knot(const T* in, T* out, T* V, T* W, T reg, int lane,
                                     T& dV1, T& dV2, T& gmax, Stamp& stamp) {
  static_assert(S::WARP12 && S::G == 32, "the lane mapping assumes NE == NU == 12");
  constexpr int NU = S::NU, LD = S::LD;
  const T *A = in + S::IN_A, *Bm = in + S::IN_B, *lxx = in + S::IN_LXX, *luu = in + S::IN_LUU;
  T *K = out + S::OUT_K, *d = out + S::OUT_D;
  T *Vxx = V + S::V_XX, *Vx = V + S::V_X;
  T *AtV = W + S::W_ATV, *BtV = W + S::W_BTV, *KtQuu = W + S::W_KTQUU, *Vun = W + S::W_VUN;
  T *Qxx = W + S::W_QXX, *Quu = W + S::W_QUU, *Qux = W + S::W_QUX, *Qu = W + S::W_QU;
  const bool owns_block = lane < 24;  // six block rows x four block columns
  const int i0 = 2 * (lane >> 2), j0 = 3 * (lane & 3);

  // ---- AᵀVxx and BᵀVxx; [Qx; Qu] = [lx; lu] + [Aᵀ; Bᵀ]·Vx, one entry a lane
  if (owns_block) {
    T a[2][3] = {}, b[2][3] = {};
    mac_tn<NE, NE>(a, A, Vxx, i0, j0);
    mac_tn<NU, NE>(b, Bm, Vxx, i0, j0);
    store_block<LD>(AtV, a, i0, j0);
    store_block<LD>(BtV, b, i0, j0);
    const T* X = (lane < NE ? A : Bm) + (lane < NE ? lane : lane - NE);
    T s = in[S::IN_LX + lane];  // lu follows lx
#pragma unroll
    for (int m = 0; m < NE; ++m) s += X[m * NE] * Vx[m];
    W[S::W_QX + lane] = s;  // Qu follows Qx
  }
  __syncwarp();
  stamp();

  // ---- Qxx = lxx + AᵀVxxA, Quu = luu + BᵀVxxB, Qux = (lux +) BᵀVxxA
  if (owns_block) {
    T q[2][3], u[2][3], x[2][3] = {};
    load_block<NE>(q, lxx, i0, j0);
    load_block<NU>(u, luu, i0, j0);
    if constexpr (S::LUX) load_block<NE>(x, in + S::IN_LUX, i0, j0);
    mac_nn<LD, NE>(q, AtV, A, i0, j0);
    mac_nn<LD, NU>(u, BtV, Bm, i0, j0);
    mac_nn<LD, NE>(x, BtV, A, i0, j0);
    store_block<LD>(Qxx, q, i0, j0);
    store_block<LD>(Quu, u, i0, j0);
    store_block<LD>(Qux, x, i0, j0);
  }
  __syncwarp();
  stamp();

  // ---- (Quu + reg·I)·[d K] = [Qu Qux] by Gauss-Jordan, no pivoting, columns
  // eliminated in order 0..NU-1 (fleet.solve_spd_multi). Lane c holds column
  // c of the augmented system: Quu + reg·I in lanes 0..11, Qu in lane 12, Qux
  // in lanes 13..24. Lanes 25..31 carry a copy of Qu that nothing reads.
  {
    const T* src = Qu;
    int step = 1;
    if (lane < NU) {
      src = Quu + lane, step = LD;
    } else if (lane > NU && lane <= NU + NE) {
      src = Qux + (lane - NU - 1), step = LD;
    }
    T col[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) col[i] = src[i * step] + (i == lane ? reg : T(0));
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      // Column j of the system, from its lane: all twelve shuffles go out
      // before the reciprocal of the pivot f[j] is needed. Row j is scaled by
      // that reciprocal (one rounding more than the plain version's division).
      T f[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) f[i] = __shfl_sync(FULL, col[i], j);
      const T row_j = col[j] * (T(1) / f[j]);
#pragma unroll
      for (int i = 0; i < NU; ++i) col[i] = i == j ? row_j : col[i] - f[i] * row_j;
    }
    if (lane >= NU && lane <= NU + NE) {
      T* dst = lane == NU ? d : K + (lane - NU - 1);
      const int to = lane == NU ? 1 : NE;
#pragma unroll
      for (int i = 0; i < NU; ++i) dst[i * to] = -col[i];
    }
  }
  __syncwarp();
  stamp();

  // ---- KᵀQuu; the expected-decrease terms and the gradient norm
  if (owns_block) {
    T t[2][3] = {};
    mac_tn<NE, LD>(t, K, Quu, i0, j0);
    store_block<LD>(KtQuu, t, i0, j0);
  }
  {
    T s1 = T(0), s2 = T(0), g = T(0);
    if (lane < NU) {
      T Qd = T(0);
#pragma unroll
      for (int m = 0; m < NU; ++m) Qd += Quu[lane * LD + m] * d[m];
      s1 = d[lane] * Qu[lane];
      s2 = d[lane] * Qd;
      g = abs_t(Qu[lane]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(FULL, s1, off);
      s2 += __shfl_xor_sync(FULL, s2, off);
      g = max_nan(g, __shfl_xor_sync(FULL, g, off));
    }
    dV1 = dV1 + s1;
    dV2 = dV2 + T(0.5) * s2;
    gmax = max_nan(g, gmax);
  }
  __syncwarp();
  stamp();

  // ---- the value update: unsymmetrised Vxx = Qxx + KᵀQuuK + KᵀQux + QuxᵀK,
  // Vx = Qx + KᵀQuu·d + Kᵀ·Qu + Quxᵀ·d
  if (owns_block) {
    T v[2][3];
    load_block<LD>(v, Qxx, i0, j0);
    mac_nn<LD, NE>(v, KtQuu, K, i0, j0);
    mac_tn<NE, LD>(v, K, Qux, i0, j0);
    mac_tn<LD, NE>(v, Qux, K, i0, j0);
    store_block<LD>(Vun, v, i0, j0);
  }
  if (lane < NE) {
    T s = W[S::W_QX + lane];
#pragma unroll
    for (int m = 0; m < NU; ++m)
      s += KtQuu[lane * LD + m] * d[m] + K[m * NE + lane] * Qu[m] + Qux[m * LD + lane] * d[m];
    Vx[lane] = s;
  }
  __syncwarp();
  stamp();

  // ---- Vxx = ½(Vxx + Vxxᵀ). The next reader of Vxx and Vx comes after the
  // block barrier that opens the next knot.
  if (owns_block) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int i = i0 + r, j = j0 + c;
        Vxx[i * NE + j] = T(0.5) * (Vun[i * LD + j] + Vun[j * LD + i]);
      }
  }
  stamp();
}

// How a G-lane group deals an R x C product: blocks of RB x CB outputs (at
// most 2x3), numbered row by row, block k to lane k % G.
template <int R, int C>
struct Tiling {
  static constexpr int RB = R % 2 == 0 ? 2 : 1;
  static constexpr int CB = C % 3 == 0 ? 3 : C % 2 == 0 ? 2 : 1;
  static constexpr int PER_ROW = C / CB, COUNT = R / RB * PER_ROW;
};

// f(i0, j0) for each block of tiling P that `lane` owns (its first row and
// column).
template <class P, int G, typename F>
__device__ __forceinline__ void for_blocks(int lane, const F& f) {
#pragma unroll
  for (int k0 = 0; k0 < P::COUNT; k0 += G)
    if (k0 + lane < P::COUNT) f(P::RB * ((k0 + lane) / P::PER_ROW), P::CB * ((k0 + lane) % P::PER_ROW));
}

// One knot of one scenario at any other shape, by its group of G lanes
// (`lane` 0..G-1); the phases and their terms as in `knot`. Every lane of the
// warp calls it: the groups' shuffles are the warp's.
template <class S, typename T>
__device__ __forceinline__ void knot_group(const T* in, T* out, T* V, T* W, T reg, int lane,
                                           T& dV1, T& dV2, T& gmax, Stamp& stamp) {
  constexpr int NE = S::NE, NU = S::NU, G = S::G, LD = S::LD;
  static_assert(NU <= G, "the dV sums take one input a lane");
  using PXX = Tiling<NE, NE>;
  using PUX = Tiling<NU, NE>;
  using PUU = Tiling<NU, NU>;
  using PXU = Tiling<NE, NU>;
  const T *A = in + S::IN_A, *Bm = in + S::IN_B, *lxx = in + S::IN_LXX, *luu = in + S::IN_LUU;
  T *K = out + S::OUT_K, *d = out + S::OUT_D;
  T *Vxx = V + S::V_XX, *Vx = V + S::V_X;
  T *AtV = W + S::W_ATV, *BtV = W + S::W_BTV, *KtQuu = W + S::W_KTQUU, *Vun = W + S::W_VUN;
  T *Qxx = W + S::W_QXX, *Quu = W + S::W_QUU, *Qux = W + S::W_QUX, *Qu = W + S::W_QU;

  // ---- AᵀVxx and BᵀVxx; [Qx; Qu] = [lx; lu] + [Aᵀ; Bᵀ]·Vx, an entry a lane
  for_blocks<PXX, G>(lane, [&](int i0, int j0) {
    T a[PXX::RB][PXX::CB] = {};
    mac_tn<NE, NE, NE>(a, A, Vxx, i0, j0);
    store_block<LD>(AtV, a, i0, j0);
  });
  for_blocks<PUX, G>(lane, [&](int i0, int j0) {
    T b[PUX::RB][PUX::CB] = {};
    mac_tn<NU, NE, NE>(b, Bm, Vxx, i0, j0);
    store_block<LD>(BtV, b, i0, j0);
  });
#pragma unroll
  for (int e0 = 0; e0 < NE + NU; e0 += G) {
    const int e = e0 + lane;
    if (e >= NE + NU) break;
    const T* X = e < NE ? A + e : Bm + (e - NE);
    const int step = e < NE ? NE : NU;
    T s = in[S::IN_LX + e];  // lu follows lx
#pragma unroll
    for (int m = 0; m < NE; ++m) s += X[m * step] * Vx[m];
    W[S::W_QX + e] = s;  // Qu follows Qx
  }
  __syncwarp();
  stamp();

  // ---- Qxx = lxx + AᵀVxxA, Quu = luu + BᵀVxxB, Qux = (lux +) BᵀVxxA
  for_blocks<PXX, G>(lane, [&](int i0, int j0) {
    T q[PXX::RB][PXX::CB];
    load_block<NE>(q, lxx, i0, j0);
    mac_nn<LD, NE, NE>(q, AtV, A, i0, j0);
    store_block<LD>(Qxx, q, i0, j0);
  });
  for_blocks<PUU, G>(lane, [&](int i0, int j0) {
    T u[PUU::RB][PUU::CB];
    load_block<NU>(u, luu, i0, j0);
    mac_nn<LD, NU, NE>(u, BtV, Bm, i0, j0);
    store_block<LD>(Quu, u, i0, j0);
  });
  for_blocks<PUX, G>(lane, [&](int i0, int j0) {
    T x[PUX::RB][PUX::CB] = {};
    if constexpr (S::LUX) load_block<NE>(x, in + S::IN_LUX, i0, j0);
    mac_nn<LD, NE, NE>(x, BtV, A, i0, j0);
    store_block<LD>(Qux, x, i0, j0);
  });
  __syncwarp();
  stamp();

  // ---- (Quu + reg·I)·[d K] = [Qu Qux] by Gauss-Jordan, no pivoting, columns
  // in order 0..NU-1. Column c of the NU + 1 + NE columns (Quu + reg·I, Qu,
  // Qux) sits in slot c / G of lane c % G; a slot past them carries a copy of
  // Qu that nothing reads. Pivot column j comes from its lane by width-G
  // shuffles; row j is scaled by the pivot's reciprocal.
  {
    constexpr int SLOTS = (NU + 1 + NE + G - 1) / G;
    T col[SLOTS][NU];
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int c = lane + t * G;
      const T* src = Qu;
      int step = 1;
      if (c < NU) {
        src = Quu + c, step = LD;
      } else if (c > NU && c <= NU + NE) {
        src = Qux + (c - NU - 1), step = LD;
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) col[t][i] = src[i * step] + (i == c ? reg : T(0));
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      T f[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) f[i] = __shfl_sync(FULL, col[j / G][i], j % G, G);
      const T inv = T(1) / f[j];
#pragma unroll
      for (int t = 0; t < SLOTS; ++t) {
        const T row_j = col[t][j] * inv;
#pragma unroll
        for (int i = 0; i < NU; ++i) col[t][i] = i == j ? row_j : col[t][i] - f[i] * row_j;
      }
    }
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int c = lane + t * G;
      if (c >= NU && c <= NU + NE) {
        T* dst = c == NU ? d : K + (c - NU - 1);
        const int to = c == NU ? 1 : NE;
#pragma unroll
        for (int i = 0; i < NU; ++i) dst[i * to] = -col[t][i];
      }
    }
  }
  __syncwarp();
  stamp();

  // ---- KᵀQuu; the expected-decrease terms and the gradient norm, summed
  // over the group by the butterfly of `knot` (its lanes past G add zeros)
  for_blocks<PXU, G>(lane, [&](int i0, int j0) {
    T t[PXU::RB][PXU::CB] = {};
    mac_tn<NE, LD, NU>(t, K, Quu, i0, j0);
    store_block<LD>(KtQuu, t, i0, j0);
  });
  {
    T s1 = T(0), s2 = T(0), g = T(0);
    if (lane < NU) {
      T Qd = T(0);
#pragma unroll
      for (int m = 0; m < NU; ++m) Qd += Quu[lane * LD + m] * d[m];
      s1 = d[lane] * Qu[lane];
      s2 = d[lane] * Qd;
      g = abs_t(Qu[lane]);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(FULL, s1, off, G);
      s2 += __shfl_xor_sync(FULL, s2, off, G);
      g = max_nan(g, __shfl_xor_sync(FULL, g, off, G));
    }
    dV1 = dV1 + s1;
    dV2 = dV2 + T(0.5) * s2;
    gmax = max_nan(g, gmax);
  }
  __syncwarp();
  stamp();

  // ---- the value update: unsymmetrised Vxx = Qxx + KᵀQuuK + KᵀQux + QuxᵀK,
  // Vx = Qx + KᵀQuu·d + Kᵀ·Qu + Quxᵀ·d
  for_blocks<PXX, G>(lane, [&](int i0, int j0) {
    T v[PXX::RB][PXX::CB];
    load_block<LD>(v, Qxx, i0, j0);
    mac_nn<LD, NE, NU>(v, KtQuu, K, i0, j0);
    mac_tn<NE, LD, NU>(v, K, Qux, i0, j0);
    mac_tn<LD, NE, NU>(v, Qux, K, i0, j0);
    store_block<LD>(Vun, v, i0, j0);
  });
#pragma unroll
  for (int e0 = 0; e0 < NE; e0 += G) {
    const int e = e0 + lane;
    if (e >= NE) break;
    T s = W[S::W_QX + e];
#pragma unroll
    for (int m = 0; m < NU; ++m)
      s += KtQuu[e * LD + m] * d[m] + K[m * NE + e] * Qu[m] + Qux[m * LD + e] * d[m];
    Vx[e] = s;
  }
  __syncwarp();
  stamp();

  // ---- Vxx = ½(Vxx + Vxxᵀ)
  for_blocks<PXX, G>(lane, [&](int i0, int j0) {
#pragma unroll
    for (int r = 0; r < PXX::RB; ++r)
#pragma unroll
      for (int c = 0; c < PXX::CB; ++c) {
        const int i = i0 + r, j = j0 + c;
        Vxx[i * NE + j] = T(0.5) * (Vun[i * LD + j] + Vun[j * LD + i]);
      }
  });
  stamp();
}

template <class S, typename T>
__global__ void __launch_bounds__(S::THREADS, sizeof(T) == 4 ? 2 : 1) riccati_sweep_kernel(
    const T* __restrict__ As, const T* __restrict__ Bs,
    const T* __restrict__ lxs, const T* __restrict__ lxxs,
    const T* __restrict__ lus, const T* __restrict__ luus,
    const T* __restrict__ luxs,  // read only where S::LUX
    const T* __restrict__ lxN, const T* __restrict__ lxxN,
    const T* __restrict__ reg, T* __restrict__ Ks, T* __restrict__ ds,
    T* __restrict__ dV1_out, T* __restrict__ dV2_out, T* __restrict__ gmax_out,
    int N, int B) {
  using L = Layout<S, T>;
  constexpr int NE = S::NE, NU = S::NU, TILE = S::TILE, G = S::G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x % G, group = threadIdx.x / G;
  const int b0 = blockIdx.x * TILE;  // the tile's first scenario
  const int b = b0 + group;          // this group's scenario
  const bool live = b < B;           // false only in the ragged last tile
  // A warp's groups run their knots together (their shuffles are the warp's),
  // as long as its first scenario is live.
  const bool warp_live = b0 + group / (32 / G) * (32 / G) < B;
  const size_t sB = static_cast<size_t>(B);

  // The block stages knot k into stage k & 1 ...
  auto stage_knot = [&](int k) {
    T* to = smem + L::IN_AT + (k & 1) * TILE * L::IN;
    const size_t kB = static_cast<size_t>(k) * sB;
    stage_rows<S, NE * NE>(to + S::IN_A, L::IN, As + kB * (NE * NE), B, b0);
    stage_rows<S, NE * NU>(to + S::IN_B, L::IN, Bs + kB * (NE * NU), B, b0);
    stage_rows<S, NE * NE>(to + S::IN_LXX, L::IN, lxxs + kB * (NE * NE), B, b0);
    stage_rows<S, NU * NU>(to + S::IN_LUU, L::IN, luus + kB * (NU * NU), B, b0);
    stage_rows<S, NE>(to + S::IN_LX, L::IN, lxs + kB * NE, B, b0);
    stage_rows<S, NU>(to + S::IN_LU, L::IN, lus + kB * NU, B, b0);
    if constexpr (S::LUX)
      stage_rows<S, NU * NE>(to + S::IN_LUX, L::IN, luxs + kB * (NU * NE), B, b0);
  };
  // ... and writes the gains of knot k out of buffer k & 1.
  auto write_gains = [&](int k) {
    const T* from = smem + L::OUT_AT + (k & 1) * TILE * L::OUT;
    const size_t kB = static_cast<size_t>(k) * sB;
    unstage_rows<S, NU * NE>(Ks + kB * (NU * NE), from + S::OUT_K, L::OUT, B, b0);
    unstage_rows<S, NU>(ds + kB * NU, from + S::OUT_D, L::OUT, B, b0);
  };

  stage_rows<S, NE * NE>(smem + L::V_AT + S::V_XX, L::V, lxxN, B, b0);
  stage_rows<S, NE>(smem + L::V_AT + S::V_X, L::V, lxN, B, b0);
  if (N > 0) stage_knot(N - 1);

  const T r = live ? reg[b] : T(0);
  T dV1 = T(0), dV2 = T(0), gmax = T(0);
  Stamp stamp(blockIdx.x == gridDim.x / 2 && threadIdx.x == 0);
  stamp();
  stamp();  // twice: their distance is what a stamp costs
  for (int k = N - 1; k >= 0; --k) {
    // Knot k has landed, for every thread; every scenario is done with knot
    // k+1, so its stage is free and its gains are complete.
    cp_async_wait_all();
    __syncthreads();
    stamp();
    if (k > 0) stage_knot(k - 1);
    stamp();
    if (k < N - 1) write_gains(k + 1);
    stamp();
    if (warp_live) {
      const T* in = smem + L::IN_AT + ((k & 1) * TILE + group) * L::IN;
      T* out = smem + L::OUT_AT + ((k & 1) * TILE + group) * L::OUT;
      T* V = smem + L::V_AT + group * L::V;
      T* W = smem + L::WORK_AT + group * S::W_VALUES;
      if constexpr (S::WARP12) {
        knot<S>(in, out, V, W, r, lane, dV1, dV2, gmax, stamp);
      } else {
        knot_group<S>(in, out, V, W, r, lane, dV1, dV2, gmax, stamp);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (N > 0) write_gains(0);
  if (live && lane == 0) {
    dV1_out[b] = dV1;
    dV2_out[b] = dV2;
    gmax_out[b] = gmax;
  }
}

}  // namespace

// Plain C++ too: the emulated tests read the layout through them.
extern "C" int riccati_sweep_smem_bytes(int is_f64, int ne, int nu, int has_lux) {
#define K1_BYTES(e, u, x)                                                          \
  if (ne == e && nu == u && (has_lux != 0) == x)                                   \
    return static_cast<int>(is_f64 ? Layout<Shape<e, u, x>, double>::BYTES         \
                                   : Layout<Shape<e, u, x>, float>::BYTES);
  K1_SHAPES(K1_BYTES)
#undef K1_BYTES
  return -1;
}

extern "C" int riccati_sweep_shapes(int* out, int n) {
  int count = 0;
#define K1_SHAPE(e, u, x)    \
  if (3 * count + 2 < n) {   \
    out[3 * count] = e;      \
    out[3 * count + 1] = u;  \
    out[3 * count + 2] = x;  \
  }                          \
  ++count;
  K1_SHAPES(K1_SHAPE)
#undef K1_SHAPE
  return count;
}

#ifdef __CUDACC__  // the host side: the launch and the C interface

namespace {

template <class S, typename T>
int launch(const T* As, const T* Bs, const T* lxs, const T* lxxs, const T* lus,
           const T* luus, const T* luxs, const T* lxN, const T* lxxN, const T* reg, T* Ks,
           T* ds, T* dV1, T* dV2, T* gmax, int N, int B, void* stream) {
  constexpr size_t bytes = Layout<S, T>::BYTES;
  // Above 48 KB a block's dynamic shared memory has to be asked for.
  cudaError_t err = cudaFuncSetAttribute(riccati_sweep_kernel<S, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + S::TILE - 1) / S::TILE;
  riccati_sweep_kernel<S, T><<<blocks, S::THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      As, Bs, lxs, lxxs, lus, luus, luxs, lxN, lxxN, reg, Ks, ds, dV1, dV2, gmax, N, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int ne, int nu, const T* As, const T* Bs, const T* lxs, const T* lxxs,
             const T* lus, const T* luus, const T* luxs, const T* lxN, const T* lxxN,
             const T* reg, T* Ks, T* ds, T* dV1, T* dV2, T* gmax, int N, int B, void* stream) {
  const bool lux = luxs != nullptr;
#define K1_LAUNCH(e, u, x)                                                                 \
  if (ne == e && nu == u && lux == x)                                                      \
    return launch<Shape<e, u, x>, T>(As, Bs, lxs, lxxs, lus, luus, luxs, lxN, lxxN, reg, Ks, \
                                     ds, dV1, dV2, gmax, N, B, stream);
  K1_SHAPES(K1_LAUNCH)
#undef K1_LAUNCH
  return -1;
}

}  // namespace

#define RICCATI_SWEEP_ENTRY(name, T)                                                       \
  extern "C" int name(int ne, int nu, const T* As, const T* Bs, const T* lxs, const T* lxxs, \
                      const T* lus, const T* luus, const T* luxs, const T* lxN,              \
                      const T* lxxN, const T* reg, T* Ks, T* ds, T* dV1, T* dV2, T* gmax,    \
                      int N, int B, void* stream) {                                          \
    return dispatch<T>(ne, nu, As, Bs, lxs, lxxs, lus, luus, luxs, lxN, lxxN, reg, Ks, ds,   \
                       dV1, dV2, gmax, N, B, stream);                                        \
  }
RICCATI_SWEEP_ENTRY(riccati_sweep_f32, float)
RICCATI_SWEEP_ENTRY(riccati_sweep_f64, double)

#ifdef K1_PHASE_CLOCKS
// The first n stamps of the last launch, to host memory (synchronises).
extern "C" int riccati_sweep_clocks(long long* out, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, phase_clocks, sizeof(long long) * n));
}
#endif

#endif  // __CUDACC__
