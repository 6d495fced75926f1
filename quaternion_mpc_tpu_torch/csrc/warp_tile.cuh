// Small dense algebra shared by a warp: the pieces K1 (riccati_sweep.cu) and
// K4 (assoc_scan.cu) are both built from. A lane owns a block of a product's
// outputs (2x3: rows i0, i0+1, columns j0..j0+2; six accumulators in
// registers, five operand loads for six multiply-adds; or any RB x CB) and
// sums over M terms (by default NE = 12, K4's width and K1's widest); operands
// are read from shared memory with row strides given at compile time.
//
// Compiles as CUDA and, for the emulated tests, as plain C++ after
// tests/cuda_emulation.h.
#pragma once

namespace {

constexpr int NE = 12;  // the error-state dimension of the quaternion SRB, K4's width
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }

// max that keeps a NaN from either side, as torch.maximum does.
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// A lane's 2x3 block (rows i0, i0+1; columns j0..j0+2) of XᵀY:
// acc[r][c] += Σ_{m<M} X[m][i0+r]·Y[m][j0+c], m in order.
template <int LDX, int LDY, int M = NE, typename T>
__device__ __forceinline__ void mac_tn(T (&acc)[2][3], const T* X, const T* Y, int i0, int j0) {
  X += i0;
  Y += j0;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const T x0 = X[m * LDX], x1 = X[m * LDX + 1];
    const T y0 = Y[m * LDY], y1 = Y[m * LDY + 1], y2 = Y[m * LDY + 2];
    acc[0][0] += x0 * y0, acc[0][1] += x0 * y1, acc[0][2] += x0 * y2;
    acc[1][0] += x1 * y0, acc[1][1] += x1 * y1, acc[1][2] += x1 * y2;
  }
}

// The same block of XY: acc[r][c] += Σ_{m<M} X[i0+r][m]·Y[m][j0+c].
template <int LDX, int LDY, int M = NE, typename T>
__device__ __forceinline__ void mac_nn(T (&acc)[2][3], const T* X, const T* Y, int i0, int j0) {
  X += i0 * LDX;
  Y += j0;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const T x0 = X[m], x1 = X[LDX + m];
    const T y0 = Y[m * LDY], y1 = Y[m * LDY + 1], y2 = Y[m * LDY + 2];
    acc[0][0] += x0 * y0, acc[0][1] += x0 * y1, acc[0][2] += x0 * y2;
    acc[1][0] += x1 * y0, acc[1][1] += x1 * y1, acc[1][2] += x1 * y2;
  }
}

// The same block of XYᵀ: acc[r][c] += Σ_{m<M} X[i0+r][m]·Y[j0+c][m].
template <int LDX, int LDY, int M = NE, typename T>
__device__ __forceinline__ void mac_nt(T (&acc)[2][3], const T* X, const T* Y, int i0, int j0) {
  X += i0 * LDX;
  Y += j0 * LDY;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const T x0 = X[m], x1 = X[LDX + m];
    const T y0 = Y[m], y1 = Y[LDY + m], y2 = Y[2 * LDY + m];
    acc[0][0] += x0 * y0, acc[0][1] += x0 * y1, acc[0][2] += x0 * y2;
    acc[1][0] += x1 * y0, acc[1][1] += x1 * y1, acc[1][2] += x1 * y2;
  }
}

// The same products for a block of any RB x CB (K1 below 12 x 12), the terms
// in the same order. A 2x3 block takes the forms above, whose code K4 is held
// to: built from these loops instead, its f64 scan kernel took 102 registers,
// not 104.
template <int LDX, int LDY, int M, typename T, int RB, int CB>
__device__ __forceinline__ void mac_tn(T (&acc)[RB][CB], const T* X, const T* Y, int i0, int j0) {
  X += i0;
  Y += j0;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[r][c] += X[m * LDX + r] * Y[m * LDY + c];
}

template <int LDX, int LDY, int M, typename T, int RB, int CB>
__device__ __forceinline__ void mac_nn(T (&acc)[RB][CB], const T* X, const T* Y, int i0, int j0) {
  X += i0 * LDX;
  Y += j0;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[r][c] += X[r * LDX + m] * Y[m * LDY + c];
}

template <int LDM, typename T, int RB, int CB>
__device__ __forceinline__ void load_block(T (&acc)[RB][CB], const T* M, int i0, int j0) {
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[r][c] = M[(i0 + r) * LDM + j0 + c];
}

template <int LDM, typename T, int RB, int CB>
__device__ __forceinline__ void store_block(T* M, const T (&acc)[RB][CB], int i0, int j0) {
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < CB; ++c) M[(i0 + r) * LDM + j0 + c] = acc[r][c];
}

}  // namespace
