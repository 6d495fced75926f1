// Device helpers shared by the kernels that read batch-last inputs through a
// table of pointers with each input's row and batch stride (K2,
// csrc/line_search.cu; K8, csrc/expansions.cu; K9, csrc/rollout.cu): an
// input's view, one scenario's column of it, and the 3 x 3 inverse of the
// models' inertia. Element (row i of an input's leading axes flattened,
// scenario b) lies at i·row stride + b·batch stride: a batch-last leaf has
// row stride B (or 1) and batch stride 1 (or 0, a value every scenario
// shares), and the batch-first model parameters (params_to_fleet's movedim)
// row stride 1 and batch stride their row count, read in place.
//
// Compiles with nvcc and, against tests/cuda_emulation.h, as plain C++.
#pragma once

namespace {

constexpr double GRAVITY = 9.81;

// An input: its values, the step between its rows and the step between
// scenarios (0 where every scenario shares them).
template <typename T>
struct In {
  const T* p;
  long long rs, bs;
};

// A batch-last input laid out contiguous: its values, and the extent of its
// batch axis (B, or 1 when every scenario shares them), which is also the
// step between its rows (K2's staged inputs).
template <typename T>
struct View {
  const T* p;
  long long ld;
};

// One scenario's rows of an input in device memory: row i at p[i * ld].
template <typename T>
struct Col {
  const T* p;
  long long ld;
  __device__ __forceinline__ T operator[](long long i) const { return p[i * ld]; }
  __device__ __forceinline__ Col at(long long row) const { return Col{p + row * ld, ld}; }
};

template <typename T>
__device__ __forceinline__ Col<T> column(const In<T>& v, long long b) {
  return Col<T>{v.p + b * v.bs, v.rs};
}

template <typename T>
__device__ __forceinline__ Col<T> column(const View<T>& v, long long b) {
  return Col<T>{v.p + (v.ld == 1 ? 0 : b), v.ld};
}

// The inverse of a 3 x 3 matrix (row-major, at A) as the adjugate over the
// determinant, to inv (models/srb._inv3_bl).
template <typename T, typename R>
__device__ __forceinline__ void inverse3(const R& A_, T* inv) {
  const T A = A_[0], Bv = A_[1], C = A_[2], D = A_[3], E = A_[4], F = A_[5], G = A_[6],
          H = A_[7], I = A_[8];
  const T a11 = E * I - F * H, a12 = C * H - Bv * I, a13 = Bv * F - C * E;
  const T a21 = F * G - D * I, a22 = A * I - C * G, a23 = C * D - A * F;
  const T a31 = D * H - E * G, a32 = Bv * G - A * H, a33 = A * E - Bv * D;
  const T det = (A * a11 + Bv * a21) + C * a31;
  inv[0] = a11 / det, inv[1] = a12 / det, inv[2] = a13 / det;
  inv[3] = a21 / det, inv[4] = a22 / det, inv[5] = a23 / det;
  inv[6] = a31 / det, inv[7] = a32 / det, inv[8] = a33 / det;
}

}  // namespace
