// Device functions the closed loop's kernels share (K10, csrc/walking_pre.cu;
// K11, csrc/srb_post.cu): each computes what a function of the port's plain
// PyTorch computes, rounded as PyTorch rounds it on the card; and the
// shuffles of their four-lane layout. Built
// -fmad=false, a kernel writes out the fused multiply-adds PyTorch's kernels
// and cuBLAS make (`fma_`); libdevice's functions are called as PyTorch's
// kernels call them (the float overloads in f32); a Python number divides a
// tensor as a product with its reciprocal (`rcp`); each sum over a
// contiguous last axis follows PyTorch's reduction order for it (`tsum3`,
// `tsum4`, `tnorm3`, `tnorm4`); each einsum product follows the order cuBLAS
// takes at the call's batch size and type (`dot3`, `dot4` with an Order
// from the launch's orders word, two bits a product site).
//
// Compiles with nvcc and, against tests/cuda_emulation.h, as plain C++.
#pragma once

#ifndef __CUDACC__
#include <cmath>
#endif

namespace {

constexpr int FLAT = 0, SLOPE = 1, STAIRS = 2;

// libdevice's functions as PyTorch's kernels call them (the float overloads
// in f32), and the fused multiply-add the kernel writes out where PyTorch's
// kernels or cuBLAS fuse.
#ifdef __CUDACC__
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return __fma_rn(a, b, c); }
#else
inline float fma_(float a, float b, float c) { return std::fma(a, b, c); }
inline double fma_(double a, double b, double c) { return std::fma(a, b, c); }
using std::acos;
using std::asin;
using std::atan2;
using std::cos;
using std::fabs;
using std::floor;
using std::fmod;
using std::sin;
using std::sqrt;
#endif

// torch.clamp / clamp_min / clamp_max: a NaN passes through
template <typename T>
__device__ __forceinline__ T clampv(T x, T lo, T hi) {
  return x != x ? x : (x < lo ? lo : (x > hi ? hi : x));
}
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x != x ? x : (x < lo ? lo : x);
}
template <typename T>
__device__ __forceinline__ T clamp_max(T x, T hi) {
  return x != x ? x : (x > hi ? hi : x);
}
// torch.maximum / torch.minimum: a NaN wins
template <typename T>
__device__ __forceinline__ T maxv(T a, T b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T minv(T a, T b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}
// torch.sign: (0 < x) − (x < 0)
template <typename T>
__device__ __forceinline__ T signv(T x) {
  return T((T(0) < x) - (x < T(0)));
}
// torch.remainder of floats: fmod, moved into the divisor's sign
template <typename T>
__device__ __forceinline__ T remainderv(T a, T b) {
  T m = fmod(a, b);
  if (m != T(0) && ((b < T(0)) != (m < T(0)))) m = m + b;
  return m;
}
// 0 + x: what a reduction's accumulator holds after its first element
template <typename T>
__device__ __forceinline__ T z0(T x) {
  return T(0) + x;
}
// torch.sum over a contiguous last axis of 3 (its block is 2 lanes wide:
// lane 0 sums elements 0 and 2 in two accumulators, lane 1 element 1) and of
// 4 (4 lanes, a shuffle tree)
template <typename T>
__device__ __forceinline__ T tsum3(T a, T b, T c) {
  return (z0(a) + z0(c)) + z0(b);
}
template <typename T>
__device__ __forceinline__ T tsum4(T a, T b, T c, T d) {
  return (z0(a) + z0(c)) + (z0(b) + z0(d));
}
// torch.linalg.norm / vector_norm over 3 and 4: the same lanes, squares by
// fma(x, x, 0), the root of the sum
template <typename T>
__device__ __forceinline__ T tnorm3(T a, T b, T c) {
  return sqrt((a * a + c * c) + b * b);
}
template <typename T>
__device__ __forceinline__ T tnorm4(T a, T b, T c, T d) {
  return sqrt((a * a + c * c) + (b * b + d * d));
}

// The einsum products (cuBLAS on the card) of K terms a_k·b_k, each in the
// order cuBLAS takes it for the plain version at the call's batch size and
// type (found on an H100 by comparing each product of the plain version with
// candidate orders: k10_orders.py; the tables kernels/walking_pre.CUBLAS_ORDERS
// and kernels/srb_post.CUBLAS_ORDERS): a launch's `orders` word holds one
// Order a product site (each kernel's enum Site), two bits each.
// - CHAIN: one accumulator, fma(a_k, b_k, acc) for k = 1.. on a_0·b_0;
// - HALVES: the first ⌈K/2⌉ terms and the rest, each so, then added;
// - PARITY: the even and the odd k, each so, then added;
// - SUMS: each product rounded, then summed as torch.sum sums K values.
enum Order { CHAIN = 0, HALVES = 1, PARITY = 2, SUMS = 3 };

__device__ __forceinline__ int order_of(int orders, int site) {
  return (orders >> (2 * site)) & 3;
}

template <typename T>
__device__ __forceinline__ T dot3(int order, T a0, T b0, T a1, T b1, T a2, T b2) {
  if (order == HALVES) return fma_(a1, b1, a0 * b0) + a2 * b2;
  if (order == PARITY) return fma_(a2, b2, a0 * b0) + a1 * b1;
  if (order == SUMS) return tsum3(a0 * b0, a1 * b1, a2 * b2);
  return fma_(a2, b2, fma_(a1, b1, a0 * b0));
}
template <typename T>
__device__ __forceinline__ T dot4(int order, T a0, T b0, T a1, T b1, T a2, T b2, T a3, T b3) {
  if (order == HALVES) return fma_(a1, b1, a0 * b0) + fma_(a3, b3, a2 * b2);
  if (order == PARITY) return fma_(a2, b2, a0 * b0) + fma_(a3, b3, a1 * b1);
  if (order == SUMS) return tsum4(a0 * b0, a1 * b1, a2 * b2, a3 * b3);
  return fma_(a3, b3, fma_(a2, b2, fma_(a1, b1, a0 * b0)));
}

// M·v ("...ij,...j->...i") and Mᵀ·v ("...ji,...j->...i") of a row-major 3 x 3
template <typename T>
__device__ __forceinline__ void mv3(int order, const T* M, const T* v, T* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = dot3(order, M[3 * i], v[0], M[3 * i + 1], v[1], M[3 * i + 2], v[2]);
}
template <typename T>
__device__ __forceinline__ void mtv3(int order, const T* M, const T* v, T* out) {
  for (int i = 0; i < 3; ++i) out[i] = dot3(order, M[i], v[0], M[3 + i], v[1], M[6 + i], v[2]);
}

// lie.quat_to_rotmat, row-major
template <typename T>
__device__ __forceinline__ void quat_to_rotmat(const T* q, T* R) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T xx = x * x, yy = y * y, zz = z * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  const T xy = x * y, xz = x * z, yz = y * z;
  const T one = T(1);
  R[0] = one - T(2) * (yy + zz), R[1] = T(2) * (xy - wz), R[2] = T(2) * (xz + wy);
  R[3] = T(2) * (xy + wz), R[4] = one - T(2) * (xx + zz), R[5] = T(2) * (yz - wx);
  R[6] = T(2) * (xz - wy), R[7] = T(2) * (yz + wx), R[8] = one - T(2) * (xx + yy);
}

// lie.quat_to_euler: [roll, pitch, yaw]
template <typename T>
__device__ __forceinline__ void quat_to_euler(const T* q, T* e) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T ysqr = y * y;
  e[0] = atan2(T(2) * (w * x + y * z), T(1) - T(2) * (x * x + ysqr));
  e[1] = asin(clampv(T(2) * (w * y - z * x), T(-1), T(1)));
  e[2] = atan2(T(2) * (w * z + x * y), T(1) - T(2) * (ysqr + z * z));
}

// lie.euler_to_quat
template <typename T>
__device__ __forceinline__ void euler_to_quat(T roll, T pitch, T yaw, T* q) {
  const T r = roll * T(0.5), p = pitch * T(0.5), y = yaw * T(0.5);
  const T cr = cos(r), sr = sin(r), cp = cos(p), sp = sin(p), cy = cos(y), sy = sin(y);
  q[0] = cy * cp * cr + sy * sp * sr;
  q[1] = cy * cp * sr - sy * sp * cr;
  q[2] = cy * sp * cr + sy * cp * sr;
  q[3] = sy * cp * cr - cy * sp * sr;
}

// lie.rotz, row-major, built as the plain version stacks it
template <typename T>
__device__ __forceinline__ void rotz(T yaw, T* Rz) {
  const T c = cos(yaw), s = sin(yaw), o = T(0), one = T(1);
  Rz[0] = c, Rz[1] = -s, Rz[2] = o;
  Rz[3] = s, Rz[4] = c, Rz[5] = o;
  Rz[6] = o, Rz[7] = o, Rz[8] = one;
}

// sim.terrain.height
template <typename T>
__device__ __forceinline__ T terrain_height(int kind, T grade, T rise, T run, T x) {
  const T xc = clamp_min(x, T(0));
  const T slope_z = grade * xc;
  const T n_step = floor(xc / run);
  const T stairs_z = rise * n_step * T(x > T(0));
  return kind == FLAT ? T(0) : (kind == SLOPE ? slope_z : stairs_z);
}

// 1 / c of a Python number c, computed in double and rounded to T: PyTorch's
// CUDA division of a tensor by a host scalar multiplies by it (x / c is
// x · rcp(c))
template <typename T>
__device__ __forceinline__ T rcp(double c) {
  return T(1.0 / c);
}

// The four-lane layout of K10 and K11: a scenario's group of GROUP lanes
// (lane g its leg, or foot, g), SCENARIOS groups a warp.
constexpr int GROUP = 4;
constexpr int SCENARIOS = 32 / GROUP;  // a warp's
#ifdef __CUDACC__
constexpr unsigned FULL = 0xffffffffu;
#else
constexpr unsigned FULL = 0;
#endif

// Shuffles inside a scenario's group of GROUP lanes: from its lane j, and
// down by `off` (a lane past the group's end keeps its own value).
template <typename T>
__device__ __forceinline__ T gshfl(T v, int j) {
  return __shfl_sync(FULL, v, j, GROUP);
}
template <typename T>
__device__ __forceinline__ T gshfl_down(T v, int off) {
#ifdef __CUDACC__
  return __shfl_down_sync(FULL, v, off, GROUP);
#else
  const int j = static_cast<int>(threadIdx.x) & (GROUP - 1);
  return __shfl_sync(FULL, v, j + off < GROUP ? j + off : j, GROUP);
#endif
}

// v[i] of a small array held in registers, for an index i known at run time
// (a chain of selects: indexing it would put the array in local memory)
template <int N, typename V>
__device__ __forceinline__ V sel(const V (&v)[N], int i) {
  V r = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k) r = i == k ? v[k] : r;
  return r;
}

}  // namespace
