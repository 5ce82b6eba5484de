// The value types of the BSR kernels (bsr_spmv.cu, bsr_spmm.cu,
// spgemm_blocks.cu): double, and complex128 as double2 (x real, y
// imaginary; cuDoubleComplex's layout, 16 bytes). Each kernel is a
// template over the value type; these overloads give it the arithmetic.
//
// Complex products are written out as (ar br - ai bi, ar bi + ai br):
// vfma with explicit FMAs into the accumulator, the real part's terms in
// that order; vmul_rn with every product and sum rounded apart, as the real
// kernels' __dmul_rn / __dadd_rn. Sums run over the same entries in the
// same fixed order as the real kernels.

#pragma once

#include <cuda_runtime.h>

template <typename T>
__device__ __forceinline__ T vzero();
template <>
__device__ __forceinline__ double vzero<double>() {
  return 0.0;
}
template <>
__device__ __forceinline__ double2 vzero<double2>() {
  return make_double2(0.0, 0.0);
}

// acc + a * b
__device__ __forceinline__ double vfma(double a, double b, double acc) {
  return fma(a, b, acc);
}
__device__ __forceinline__ double2 vfma(double2 a, double2 b, double2 acc) {
  acc.x = fma(a.x, b.x, acc.x);
  acc.x = fma(-a.y, b.y, acc.x);
  acc.y = fma(a.x, b.y, acc.y);
  acc.y = fma(a.y, b.x, acc.y);
  return acc;
}

// a * b and a + b, each product and sum rounded apart (no contraction)
__device__ __forceinline__ double vmul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double2 vmul_rn(double2 a, double2 b) {
  return make_double2(__dsub_rn(__dmul_rn(a.x, b.x), __dmul_rn(a.y, b.y)),
                      __dadd_rn(__dmul_rn(a.x, b.y), __dmul_rn(a.y, b.x)));
}
__device__ __forceinline__ double vadd_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double2 vadd_rn(double2 a, double2 b) {
  return make_double2(__dadd_rn(a.x, b.x), __dadd_rn(a.y, b.y));
}

// a load through the read-only path
__device__ __forceinline__ double vldg(const double* p) { return __ldg(p); }
__device__ __forceinline__ double2 vldg(const double2* p) {
  return __ldg(p);
}

// a load of a value used once: non-coherent, not allocated in L1
__device__ __forceinline__ double load_once(const double* p) {
  double v;
  asm("ld.global.nc.L1::no_allocate.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ double2 load_once(const double2* p) {
  double2 v;
  asm("ld.global.nc.L1::no_allocate.v2.f64 {%0, %1}, [%2];"
      : "=d"(v.x), "=d"(v.y)
      : "l"(p));
  return v;
}
__device__ __forceinline__ int load_once(const int* p) {
  int v;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// __shfl_sync of a value
__device__ __forceinline__ double vshfl(unsigned mask, double v, int src,
                                        int width) {
  return __shfl_sync(mask, v, src, width);
}
__device__ __forceinline__ double2 vshfl(unsigned mask, double2 v, int src,
                                         int width) {
  return make_double2(__shfl_sync(mask, v.x, src, width),
                      __shfl_sync(mask, v.y, src, width));
}
