// x ** e per lane, correctly rounded, for the fused ODE controllers.
//
// Not a port of a TPU kernel. The fused Radau5 and ERK loops
// (russell_tpu_torch/ode/radau5_fused.py, erk_fused.py) run on the card
// the step-size and Newton control that the host-stepped path computes
// in Python floats, whose ** is the C library's pow: correctly rounded
// but for rare near-halfway results. CUDA's pow is within 2 ulp and often
// differs from it in the last bit (chip_smoke.py's fused_path phase
// counts how often), and near the explicit methods' stability limit the
// error controller amplifies such last-bit differences in h into y. This
// kernel evaluates exp(e * log x) in double-double arithmetic (about 95
// correct bits after the squarings), then rounds once, so its result is
// the correctly rounded x ** e except when that lies within ~2^-95 of a
// halfway point.
//
// What bounds it: nothing on the card; it runs on a handful of lanes
// (one thread each), once or twice per step attempt.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct dd {
  double hi, lo;
};

__device__ __forceinline__ dd two_sum(double a, double b) {
  const double s = a + b;
  const double bb = s - a;
  return {s, (a - (s - bb)) + (b - bb)};
}

__device__ __forceinline__ dd quick_two_sum(double a, double b) {
  const double s = a + b;
  return {s, b - (s - a)};
}

__device__ __forceinline__ dd dd_add(dd a, dd b) {
  dd s = two_sum(a.hi, b.hi);
  const dd t = two_sum(a.lo, b.lo);
  s.lo += t.hi;
  s = quick_two_sum(s.hi, s.lo);
  s.lo += t.lo;
  return quick_two_sum(s.hi, s.lo);
}

__device__ __forceinline__ dd dd_mul(dd a, dd b) {
  const double p = a.hi * b.hi;
  double e = fma(a.hi, b.hi, -p);
  e += a.hi * b.lo + a.lo * b.hi;
  return quick_two_sum(p, e);
}

__device__ __forceinline__ dd dd_mul_d(dd a, double b) {
  const double p = a.hi * b;
  double e = fma(a.hi, b, -p);
  e += a.lo * b;
  return quick_two_sum(p, e);
}

__device__ dd dd_div(dd a, dd b) {
  const double q1 = a.hi / b.hi;
  dd r = dd_add(a, dd_mul_d(b, -q1));
  const double q2 = r.hi / b.hi;
  r = dd_add(r, dd_mul_d(b, -q2));
  const double q3 = r.hi / b.hi;
  return dd_add(quick_two_sum(q1, q2), dd{q3, 0.0});
}

// ln 2 to 106 bits
__device__ __constant__ double kLn2Hi = 6.931471805599452862e-01;
__device__ __constant__ double kLn2Lo = 2.319046813846299558e-17;

// log x for a finite x > 0: x = m 2^k with m in [sqrt(1/2), sqrt(2)),
// log m = 2 atanh(s), s = (m - 1) / (m + 1), |s| <= 0.1716, the series
// summed to s^49 (s^2 <= 0.0295: the next term is below 2^-120)
__device__ dd log_dd(double x) {
  int k;
  double m = frexp(x, &k);
  if (m < 0.70710678118654752440) {
    m *= 2.0;
    k -= 1;
  }
  // m - 1 is exact (Sterbenz); m + 1 is kept to 106 bits
  const dd s = dd_div(dd{m - 1.0, 0.0}, two_sum(m, 1.0));
  const dd s2 = dd_mul(s, s);
  dd p = dd_div(dd{1.0, 0.0}, dd{49.0, 0.0});
  for (int j = 23; j >= 0; --j) {
    p = dd_add(dd_mul(p, s2), dd_div(dd{1.0, 0.0}, dd{2.0 * j + 1.0, 0.0}));
  }
  dd lm = dd_mul(s, p);
  lm.hi *= 2.0;
  lm.lo *= 2.0;
  return dd_add(dd_mul_d(dd{kLn2Hi, kLn2Lo}, static_cast<double>(k)), lm);
}

// exp a for |a| < 709: a = k ln 2 + r, |r| <= ln 2 / 2, then
// expm1(r / 512) by its Taylor series (|r / 512| < 6.8e-4, 13 terms)
// and nine squarings through expm1 (2 e + e^2), which keep its
// relative precision
__device__ dd exp_dd(dd a) {
  const double k = floor(a.hi / kLn2Hi + 0.5);
  dd r = dd_add(a, dd_mul_d(dd{kLn2Hi, kLn2Lo}, -k));
  r.hi = ldexp(r.hi, -9);
  r.lo = ldexp(r.lo, -9);
  dd q = {1.0, 0.0};
  for (int n = 13; n >= 2; --n) {
    q = dd_add(dd{1.0, 0.0},
               dd_div(dd_mul(q, r), dd{static_cast<double>(n), 0.0}));
  }
  dd e = dd_mul(q, r);
  for (int i = 0; i < 9; ++i) {
    e = dd_add(dd_mul_d(e, 2.0), dd_mul(e, e));
  }
  dd v = dd_add(dd{1.0, 0.0}, e);
  const int ki = static_cast<int>(k);
  return {ldexp(v.hi, ki), ldexp(v.lo, ki)};
}

__global__ void pow_cr_kernel(const double* __restrict__ x, double e, int n,
                              double* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double b = x[i];
  double r;
  if (e == 0.0 || b == 1.0) {
    r = 1.0;
  } else if (e == 1.0) {
    r = b;
  } else if (!(b > 0.0) || isinf(b) || isinf(e) || isnan(e)) {
    r = pow(b, e);  // zero, negative, inf and nan: the C library's cases
  } else {
    const dd l = dd_mul_d(log_dd(b), e);
    if (fabs(l.hi) > 700.0) {
      r = pow(b, e);  // overflow and the subnormal range
    } else {
      const dd v = exp_dd(l);
      r = v.hi + v.lo;
    }
  }
  out[i] = r;
}

}  // namespace

// out[i] = x[i] ** e for n contiguous doubles, on `stream`. Returns a
// cudaError_t code.
extern "C" int pow_cr_f64(const void* x, double e, int n, void* out,
                          void* stream) {
  if (n <= 0) return cudaSuccess;
  const int threads = 64;
  pow_cr_kernel<<<(n + threads - 1) / threads, threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), e, n, static_cast<double*>(out));
  return cudaGetLastError();
}
