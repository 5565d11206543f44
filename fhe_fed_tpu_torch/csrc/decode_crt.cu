// Kernel K4: exact-CRT CKKS decode, residues (chunks, live, N) int32 ->
// values (chunks, N) float32.
//
// Replaces fhe_fed_tpu/ckks/pallas_decode.py::_kernel (reached through
// decode_fused), which runs ckks/encoding.py::decode_core:
//   1. y_l = x_l * (Q/q_l)^-1 mod q_l;
//   2. k = round(sum_l y_l / q_l) in f32;
//   3. sum_l y_l * (Q/q_l) in base-2^16 digit planes;
//   4. subtract k*Q, take the sign and the magnitude's digits;
//   5. divide by the scale in two-float (f32 hi, lo) arithmetic.
// The integer steps follow decode_core's digit-plane formulas (any exact
// method gives the same digits: v is unique). The float tail follows
// _planes_to_f32 operation for operation: the same order of df_add_f32
// over the digits, the same overflow rule (digit weight above 2^127 ->
// inf), the same df_mul by the two-float 2^e/scale, rintf for round-half-
// even. Every float operation is written with __fadd_rn / __fsub_rn /
// __fmul_rn, which nvcc never contracts into an FMA: a fused a*b+c would
// break Dekker's two_prod and with it the bit-exactness.
//
// What bounds it: per element it reads live*4 bytes and writes 4, and does
// ~live*ndig 16-bit products and ~60 f32 operations, all in registers: it
// is a memory-bound elementwise pass, where the plain PyTorch version
// makes some 40 separate passes over full-size int64 temporaries. Design:
// one thread per coefficient; threads of a warp read neighbouring
// coefficients of each limb (coalesced, N apart per limb); the digit
// arrays are fixed-size per live-limb count (a template), so they stay in
// registers; the constants are a by-value kernel argument (constant bank).

#include <cmath>
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kMaxLive = 16;
constexpr int kMaxDig = 34;      // ndig <= 2*live + 2
constexpr int kThreads = 256;

struct DecConsts {               // host layout: 714 four-byte words
  int32_t live, nd;
  uint32_t q[kMaxLive];
  uint32_t pinv[kMaxLive];       // (Q/q_l)^-1 mod q_l
  uint32_t pinv_shoup[kMaxLive];
  float invq[kMaxLive];          // f32(1/q_l)
  uint32_t mdig[kMaxLive][kMaxDig];  // 16-bit digits of Q/q_l
  uint32_t qdig[kMaxDig];        // 16-bit digits of Q
  float tw[kMaxDig];             // f32(2^(16d - e))
  int32_t use[kMaxDig];          // 0 where 16d - e > 127 (overflow digit)
  float c_hi, c_lo;              // two-float 2^e / scale
};

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void fast_two_sum(float a, float b, float& s,
                                             float& e) {
  s = __fadd_rn(a, b);
  e = __fsub_rn(b, __fsub_rn(s, a));
}

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float c = __fmul_rn(4097.0f, a);
  hi = __fsub_rn(c, __fsub_rn(c, a));
  lo = __fsub_rn(a, hi);
}

__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  float ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  e = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p),
                                    __fmul_rn(ah, bl)),
                          __fmul_rn(al, bh)),
                __fmul_rn(al, bl));
}

__device__ __forceinline__ void df_add_f32(float& hi, float& lo, float y) {
  float s, e;
  two_sum(hi, y, s, e);
  e = __fadd_rn(e, lo);
  fast_two_sum(s, e, hi, lo);
}

__device__ __forceinline__ void df_mul(float& hi, float& lo, float yh,
                                       float yl) {
  float p, e;
  two_prod(hi, yh, p, e);
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(hi, yl), __fmul_rn(lo, yh)));
  fast_two_sum(p, e, hi, lo);
}

template <int LIVE>
__global__ void __launch_bounds__(kThreads)
decode_kernel(float* __restrict__ out, const int32_t* __restrict__ x,
              const DecConsts c, long long total, int n) {
  constexpr int ND = 2 * LIVE + 2;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long chunk = idx / n;
  const int col = (int)(idx - chunk * n);
  const int nd = c.nd;
  const int32_t* xc = x + chunk * LIVE * n + col;

  uint32_t y[LIVE];
  float fsum = 0.0f;
#pragma unroll
  for (int l = 0; l < LIVE; ++l) {
    y[l] = mul_mod_shoup((uint32_t)__ldg(xc + (size_t)l * n), c.pinv[l],
                         c.pinv_shoup[l], c.q[l]);
    fsum = __fadd_rn(fsum, __fmul_rn((float)(int32_t)y[l], c.invq[l]));
  }
  const int32_t k = (int32_t)rintf(fsum);

  // sum_l y_l * (Q/q_l) in 16-bit digit planes (each < 2^30).
  uint32_t pl[ND + 2];
#pragma unroll
  for (int d = 0; d < ND + 2; ++d) pl[d] = 0;
#pragma unroll
  for (int l = 0; l < LIVE; ++l) {
    const uint32_t ylo = y[l] & 0xFFFFu, yhi = y[l] >> 16;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      if (d < nd) {
        const uint32_t m = c.mdig[l][d];
        const uint32_t p1 = ylo * m;
        pl[d] += p1 & 0xFFFFu;
        uint32_t p2 = 0;
        if (d + 1 < nd) {
          pl[d + 1] += p1 >> 16;
          p2 = yhi * m;
          pl[d + 1] += p2 & 0xFFFFu;
        }
        if (d + 2 < nd) pl[d + 2] += p2 >> 16;
      }
    }
  }

  // w = acc + Q - k*Q (k*Q's digits non-normalised; the carry renormalises).
  int32_t od[ND], mag[ND];
  int32_t carry = 0;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    if (d < nd) {
      const int32_t qd = (int32_t)c.qdig[d];
      const int32_t r = (int32_t)pl[d] + qd - k * qd + carry;
      od[d] = r & 0xFFFF;
      carry = r >> 16;
    }
  }
  // v = w - Q with borrow; the final borrow is the sign of v.
  int32_t borrow = 0;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    if (d < nd) {
      const int32_t r = od[d] - (int32_t)c.qdig[d] + borrow;
      od[d] = r & 0xFFFF;
      borrow = r >> 16;
    }
  }
  const bool neg = borrow < 0;
  carry = neg ? 1 : 0;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    if (d < nd) {
      const int32_t t = (neg ? 0xFFFF - od[d] : od[d]) + carry;
      mag[d] = t & 0xFFFF;
      carry = t >> 16;
    }
  }

  float hi = 0.0f, lo = 0.0f;
  bool overflow = false;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    if (d < nd) {
      if (!c.use[d]) {
        overflow = overflow || mag[d] > 0;
      } else {
        df_add_f32(hi, lo, __fmul_rn((float)mag[d], c.tw[d]));
      }
    }
  }
  if (overflow) hi = INFINITY;
  df_mul(hi, lo, c.c_hi, c.c_lo);
  out[idx] = __fmul_rn(__fadd_rn(hi, lo), neg ? -1.0f : 1.0f);
}

template <int LIVE>
int launch(float* out, const int32_t* x, const DecConsts& c, int chunks, int n,
           cudaStream_t stream) {
  const long long total = (long long)chunks * n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  decode_kernel<LIVE><<<(unsigned)blocks, kThreads, 0, stream>>>(out, x, c,
                                                                 total, n);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (chunks, live, n) int32; out: (chunks, n) float32; consts: host
// DecConsts with 1 <= live <= 16 and nd <= 2*live + 2.
extern "C" int fhe_decode_crt(void* out, const void* x, const void* consts,
                              int chunks, int n, void* stream) {
  DecConsts c;
  std::memcpy(&c, consts, sizeof(c));
  float* o = (float*)out;
  const int32_t* xi = (const int32_t*)x;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c.live) {
    case 1: return launch<1>(o, xi, c, chunks, n, s);
    case 2: return launch<2>(o, xi, c, chunks, n, s);
    case 3: return launch<3>(o, xi, c, chunks, n, s);
    case 4: return launch<4>(o, xi, c, chunks, n, s);
    case 5: return launch<5>(o, xi, c, chunks, n, s);
    case 6: return launch<6>(o, xi, c, chunks, n, s);
    case 7: return launch<7>(o, xi, c, chunks, n, s);
    case 8: return launch<8>(o, xi, c, chunks, n, s);
    case 9: return launch<9>(o, xi, c, chunks, n, s);
    case 10: return launch<10>(o, xi, c, chunks, n, s);
    case 11: return launch<11>(o, xi, c, chunks, n, s);
    case 12: return launch<12>(o, xi, c, chunks, n, s);
    case 13: return launch<13>(o, xi, c, chunks, n, s);
    case 14: return launch<14>(o, xi, c, chunks, n, s);
    case 15: return launch<15>(o, xi, c, chunks, n, s);
    case 16: return launch<16>(o, xi, c, chunks, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
