// Kernel K1: forward and inverse negacyclic NTT as a four-step transform
// in signed base-256 digit planes, on the int8 tensor cores.
//
// Replaces fhe_fed_tpu/ntt/mxu_pallas.py::_kernel (reached through _call,
// ntt_mxu_fused and intt_mxu_fused). Same tables (ntt/mxu.py), same digit
// split (_digits_flat) and reassembly (_reassemble_flat), so the output is
// bit-identical to the butterfly ntt.ntt / ntt.intt, in bit-reversed order.
//
// What bounds it: integer products. Per (poly, limb) at N = 8192 the two
// stages are a 128x256x256 and a 64x512x512 int8 product (25 M MACs),
// against 64 KB of device memory read and written, so it is far above the
// card's bytes-per-op line and runs on the tensor cores (mma.sync
// m16n8k32 s8.s8.s32). Design:
//   * one thread block per (poly, limb): 2,448 blocks in the bench encrypt,
//     816 in its decrypt, enough to fill 132 SMs;
//   * the 32 KB polynomial and its 32 KB of int8 digits live in shared
//     memory; both transposes of the four-step are done by indexing when the
//     digits are written, never by copies; the polynomial is read and
//     written once, with 16-byte accesses;
//   * each warp owns 8 output columns of all four output planes for up to
//     four 16-row tiles, so the four plane sums of an output element meet
//     in one thread's registers and are reassembled there;
//   * the DFT matrix of a stage (256 KB per limb for the 512-wide stage,
//     more than a block's 227 KB of shared memory) is never staged whole:
//     each B fragment is read from L2 (all limbs' tables are ~3 MB) in its
//     n-major copy (the `*_nk` tables), and reused across the warp's four
//     row tiles, so each block reads each matrix at most twice;
//   * digit rows are padded by 16 bytes, so the A-fragment loads are free of
//     shared-memory bank conflicts.
// Not yet done: wgmma, TMA, and staging B in shared memory in K-tiles.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kMaxLimbs = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 16;        // bytes appended to each digit row
constexpr uint32_t kOff = 1u << 24;

struct LimbConsts {             // host layout: uint32[4][kMaxLimbs]
  uint32_t q[kMaxLimbs];
  uint32_t c32[kMaxLimbs];      // 2^32 mod q
  uint32_t c32_shoup[kMaxLimbs];
  uint32_t offm[kMaxLimbs];     // 2^24 * (1 + 2^8 + 2^16 + 2^24) mod q
};

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The four signed base-256 digits of the centred residue x' = x - q*(x > q/2),
// written at row[i*S + s] (i-major, the row layout of the DFT matrix).
__device__ __forceinline__ void put_digits(uint32_t x, uint32_t q, int8_t* row,
                                           int S, int s) {
  int32_t xs = (int32_t)x - (x > (q >> 1) ? (int32_t)q : 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int32_t d = ((xs + 128) & 255) - 128;
    row[i * S + s] = (int8_t)d;
    xs = (xs - d) >> 8;
  }
}

// (sum_j 2^(8j) P_j) mod q from four plane sums |P_j| <= 2^23.
__device__ __forceinline__ uint32_t reassemble(int32_t p0, int32_t p1,
                                               int32_t p2, int32_t p3,
                                               const uint32_t q,
                                               const uint32_t c32,
                                               const uint32_t c32s,
                                               const uint32_t offm) {
  const uint32_t u0 = (uint32_t)p0 + kOff, u1 = (uint32_t)p1 + kOff;
  const uint32_t u2 = (uint32_t)p2 + kOff, u3 = (uint32_t)p3 + kOff;
  const uint32_t lo = u0 + (u1 << 8);
  uint32_t c = lo < u0;
  const uint32_t lo2 = lo + (u2 << 16);
  c += lo2 < lo;
  const uint32_t lo3 = lo2 + (u3 << 24);
  c += lo3 < lo2;
  const uint32_t hi = (u1 >> 24) + (u2 >> 16) + (u3 >> 8) + c;
  const uint32_t r1 = mul_mod_shoup(hi, c32, c32s, q);
  uint32_t r2 = lo3 >= (q << 1) ? lo3 - (q << 1) : lo3;
  r2 = r2 >= q ? r2 - q : r2;
  r2 = r2 >= q ? r2 - q : r2;
  return sub_mod(add_mod(r1, r2, q), offm, q);
}

// C = A . W for A the (R x 4S) int8 digits in shared memory (row stride
// lda bytes) and W given n-major as wt[(j*S + t) * 4S + k]. Calls
// epi(row, t, P_0, P_1, P_2, P_3) once for every output element.
template <typename Epilogue>
__device__ __forceinline__ void digit_gemm(const int8_t* A, int lda,
                                           const int8_t* __restrict__ wt,
                                           int S, int R, Epilogue epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int K4 = 4 * S;
  const int ttiles = S >> 3;
  const int mtiles = R >> 4;
  const int ntasks = ttiles * ((mtiles + 3) >> 2);
  for (int task = warp; task < ntasks; task += kWarps) {
    const int t0 = (task % ttiles) * 8;
    const int m0 = (task / ttiles) * 4;
    const int mt = min(4, mtiles - m0);
    int32_t acc[4][4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[m][j][r] = 0;
    const int8_t* wrow[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wrow[j] = wt + (size_t)(j * S + t0 + g) * K4 + tq * 4;
    const int8_t* arow = A + (size_t)(m0 * 16 + g) * lda + tq * 4;
#pragma unroll 2
    for (int kb = 0; kb < K4; kb += 32) {
      uint32_t b0[4], b1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b0[j] = __ldg(reinterpret_cast<const unsigned int*>(wrow[j] + kb));
        b1[j] = __ldg(reinterpret_cast<const unsigned int*>(wrow[j] + kb + 16));
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m < mt) {
          const int8_t* ar = arow + (size_t)m * 16 * lda + kb;
          const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ar);
          const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ar + 8 * lda);
          const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ar + 16);
          const uint32_t a3 =
              *reinterpret_cast<const uint32_t*>(ar + 8 * lda + 16);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_s8(acc[m][j], a0, a1, a2, a3, b0[j], b1[j]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (m < mt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = (m0 + m) * 16 + g + 8 * (r >> 1);
          const int t = t0 + tq * 2 + (r & 1);
          epi(row, t, acc[m][0][r], acc[m][1][r], acc[m][2][r], acc[m][3][r]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ntt_mxu_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x,
               const int8_t* __restrict__ w1, const int8_t* __restrict__ w2,
               const int32_t* __restrict__ mid,
               const int64_t* __restrict__ mid_shoup, const LimbConsts kc,
               int L, int n1, int n2, int forward) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = n1 * n2;
  uint32_t* X = reinterpret_cast<uint32_t*>(smem);
  int8_t* D = reinterpret_cast<int8_t*>(smem + (size_t)n * 4);
  const int l = blockIdx.x % L;
  const uint32_t q = kc.q[l], c32 = kc.c32[l], c32s = kc.c32_shoup[l];
  const uint32_t offm = kc.offm[l];
  const size_t base = (size_t)blockIdx.x * n;          // (B, L, N) layout
  const int32_t* mid_l = mid + (size_t)l * n;
  const int64_t* mids_l = mid_shoup + (size_t)l * n;
  const int8_t* w1_l = w1 + (size_t)l * 16 * n1 * n1;
  const int8_t* w2_l = w2 + (size_t)l * 16 * n2 * n2;

  for (int i = threadIdx.x * 4; i < n; i += kThreads * 4)
    *reinterpret_cast<uint4*>(X + i) =
        *reinterpret_cast<const uint4*>(x + base + i);
  __syncthreads();

  auto reasm = [&](int32_t p0, int32_t p1, int32_t p2, int32_t p3) {
    return reassemble(p0, p1, p2, p3, q, c32, c32s, offm);
  };
  auto twiddle = [&](uint32_t v, int idx) {
    return mul_mod_shoup(v, (uint32_t)mid_l[idx], (uint32_t)mids_l[idx], q);
  };

  // x[a*n2 + b] is the (a, b) entry of an n1 x n2 matrix.
  if (forward) {
    // Column DFTs: digit row b holds column b (contract a, length n1).
    const int lda = 4 * n1 + kPad;
    for (int i = threadIdx.x; i < n; i += kThreads)
      put_digits(X[i], q, D + (size_t)(i % n2) * lda, n1, i / n2);
    __syncthreads();
    digit_gemm(D, lda, w1_l, n1, n2,
               [&](int b, int t, int32_t p0, int32_t p1, int32_t p2, int32_t p3) {
                 const int idx = t * n2 + b;
                 X[idx] = twiddle(reasm(p0, p1, p2, p3), idx);
               });
    __syncthreads();
    // Row DFTs: digit row t holds row t (contract b, length n2).
    const int lda2 = 4 * n2 + kPad;
    for (int i = threadIdx.x; i < n; i += kThreads)
      put_digits(X[i], q, D + (size_t)(i / n2) * lda2, n2, i % n2);
    __syncthreads();
    digit_gemm(D, lda2, w2_l, n2, n1,
               [&](int t, int c, int32_t p0, int32_t p1, int32_t p2, int32_t p3) {
                 X[t * n2 + c] = reasm(p0, p1, p2, p3);
               });
  } else {
    // Row DFTs first: digit row a holds row a (contract b, length n2).
    const int lda = 4 * n2 + kPad;
    for (int i = threadIdx.x; i < n; i += kThreads)
      put_digits(X[i], q, D + (size_t)(i / n2) * lda, n2, i % n2);
    __syncthreads();
    digit_gemm(D, lda, w2_l, n2, n1,
               [&](int a, int c, int32_t p0, int32_t p1, int32_t p2, int32_t p3) {
                 const int idx = a * n2 + c;
                 X[idx] = twiddle(reasm(p0, p1, p2, p3), idx);
               });
    __syncthreads();
    // Column DFTs: digit row c holds column c (contract a, length n1).
    const int lda2 = 4 * n1 + kPad;
    for (int i = threadIdx.x; i < n; i += kThreads)
      put_digits(X[i], q, D + (size_t)(i % n2) * lda2, n1, i / n2);
    __syncthreads();
    digit_gemm(D, lda2, w1_l, n1, n2,
               [&](int c, int t, int32_t p0, int32_t p1, int32_t p2, int32_t p3) {
                 X[t * n2 + c] = reasm(p0, p1, p2, p3);
               });
  }
  __syncthreads();
  for (int i = threadIdx.x * 4; i < n; i += kThreads * 4)
    *reinterpret_cast<uint4*>(out + base + i) =
        *reinterpret_cast<const uint4*>(X + i);
}

}  // namespace

// x, out: (B, L, N) int32, N = n1*n2 with n1, n2 multiples of 16, <= 128.
// w1: (L, 4*n1, 4*n1) int8 n-major, w2: (L, 4*n2, 4*n2), mid: (L, N) int32,
// mid_shoup: (L, N) int64; limb_consts: host uint32[4][16].
extern "C" int fhe_ntt_mxu(void* out, const void* x, const void* w1,
                           const void* w2, const void* mid,
                           const void* mid_shoup, const void* limb_consts,
                           int B, int L, int n1, int n2, int forward,
                           void* stream) {
  LimbConsts kc;
  std::memcpy(&kc, limb_consts, sizeof(kc));
  const int n = n1 * n2;
  const size_t smem = (size_t)8 * n + (size_t)kPad * (n1 > n2 ? n1 : n2);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ntt_mxu_kernel<<<B * L, kThreads, smem, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)x, (const int8_t*)w1, (const int8_t*)w2,
      (const int32_t*)mid, (const int64_t*)mid_shoup, kc, L, n1, n2, forward);
  return (int)cudaGetLastError();
}
