// Kernel K2: forward and inverse negacyclic NTT as the full radix-2
// butterfly network, all log2(N) stages in one pass.
//
// Replaces fhe_fed_tpu/ntt/pallas_ntt.py::_fwd_kernel and ::_inv_kernel
// (reached through _fused, ntt_fused and intt_fused). Written from what they
// compute, not block by block: the Cooley-Tukey forward network with tree-
// order twiddles tab[m + i] (stage of m blocks of span t), the
// Gentleman-Sande inverse with itab[h + i], and N^-1 applied at the end.
// Every step is exact on canonical residues, so the output equals the plain
// butterfly (ntt/ntt.py ntt_butterfly / intt_butterfly), the JAX ntt.ntt
// and kernel K1 bit for bit. The TPU kernel's transposed phase B only
// rearranges its (8, 128) lanes and has no counterpart here.
//
// Design:
//   * one thread block per (poly, limb) of a (B, L, N) int32 batch; the
//     whole polynomial stays in dynamic shared memory for all stages (128 KB
//     at N = 32768, of the 227 KB a block may have), so each coefficient is
//     read from and written to device memory once, the saving the Pallas
//     kernel makes in VMEM. Loads and stores are 16 bytes a thread,
//     neighbouring threads on neighbouring addresses;
//   * each stage runs N/2 Shoup butterflies spread over up to 1024 threads,
//     then __syncthreads();
//   * a twiddle and the low 32 bits of its Shoup word (w < q < 2^31, so the
//     word is < 2^32) come as one 8-byte __ldg from the (L, N, 2) int32
//     copy in ntt/tables.py (tw_fwd / tw_inv); 9 limbs of both directions
//     are ~5 MB and stay in the 50 MB L2;
//   * the inverse multiplies by N^-1 as it stores.
//
// What bounds it on an H100: at the rotation path's shapes, (1, 8, 9, 32768)
// forward and (1, 8, 32768) inverse, there are 72 (or 64) polynomials for
// 132 SMs, one 128 KB block per SM, and 15 barrier-separated stages of
// 16 butterflies a thread: it is bound by latency and barriers, not by
// device-memory bytes (9.4 MB in and out, ~3 us at 3.35 TB/s). Stages of
// span t < 32 also see 2-way shared-memory bank conflicts. Left for later:
// registers and warp shuffles for the last five stages, a 2-SM cluster
// sharing distributed shared memory, and one kernel that fuses the key
// switch's intt -> lift -> ntt.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kMaxLimbs = 64;
constexpr int kMaxThreads = 1024;
constexpr int kMinRing = 256;
constexpr int kMaxRing = 32768;

struct NttConsts {               // host layout: uint32[3][kMaxLimbs]
  uint32_t q[kMaxLimbs];
  uint32_t ninv[kMaxLimbs];      // N^-1 mod q
  uint32_t ninv_shoup[kMaxLimbs];
};

template <bool kForward>
__global__ void __launch_bounds__(kMaxThreads)
ntt_butterfly_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x,
                     const uint2* __restrict__ tw, const NttConsts c, int L,
                     int log_n) {
  extern __shared__ __align__(16) uint32_t s[];
  const int n = 1 << log_n;
  const int half = n >> 1;
  const long long poly = blockIdx.x;
  const int l = (int)(poly % L);
  const uint32_t q = c.q[l];
  const uint2* twl = tw + (size_t)l * n;

  const uint4* src = reinterpret_cast<const uint4*>(x + poly * n);
  uint4* s4 = reinterpret_cast<uint4*>(s);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) s4[i] = __ldg(src + i);
  __syncthreads();

  uint4* dst = reinterpret_cast<uint4*>(out + poly * n);
  if (kForward) {
    // Stage of m blocks of span t = 2^log_t: butterfly j pairs
    // i0 = 2*t*(j/t) + j%t with i0 + t under twiddle tab[m + j/t].
    int log_t = log_n - 1;
    for (int m = 1; m < n; m <<= 1, --log_t) {
      const int tmask = (1 << log_t) - 1;
      for (int j = threadIdx.x; j < half; j += blockDim.x) {
        const int i = j >> log_t;
        const int i0 = (i << (log_t + 1)) + (j & tmask);
        const int i1 = i0 + (1 << log_t);
        const uint2 w = __ldg(twl + m + i);
        const uint32_t u = s[i0];
        const uint32_t v = mul_mod_shoup(s[i1], w.x, w.y, q);
        s[i0] = add_mod(u, v, q);
        s[i1] = sub_mod(u, v, q);
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) dst[i] = s4[i];
  } else {
    // Stage of h blocks of span t = 2^log_t, t = 1 .. N/2, twiddle
    // itab[h + j/t].
    int log_t = 0;
    for (int h = half; h >= 1; h >>= 1, ++log_t) {
      const int tmask = (1 << log_t) - 1;
      for (int j = threadIdx.x; j < half; j += blockDim.x) {
        const int i = j >> log_t;
        const int i0 = (i << (log_t + 1)) + (j & tmask);
        const int i1 = i0 + (1 << log_t);
        const uint2 w = __ldg(twl + h + i);
        const uint32_t x0 = s[i0];
        const uint32_t x1 = s[i1];
        s[i0] = add_mod(x0, x1, q);
        s[i1] = mul_mod_shoup(sub_mod(x0, x1, q), w.x, w.y, q);
      }
      __syncthreads();
    }
    const uint32_t ni = c.ninv[l];
    const uint32_t nis = c.ninv_shoup[l];
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
      const uint4 v = s4[i];
      dst[i] = make_uint4(
          mul_mod_shoup(v.x, ni, nis, q), mul_mod_shoup(v.y, ni, nis, q),
          mul_mod_shoup(v.z, ni, nis, q), mul_mod_shoup(v.w, ni, nis, q));
    }
  }
}

}  // namespace

// x, out: (B, L, n) int32 residues, 16-byte aligned; tw: (L, n, 2) int32
// (twiddle, low 32 bits of its Shoup word), forward or inverse tables;
// consts: host NttConsts. n a power of two in [256, 32768], 1 <= L <= 64.
extern "C" int fhe_ntt_butterfly(void* out, const void* x, const void* tw,
                                 const void* consts, int B, int L, int n,
                                 int forward, void* stream) {
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  if ((1 << log_n) != n || n < kMinRing || n > kMaxRing || L < 1 ||
      L > kMaxLimbs || B < 1)
    return (int)cudaErrorInvalidValue;
  NttConsts c;
  std::memcpy(&c, consts, sizeof(c));
  void (*kern)(int32_t*, const int32_t*, const uint2*, const NttConsts, int,
               int) = forward ? &ntt_butterfly_kernel<true>
                              : &ntt_butterfly_kernel<false>;
  const int smem = n * (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = n / 2 < kMaxThreads ? n / 2 : kMaxThreads;
  const long long blocks = (long long)B * L;
  kern<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)x, (const uint2*)tw, c, L, log_n);
  return (int)cudaGetLastError();
}
