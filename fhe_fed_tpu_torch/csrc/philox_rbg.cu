// The rbg draw on the card: Philox4x32-10 words under keys read from
// device memory, with the JAX package's three samplers fused after them.
//
// Replaces XLA's expansion of RngBitGenerator (Philox), which the JAX
// package reaches from jax/_src/prng.py `_rbg_random_bits` through
// `lax.rng_bit_generator`; not a Pallas kernel. The words are XLA's bit
// for bit (fhe_fed_tpu_torch/utils/prng.py states the layout): for key
// words (w0, w1, w2, w3), block i runs on the 128-bit counter
// ((w1:w0) << 64) + (w3:w2) + i under the Philox key (w0, w1), and word j
// of a key's draw is word j % 4 of block j / 4. The epilogues compute what
// fhe_fed_tpu/ckks/keys.py computes on those words:
//   kWords   the words, int64 (prng.bits);
//   kUniform (hi * 2^32 + lo) mod q_l, hi from the first key's words, lo
//            from the second's, the limb l = (e / n) % limbs of element e
//            (_reduce_bits_mod_q: lo by two conditional subtractions,
//            q > 2^30; hi by a Shoup multiply with 2^32 mod q), int32;
//   kTernary w % 3 - 1, int32;
//   kCbd     popcount(a & (2^20 - 1)) - popcount(b & (2^20 - 1)), a from
//            the first key's words, b from the second's, int32.
// A key batch draws every key its own stream: the output is
// (nkeys, per) elements, key b's from its own counter 0.
//
// What bounds it: operations. One Philox block is 10 rounds of two 32x32
// products (a high and a low word each) and four XORs, plus the key
// increments: ~100 integer instructions for 4 words, twice that for the
// two-key epilogues, against 16 or 32 bytes written. tools/philox_report.py
// counts the SASS and sets the issue floor beside the bytes bound.
// Design: one thread a Philox block (4 consecutive output elements),
// grid-stride, the key words read once a block through the read-only path
// (keys are a few hundred bytes: they stay in L1); 16-byte stores where the
// 4 elements are aligned, else element by element; 32-bit index arithmetic
// when the draw fits, so the only divisions (the key of a block, the limb
// of its first element) are 32-bit. No host copy: the limb constants are
// a by-value parameter block.

#include <cstdint>

#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kMaxLimbs = 28;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // grid-stride beyond this
constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr uint32_t kCbdMask = (1u << 20) - 1;

enum Epilogue { kWords = 0, kUniform = 1, kTernary = 2, kCbd = 3 };

struct Params {
  uint32_t q[kMaxLimbs];
  uint32_t p32[kMaxLimbs];        // 2^32 mod q
  uint32_t p32_shoup[kMaxLimbs];  // floor(p32 * 2^32 / q)
  long long per;                  // elements a key draws
  long long blocks;               // Philox blocks a key: ceil(per / 4)
  long long total;                // nkeys * blocks
  int limbs, n;                   // kUniform: the (..., limbs, n) layout
};

__device__ __forceinline__ uint4 philox(const int64_t* __restrict__ key,
                                        unsigned long long i) {
  const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(key));
  const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(key) + 1);
  const uint32_t w0 = (uint32_t)a.x, w1 = (uint32_t)a.y;
  const unsigned long long s1 =
      ((unsigned long long)(uint32_t)b.y << 32) | (uint32_t)b.x;
  const unsigned long long lo = s1 + i;
  const unsigned long long hi =
      (((unsigned long long)w1 << 32) | w0) + (lo < s1 ? 1ull : 0ull);
  uint32_t c0 = (uint32_t)lo, c1 = (uint32_t)(lo >> 32);
  uint32_t c2 = (uint32_t)hi, c3 = (uint32_t)(hi >> 32);
  uint32_t k0 = w0, k1 = w1;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int m) {
  return m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w;
}

template <int EPI>
__device__ __forceinline__ int32_t sample(uint32_t x, uint32_t y,
                                          const Params& p, int l) {
  if constexpr (EPI == kUniform) {
    const uint32_t q = p.q[l];
    uint32_t lo = y >= 2 * q ? y - 2 * q : y;
    lo = lo >= q ? lo - q : lo;
    return (int32_t)add_mod(mul_mod_shoup(x, p.p32[l], p.p32_shoup[l], q),
                            lo, q);
  } else if constexpr (EPI == kTernary) {
    return (int32_t)(x % 3u) - 1;
  } else {
    return __popc(x & kCbdMask) - __popc(y & kCbdMask);
  }
}

// Idx: uint32_t when every element index fits, else unsigned long long.
template <int EPI, typename Idx>
__global__ void __launch_bounds__(kThreads)
philox_kernel(void* __restrict__ out, const int64_t* __restrict__ k1,
              const int64_t* __restrict__ k2, const __grid_constant__ Params p) {
  constexpr bool kTwo = EPI == kUniform || EPI == kCbd;
  const Idx per = (Idx)p.per, blocks = (Idx)p.blocks, total = (Idx)p.total;
  for (Idx t = (Idx)blockIdx.x * kThreads + threadIdx.x; t < total;
       t += (Idx)gridDim.x * kThreads) {
    const Idx b = t / blocks;                 // the key
    const Idx j = t - b * blocks;             // its Philox block
    const uint4 x = philox(k1 + 4 * b, j);
    const uint4 y = kTwo ? philox(k2 + 4 * b, j) : x;
    const Idx e0 = 4 * j;                     // element within the key's draw
    const Idx base = b * per + e0;            // element of the output
    const int cnt = per - e0 < 4 ? (int)(per - e0) : 4;
    if constexpr (EPI == kWords) {
      long long* o = static_cast<long long*>(out) + base;
      if (cnt == 4 && base % 2 == 0) {
        reinterpret_cast<longlong2*>(o)[0] = make_longlong2(x.x, x.y);
        reinterpret_cast<longlong2*>(o)[1] = make_longlong2(x.z, x.w);
      } else {
        for (int m = 0; m < cnt; ++m) o[m] = word(x, m);
      }
    } else {
      int l = 0;
      Idx col = 0;
      if constexpr (EPI == kUniform) {
        const Idx row = e0 / (Idx)p.n;
        col = e0 - row * (Idx)p.n;
        l = (int)(row % (Idx)p.limbs);
      }
      int32_t r[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if constexpr (EPI == kUniform) {
          if (m > 0 && ++col == (Idx)p.n) {   // the next row: the next limb
            col = 0;
            l = l + 1 == p.limbs ? 0 : l + 1;
          }
        }
        r[m] = sample<EPI>(word(x, m), word(y, m), p, l);
      }
      int32_t* o = static_cast<int32_t*>(out) + base;
      if (cnt == 4 && base % 4 == 0) {
        *reinterpret_cast<int4*>(o) = make_int4(r[0], r[1], r[2], r[3]);
      } else {
        for (int m = 0; m < cnt; ++m) o[m] = r[m];
      }
    }
  }
}

template <int EPI>
cudaError_t launch(void* out, const int64_t* k1, const int64_t* k2,
                   const Params& p, cudaStream_t stream) {
  const long long want = (p.total + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  if (p.total * 4 < (1ll << 31))
    philox_kernel<EPI, uint32_t><<<grid, kThreads, 0, stream>>>(out, k1, k2,
                                                                p);
  else
    philox_kernel<EPI, unsigned long long><<<grid, kThreads, 0, stream>>>(
        out, k1, k2, p);
  return cudaGetLastError();
}

}  // namespace

// out: (nkeys, per) elements (int64 for kWords, else int32); k1, k2:
// (nkeys, 4) int64 key words on the device (k2 only for kUniform and
// kCbd); limb_consts (host, kUniform only): uint32 [q | 2^32 mod q | its
// Shoup word], `limbs` each. Returns cudaGetLastError() after the launch.
extern "C" int fhe_philox_rbg(void* out, const int64_t* k1,
                              const int64_t* k2, const uint32_t* limb_consts,
                              int limbs, int n, int epilogue, long long nkeys,
                              long long per, void* stream) {
  if (out == nullptr || k1 == nullptr || nkeys < 1 || per < 1 ||
      epilogue < kWords || epilogue > kCbd)
    return (int)cudaErrorInvalidValue;
  if ((epilogue == kUniform || epilogue == kCbd) && k2 == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.per = per;
  p.blocks = (per + 3) / 4;
  p.total = nkeys * p.blocks;
  if (epilogue == kUniform) {
    if (limb_consts == nullptr || limbs < 1 || limbs > kMaxLimbs || n < 1 ||
        per % ((long long)limbs * n) != 0)
      return (int)cudaErrorInvalidValue;
    for (int l = 0; l < limbs; ++l) {
      p.q[l] = limb_consts[l];
      p.p32[l] = limb_consts[limbs + l];
      p.p32_shoup[l] = limb_consts[2 * limbs + l];
    }
    p.limbs = limbs;
    p.n = n;
  }
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (epilogue) {
    case kWords: err = launch<kWords>(out, k1, k2, p, s); break;
    case kUniform: err = launch<kUniform>(out, k1, k2, p, s); break;
    case kTernary: err = launch<kTernary>(out, k1, k2, p, s); break;
    default: err = launch<kCbd>(out, k1, k2, p, s); break;
  }
  return (int)err;
}
