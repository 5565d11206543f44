// The secret-key encrypt's and the decrypt's elementwise steps around the
// NTT, as three passes over int32 residues (ckks/rlwe_passes.py wraps
// them; ckks/ops.py and ckks/encoding.py dispatch CUDA tensors to them):
//
//   encode   before K1's forward NTT, (B, N) -> (B, L, N):
//              w[b, l, j] = encode(v[b, j]) + lift_l(e[b, j]) mod q_l
//            (without e: encode_coeff's residues alone);
//   encrypt  after it, (B, L, N) x 2 -> (B, 2, L, N), or c0 alone
//            (B, L, N) for the seeded encrypt:
//              c0[b, l, j] = a[b, l, j] * s[l, j] + w_hat[b, l, j] mod q_l,
//              c1[b, l, j] = -a[b, l, j] mod q_l;
//   decrypt  before K1's inverse NTT, (B, 2, live, N) -> (B, live, N):
//              p[b, l, j] = c0[b, l, j] + c1[b, l, j] * s[l, j] mod q_l.
//
// Replaces no Pallas kernel: PyTorch's int64 elementwise glue around the
// NTT, kept as the plain versions these passes equal bit for bit, which
// CPU tensors run: encode, encoding.encode_plain (ckks/encoding.py:53-81:
// the f32 digit split, six Shoup multiply-adds a limb, the sign, then
// keys.lift_signed and add_mod); encrypt, ops._encrypt_plain
// (ckks/ops.py:128-140: the Shoup multiply by s, add_mod, neg_mod and the
// stack); decrypt, ops._phase_plain (ckks/ops.py:286-295: c0 + c1 * s).
//
// What bounds them: bytes over 3.35 TB/s. At the cohort's (3, 204, 4,
// 8192): encode reads 40.1 MB and writes 80.2 MB (0.036 ms), encrypt
// reads 160.4 MB (the key's 0.4 MB stays in L2) and writes 160.4 MB
// (0.096 ms), decrypt reads 53.5 MB and writes 26.7 MB (0.024 ms). Each
// does a few integer operations per 4 bytes. Design: a grid of (row,
// column tile), a row being one polynomial (encode) or one limb of one
// (encrypt, decrypt), so the limb is one division a thread; each thread
// takes 4 neighbouring residues with 16-byte loads and stores, reads its
// streamed inputs once (ld.global.nc.L1::no_allocate) and the key through
// the read-only path; the moduli are a by-value parameter block, so a call
// copies nothing from the host.
//
// The encode. t = rint(v * scale) in f32 (exact: the scale is a power of
// two; half-even, as torch.round) is an integer-valued float, so
// |t| = m * 2^k with m < 2^24: below 2^24 k = 0 and m = |t|, above it m
// is the mantissa with its implicit bit and k the exponent less 23 (k <=
// 104 for a finite float). Then |t| mod q_l = m * (2^k mod q_l) mod q_l,
// one Shoup multiply a limb by the context's table of 2^k mod q_l
// (params.encode_table), negated where t < 0. The canonical residue is
// unique, so this equals the plain version's digit chain wherever that is
// exact: |t| < 2^96 (six 16-bit digits). Outside it:
//   * a finite |t| >= 2^96 gives t mod q_l exactly, where the plain
//     version's int64 digit products wrap;
//   * a non-finite t (NaN, +-inf, v * scale past the f32 range) gives 0,
//     before the error is added.
// The error is added as the plain version adds it, on every int32 e:
// lift = e + q_l where e < 0 (in int32 range for any e), then the int64
// (x + lift) less q_l where that is >= q_l. For |e| < q_l (the samplers
// give |e| <= 10) that is the canonical residue of x + e.
//
// The encrypt and decrypt passes: x * s mod q_l by a Shoup multiply with
// the low 32 bits of s's Shoup word (floor(s * 2^32 / q_l) < 2^32), as K3
// reads its words, then add_mod / q_l - a, as the plain int64 versions
// compute for residues in [0, q_l).

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kMaxLimbs = 32;   // make_params reaches 28 limbs
constexpr int kExps = 105;      // 2^k mod q for k <= 127 - 23
constexpr int kThreads = 256;
constexpr int kTile = kThreads * 4;   // residues of a row per block

struct Moduli {
  uint32_t q[kMaxLimbs];
};

__device__ __forceinline__ uint4 ld_once(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void st4(int32_t* p, uint32_t a, uint32_t b,
                                    uint32_t c, uint32_t d) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
}

// |t| = m * 2^k for t = rint(v * scale); m = 0 where t is not finite.
struct Split {
  uint32_t m;
  int k;
  bool neg;
};

__device__ __forceinline__ Split split_value(uint32_t bits, float scale) {
  const float t = rintf(__fmul_rn(__uint_as_float(bits), scale));
  const float r = fabsf(t);
  Split s;
  s.neg = t < 0.0f;
  s.k = 0;
  s.m = 0;
  if (r < 16777216.0f) {
    s.m = (uint32_t)r;
  } else if (r < __int_as_float(0x7f800000)) {   // finite
    const uint32_t b = __float_as_uint(r);
    s.m = (b & 0x7fffffu) | 0x800000u;
    s.k = (int)(b >> 23) - 150;
  }
  return s;
}

__device__ __forceinline__ uint32_t encode_limb(const Split& s,
                                                const uint2* table,
                                                uint32_t q) {
  const uint2 p = __ldg(table + s.k);
  const uint32_t x = mul_mod_shoup(s.m, p.x, p.y, q);
  return s.neg && x != 0 ? q - x : x;
}

// The plain version's lift and int64 add_mod, on any int32 e.
__device__ __forceinline__ uint32_t add_error(uint32_t x, int32_t e,
                                              uint32_t q) {
  const long long lift = e < 0 ? (long long)e + q : (long long)e;
  const long long s = (long long)x + lift;
  return (uint32_t)(int32_t)(s >= q ? s - q : s);
}

template <bool kError>
__global__ void __launch_bounds__(kThreads)
encode_pass_kernel(int32_t* __restrict__ out, const float* __restrict__ v,
                   const int32_t* __restrict__ e,
                   const uint2* __restrict__ table,
                   const __grid_constant__ Moduli p, float scale, int limbs,
                   int n) {
  const int j = blockIdx.y * kTile + threadIdx.x * 4;
  if (j >= n) return;
  const size_t in = (size_t)blockIdx.x * n + j;
  const uint4 vb = ld_once(v + in);
  uint4 eb = make_uint4(0, 0, 0, 0);
  if constexpr (kError) eb = ld_once(e + in);
  const Split s0 = split_value(vb.x, scale), s1 = split_value(vb.y, scale),
              s2 = split_value(vb.z, scale), s3 = split_value(vb.w, scale);
  int32_t* o = out + (size_t)blockIdx.x * limbs * n + j;
  for (int l = 0; l < limbs; ++l) {
    const uint32_t q = p.q[l];
    const uint2* tl = table + (size_t)l * kExps;
    uint32_t x0 = encode_limb(s0, tl, q), x1 = encode_limb(s1, tl, q),
             x2 = encode_limb(s2, tl, q), x3 = encode_limb(s3, tl, q);
    if constexpr (kError) {
      x0 = add_error(x0, (int32_t)eb.x, q);
      x1 = add_error(x1, (int32_t)eb.y, q);
      x2 = add_error(x2, (int32_t)eb.z, q);
      x3 = add_error(x3, (int32_t)eb.w, q);
    }
    st4(o + (size_t)l * n, x0, x1, x2, x3);
  }
}

// The low words of four int64 Shoup words at p (16-byte aligned).
__device__ __forceinline__ uint4 shoup_words(const long long* p) {
  const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
  const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p + 2));
  return make_uint4((uint32_t)a.x, (uint32_t)a.y, (uint32_t)b.x,
                    (uint32_t)b.y);
}

__device__ __forceinline__ uint32_t neg_mod(uint32_t a, uint32_t q) {
  return a == 0 ? 0 : q - a;
}

template <bool kC1>
__global__ void __launch_bounds__(kThreads)
encrypt_pass_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                    const int32_t* __restrict__ w,
                    const int32_t* __restrict__ s,
                    const long long* __restrict__ s_shoup,
                    const __grid_constant__ Moduli p, int limbs, int n) {
  const int j = blockIdx.y * kTile + threadIdx.x * 4;
  if (j >= n) return;
  const size_t row = blockIdx.x;
  const int l = (int)(row % limbs);
  const size_t b = row / limbs;
  const uint32_t q = p.q[l];
  const size_t in = row * n + j;
  const uint4 av = ld_once(a + in);
  const uint4 wv = ld_once(w + in);
  const size_t k = (size_t)l * n + j;
  const uint4 sv = __ldg(reinterpret_cast<const uint4*>(s + k));
  const uint4 hv = shoup_words(s_shoup + k);
  const uint32_t c0x = add_mod(mul_mod_shoup(av.x, sv.x, hv.x, q), wv.x, q);
  const uint32_t c0y = add_mod(mul_mod_shoup(av.y, sv.y, hv.y, q), wv.y, q);
  const uint32_t c0z = add_mod(mul_mod_shoup(av.z, sv.z, hv.z, q), wv.z, q);
  const uint32_t c0w = add_mod(mul_mod_shoup(av.w, sv.w, hv.w, q), wv.w, q);
  if constexpr (kC1) {
    int32_t* o = out + ((2 * b) * limbs + l) * n + j;
    st4(o, c0x, c0y, c0z, c0w);
    st4(o + (size_t)limbs * n, neg_mod(av.x, q), neg_mod(av.y, q),
        neg_mod(av.z, q), neg_mod(av.w, q));
  } else {
    st4(out + in, c0x, c0y, c0z, c0w);
  }
}

__global__ void __launch_bounds__(kThreads)
decrypt_pass_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ ct,
                    const int32_t* __restrict__ s,
                    const long long* __restrict__ s_shoup,
                    const __grid_constant__ Moduli p, int live, int n) {
  const int j = blockIdx.y * kTile + threadIdx.x * 4;
  if (j >= n) return;
  const size_t row = blockIdx.x;
  const int l = (int)(row % live);
  const size_t b = row / live;
  const uint32_t q = p.q[l];
  const int32_t* c0 = ct + ((2 * b) * live + l) * n + j;
  const uint4 xv = ld_once(c0);
  const uint4 yv = ld_once(c0 + (size_t)live * n);
  const size_t k = (size_t)l * n + j;
  const uint4 sv = __ldg(reinterpret_cast<const uint4*>(s + k));
  const uint4 hv = shoup_words(s_shoup + k);
  st4(out + row * n + j,
      add_mod(xv.x, mul_mod_shoup(yv.x, sv.x, hv.x, q), q),
      add_mod(xv.y, mul_mod_shoup(yv.y, sv.y, hv.y, q), q),
      add_mod(xv.z, mul_mod_shoup(yv.z, sv.z, hv.z, q), q),
      add_mod(xv.w, mul_mod_shoup(yv.w, sv.w, hv.w, q), q));
}

bool bad_shape(int limbs, long long rows, int n) {
  return limbs < 1 || limbs > kMaxLimbs || rows < 1 || n < 4 || n % 4 ||
         rows * limbs > 0x7fffffffLL;
}

Moduli moduli_of(const void* block, int limbs) {
  Moduli p;
  std::memset(&p, 0, sizeof(p));
  std::memcpy(p.q, block, sizeof(uint32_t) * limbs);
  return p;
}

dim3 grid_of(long long rows, int n) {
  return dim3((unsigned)rows, (unsigned)((n + kTile - 1) / kTile));
}

}  // namespace

// values: (rows, n) float32; error: (rows, n) int32 or null; out: (rows,
// limbs, n) int32; table: (>= limbs, 105) pairs of uint32 on the device
// (2^k mod q_l and the low word of its Shoup word); moduli: host uint32
// [limbs]. n % 4 == 0, 1 <= limbs <= 32.
extern "C" int fhe_encode_pass(void* out, const void* values,
                               const void* error, const void* table,
                               const void* moduli, int limbs, long long rows,
                               int n, float scale, void* stream) {
  if (bad_shape(limbs, rows, n)) return (int)cudaErrorInvalidValue;
  const Moduli p = moduli_of(moduli, limbs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(out);
  const float* v = static_cast<const float*>(values);
  const int32_t* e = static_cast<const int32_t*>(error);
  const uint2* t = static_cast<const uint2*>(table);
  if (e != nullptr)
    encode_pass_kernel<true><<<grid_of(rows, n), kThreads, 0, st>>>(
        o, v, e, t, p, scale, limbs, n);
  else
    encode_pass_kernel<false><<<grid_of(rows, n), kThreads, 0, st>>>(
        o, v, e, t, p, scale, limbs, n);
  return (int)cudaGetLastError();
}

// a, w_hat: (rows, limbs, n) int32; s: (>= limbs, n) int32; s_shoup: (>=
// limbs, n) int64; out: (rows, 2, limbs, n) int32 with c1, else (rows,
// limbs, n); moduli: host uint32 [limbs].
extern "C" int fhe_encrypt_pass(void* out, const void* a, const void* w_hat,
                                const void* s, const void* s_shoup,
                                const void* moduli, int limbs, long long rows,
                                int n, int c1, void* stream) {
  if (bad_shape(limbs, rows, n)) return (int)cudaErrorInvalidValue;
  const Moduli p = moduli_of(moduli, limbs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(rows * limbs, n);
  int32_t* o = static_cast<int32_t*>(out);
  const int32_t* ai = static_cast<const int32_t*>(a);
  const int32_t* wi = static_cast<const int32_t*>(w_hat);
  const int32_t* si = static_cast<const int32_t*>(s);
  const long long* hi = static_cast<const long long*>(s_shoup);
  if (c1)
    encrypt_pass_kernel<true><<<grid, kThreads, 0, st>>>(o, ai, wi, si, hi,
                                                         p, limbs, n);
  else
    encrypt_pass_kernel<false><<<grid, kThreads, 0, st>>>(o, ai, wi, si, hi,
                                                          p, limbs, n);
  return (int)cudaGetLastError();
}

// ct: (rows, 2, live, n) int32; s: (>= live, n) int32; s_shoup: (>= live,
// n) int64; out: (rows, live, n) int32; moduli: host uint32 [live].
extern "C" int fhe_decrypt_pass(void* out, const void* ct, const void* s,
                                const void* s_shoup, const void* moduli,
                                int live, long long rows, int n,
                                void* stream) {
  if (bad_shape(live, rows, n)) return (int)cudaErrorInvalidValue;
  const Moduli p = moduli_of(moduli, live);
  decrypt_pass_kernel<<<grid_of(rows * live, n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), static_cast<const int32_t*>(ct),
      static_cast<const int32_t*>(s), static_cast<const long long*>(s_shoup),
      p, live, n);
  return (int)cudaGetLastError();
}
