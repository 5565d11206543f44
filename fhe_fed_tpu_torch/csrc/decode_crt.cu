// Kernel K4: exact-CRT CKKS decode, residues (chunks, live, N) int32 ->
// values (chunks, N) float32.
//
// Replaces fhe_fed_tpu/ckks/pallas_decode.py::_kernel (reached through
// decode_fused), which runs ckks/encoding.py::decode_core:
//   1. y_l = x_l * (Q/q_l)^-1 mod q_l;
//   2. k = round(sum_l y_l / q_l) in f32, summed in limb order;
//   3. sum_l y_l * (Q/q_l) in base-2^16 digit planes;
//   4. subtract k*Q, take the sign and the magnitude's digits;
//   5. divide by the scale in two-float (f32 hi, lo) arithmetic.
// Any exact method gives the same digits in 4 (the value is unique); the
// float tail follows _planes_to_f32 operation for operation: the same order
// of df_add_f32 over the digits, the same overflow rule (a nonzero digit
// of weight above 2^127 -> inf), the same df_mul by the two-float
// 2^e/scale, rintf for round-half-even. Every float operation is written
// with __fadd_rn / __fsub_rn / __fmul_rn, which nvcc never contracts into
// an FMA: a fused a*b+c would break Dekker's two_prod and with it the
// bit-exactness.
//
// What bounds it: the first design (one thread per coefficient, 16-bit
// plane products on the CUDA cores) ran ~live*ndig rounds of two products
// and four mask/shift/adds per coefficient (27 * 55 at 27 limbs): integer
// issue, not bytes. This design moves step 3 onto the tensor cores, as the
// JAX package's decode_core_mxu does on the MXU:
//   * each y_l splits into its 4 unsigned bytes, which are the bytes of the
//     32-bit word itself, so a row of A (one coefficient, K = 4*live bytes,
//     padded to 32) costs no instruction; B is the per-context byte matrix
//     DecodeConsts.m_bytes (row (l, i), column d8 = byte (d8 - i) of
//     Q/q_l), padded to 8-column tiles, held in shared memory in
//     mma.sync fragment order;
//   * P8 = bytes(y) @ m_bytes with mma.sync m16n8k32 u8.u8.s32, exact:
//     each entry < 4*live*255^2 <= 7,022,700 < 2^23 at 27 limbs (and below
//     2^23 up to 32); the accumulator fragment gives each thread columns
//     (2d, 2d+1) of two rows, so it forms the 16-bit plane
//     P8[2d] + 256*P8[2d+1] < 1.805e9 < 2^31 itself;
//   * the planes go through shared memory, so that one thread holds one
//     coefficient's planes; one carry pass forms v = acc - k*Q in two's
//     complement over NP planes (|pl - k*qd + carry| < 2^31 for k <= live,
//     qd < 2^16), its final carry is the sign, and one pass forms the
//     magnitude's digits and the highest nonzero one, where the tail stops:
//     adding 0 to a normalised two-float sum that is finite returns it
//     unchanged, and the sum stays finite until the first digit of weight
//     above 2^112, after which every digit takes the overflow branch;
//   * a warp takes 32 coefficients through all three phases and syncs only
//     itself; blocks stay resident and walk the tiles, so the constants
//     (about 15 KB at 27 limbs) are loaded into shared memory once per
//     block, from a device buffer the wrapper builds once per (limb count,
//     scale) and caches;
//   * the kernel is a template on the live limb count: every loop bound is
//     a constant (NP planes, the most a chain of 31-bit primes needs,
//     ceil(31*live/16) + 2 rounded up to a multiple of 4; the constants
//     are zero past the context's ndig), so no plane carries a predicate.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kMaxLive = 27;     // the longest chain make_params accepts
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStride = 40;      // words per region row: == 8 mod 32
constexpr int kHeader = 8;       // live, ks, nt, du, c_hi, c_lo, words, 0

template <int LIVE>
struct Dims {
  static constexpr int KS = (4 * LIVE + 31) / 32;           // k-steps of 32
  static constexpr int NDMAX = (31 * LIVE + 15) / 16 + 2;   // 16-bit planes
  static constexpr int NT = (NDMAX + 3) / 4;                // 8-column tiles
  static constexpr int NP = 4 * NT;                         // planes computed
  static constexpr int ROWS = NP > 8 * KS ? NP : 8 * KS;    // region rows
  // Word offsets in the constant block (pallas_decode.kernel_consts).
  static constexpr int Q = kHeader, PINV = Q + LIVE, PINVS = PINV + LIVE;
  static constexpr int INVQ = PINVS + LIVE, QDIG = INVQ + LIVE;
  static constexpr int TW = QDIG + NP;
  static constexpr int B = (TW + NP + 1) & ~1;
  static constexpr int WORDS = B + KS * NT * 64;
  static constexpr int SMEM_WORDS = (WORDS + 3) & ~3;
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

__device__ __forceinline__ uint32_t ld_once(const int32_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// c += A . B for a 16x32 u8 tile A and a 32x8 u8 tile B, exact in s32.
__device__ __forceinline__ void mma_u8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

template <int LIVE>
__global__ void __launch_bounds__(kThreads, 2)
decode_kernel(float* __restrict__ out, const int32_t* __restrict__ x,
              const uint32_t* __restrict__ consts, long long tiles,
              int log_n) {
  using D = Dims<LIVE>;
  extern __shared__ __align__(16) uint32_t sm[];
  for (int i = threadIdx.x; i < D::WORDS; i += kThreads) sm[i] = consts[i];
  __syncthreads();
  const uint32_t* q = sm + D::Q;
  const uint32_t* pinv = sm + D::PINV;
  const uint32_t* pinvs = sm + D::PINVS;
  const float* invq = reinterpret_cast<const float*>(sm + D::INVQ);
  const int32_t* qdig = reinterpret_cast<const int32_t*>(sm + D::QDIG);
  const float* tw = reinterpret_cast<const float*>(sm + D::TW);
  const uint2* bfrag = reinterpret_cast<const uint2*>(sm + D::B);
  const int du = (int)sm[3];
  const float c_hi = __uint_as_float(sm[4]), c_lo = __uint_as_float(sm[5]);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* reg = sm + D::SMEM_WORDS + warp * D::ROWS * kStride;

  for (long long tile = (long long)blockIdx.x * kWarps + warp; tile < tiles;
       tile += (long long)gridDim.x * kWarps) {
    // Phase 1, one coefficient a thread: y_l (to the region, limb-major)
    // and k.
    const long long c0 = tile * 32;
    const long long chunk = c0 >> log_n;
    const int32_t* xc = x + ((chunk * LIVE) << log_n) +
                        (c0 & ((1 << log_n) - 1)) + lane;
    uint32_t xv[LIVE];
#pragma unroll
    for (int l = 0; l < LIVE; ++l)
      xv[l] = ld_once(xc + ((size_t)l << log_n));
    float fsum = 0.0f;
#pragma unroll
    for (int l = 0; l < LIVE; ++l) {
      const uint32_t y = mul_mod_shoup(xv[l], pinv[l], pinvs[l], q[l]);
      fsum = __fadd_rn(fsum, __fmul_rn((float)(int32_t)y, invq[l]));
      reg[l * kStride + lane] = y;
    }
    const int32_t k = (int32_t)rintf(fsum);
    __syncwarp();

    // Phase 2, the warp: planes of sum_l y_l * Q/q_l for its two 16-row
    // tiles, on the tensor cores.
    uint32_t a[2][D::KS][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int s = 0; s < D::KS; ++s) {
        const int r0 = 8 * s + t, r1 = r0 + 4;
        const uint32_t* p0 = reg + r0 * kStride + 16 * m + g;
        const uint32_t* p1 = reg + r1 * kStride + 16 * m + g;
        a[m][s][0] = r0 < LIVE ? p0[0] : 0u;
        a[m][s][1] = r0 < LIVE ? p0[8] : 0u;
        a[m][s][2] = r1 < LIVE ? p1[0] : 0u;
        a[m][s][3] = r1 < LIVE ? p1[8] : 0u;
      }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < D::NT; ++j) {
      int32_t c[2][4] = {};
#pragma unroll
      for (int s = 0; s < D::KS; ++s) {
        const uint2 b = bfrag[(s * D::NT + j) * 32 + lane];
        mma_u8(c[0], a[0][s], b);
        mma_u8(c[1], a[1][s], b);
      }
      // Columns (2t, 2t+1) of tile j are the byte planes of plane 4j + t.
      int32_t* prow = reinterpret_cast<int32_t*>(reg) + (4 * j + t) * kStride;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        prow[16 * m + g] = c[m][0] + (c[m][1] << 8);
        prow[16 * m + g + 8] = c[m][2] + (c[m][3] << 8);
      }
    }
    __syncwarp();

    // Phase 3, one coefficient a thread: v = acc - k*Q, its sign, the
    // magnitude's digits and the two-float tail.
    const int32_t* pl = reinterpret_cast<const int32_t*>(reg) + lane;
    int32_t v[D::NP];
    int32_t carry = 0;
#pragma unroll
    for (int d = 0; d < D::NP; ++d) {
      const int32_t r = pl[d * kStride] - k * qdig[d] + carry;
      v[d] = r & 0xFFFF;
      carry = r >> 16;
    }
    __syncwarp();
    // The magnitude's digits (0xFFFF - v is v ^ 0xFFFF) and the highest
    // nonzero one; the tail stops there.
    const bool neg = carry < 0;
    const int32_t flip = neg ? 0xFFFF : 0;
    carry = neg ? 1 : 0;
    int top = -1;
#pragma unroll
    for (int d = 0; d < D::NP; ++d) {
      const int32_t tt = (v[d] ^ flip) + carry;
      v[d] = tt & 0xFFFF;
      carry = tt >> 16;
      top = v[d] != 0 ? d : top;
    }
    float hi = 0.0f, lo = 0.0f;
    bool overflow = false;
#pragma unroll
    for (int d = 0; d < D::NP; ++d) {
      if (d > top) break;
      if (d < du)
        df_add_f32(hi, lo, __fmul_rn((float)v[d], tw[d]));
      else
        overflow = overflow || v[d] != 0;
    }
    if (overflow) hi = INFINITY;
    df_mul(hi, lo, c_hi, c_lo);
    __stcs(out + c0 + lane, __fmul_rn(__fadd_rn(hi, lo), neg ? -1.0f : 1.0f));
  }
}

template <int LIVE>
int launch(float* out, const int32_t* x, const uint32_t* consts, int words,
           int chunks, int n, cudaStream_t stream) {
  using D = Dims<LIVE>;
  if (words != D::WORDS) return (int)cudaErrorInvalidValue;  // the layout
  const int smem = 4 * (D::SMEM_WORDS + kWarps * D::ROWS * kStride);
  static int resident = 0;       // blocks per SM, from the occupancy query
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<LIVE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, decode_kernel<LIVE>, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  const long long tiles = (long long)chunks * n / 32;
  long long blocks = (tiles + kWarps - 1) / kWarps;
  if (blocks > (long long)sms * resident) blocks = (long long)sms * resident;
  decode_kernel<LIVE><<<(unsigned)blocks, kThreads, smem, stream>>>(
      out, x, consts, tiles, log_n);
  return (int)cudaGetLastError();
}

template <int LIVE>
int dispatch(int live, float* out, const int32_t* x, const uint32_t* consts,
             int words, int chunks, int n, cudaStream_t stream) {
  if constexpr (LIVE > kMaxLive) {
    return (int)cudaErrorInvalidValue;
  } else {
    return live == LIVE
               ? launch<LIVE>(out, x, consts, words, chunks, n, stream)
               : dispatch<LIVE + 1>(live, out, x, consts, words, chunks, n,
                                    stream);
  }
}

}  // namespace

// x: (chunks, live, n) int32, n a power of two >= 32; out: (chunks, n)
// float32;
// consts: the device block of pallas_decode.kernel_consts (`words` uint32:
// header, per-limb and per-plane constants, m_bytes in fragment order) for
// this live count; 1 <= live <= 27.
extern "C" int fhe_decode_crt(void* out, const void* x, const void* consts,
                              int words, int live, int chunks, int n,
                              void* stream) {
  if (live < 1 || live > kMaxLive || n < 32 || (n & (n - 1)) || chunks < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch<1>(live, static_cast<float*>(out),
                     static_cast<const int32_t*>(x),
                     static_cast<const uint32_t*>(consts), words, chunks, n,
                     static_cast<cudaStream_t>(stream));
}
