// Kernel K1: forward and inverse negacyclic NTT as a four-step transform
// in signed base-256 digit planes, on the int8 tensor cores.
//
// Replaces fhe_fed_tpu/ntt/mxu_pallas.py::_kernel (reached through _call,
// ntt_mxu_fused and intt_mxu_fused). Same method as ntt/mxu.py: each stage
// is a (rows x 4S) . (4S x 4S) int8 product of the input's four signed
// digits against the DFT matrix premultiplied by 2^(8i) and re-split into
// four output planes; the output is bit-identical to the butterfly
// ntt.ntt / ntt.intt, in bit-reversed order, the inverse exactly scaled.
//
// Two bodies, chosen by shape in ntt/mxu.py body_for (never as a fallback),
// both exact for every q < 2^31:
//
// wgmma body (n1, n2 in {64, 128}: N = 4096, 8192, 16384; the paths' rings).
// What bounds it, per (poly, limb) at N = 8192: 25.2 M int8 MACs (a
// 128x256x256 and a 64x512x512 product) against 64 KB of device memory, so
// the tensor cores (1,979 int8 TOP/s on an H100 SXM: 0.062 ms for the
// FedAvg forward batch (612, 4, 8192), 123 G op, against 0.048 ms for its
// 160 MB); then the CUDA-core epilogue, ~31 integer instructions per
// output element and stage in the SASS (reassembly, twiddle, digit split),
// which runs on 16 INT32 lanes per SM sub-partition; then shared-memory
// bandwidth, which wgmma's operand reads nearly fill (m64n128k32 reads 6
// KB per 64 clocks at the int8 peak, of 128 B per clock). Its time beside
// these bounds and beside the mma.sync body: PERF.md section 6, measured by
// chip_smoke.py and tools/k1_report.py.
// Design:
//   * a CTA takes P polynomials of ONE limb (P = 2; 1 at N = 16384), so a
//     stage is a real GEMM (forward at N = 8192: M = 256 x K = 256 x N =
//     256, then M = 128 x K = 512 x N = 512) and each table tile is read
//     once per P polynomials; the grid is limb-major, so concurrent CTAs
//     share one limb's tables in L2 (320 KB per limb at N = 8192);
//   * a producer warpgroup (one thread working, its registers given to the
//     consumers by setmaxnreg) bulk-copies the P polynomials in, then
//     streams the tables (MxuNttTables.w*, in ntt/mxu.py wg_layout) by TMA
//     (cp.async.bulk.tensor, 128B swizzle, mbarrier completion) through a
//     shared-memory ring, running ahead through both stages; stage 2's ring
//     also covers stage 1's digits, free by then;
//   * two consumer warpgroups run wgmma.mma_async m64n128k32 s8.s8.s32, A
//     (the digits) and B from shared memory, in jobs of one 64-row tile x
//     128 columns; jobs alternate between two accumulators, so the
//     epilogue of job j runs while the tensor cores run job j + 1 (all of
//     it, or its first K-blocks where the ring cannot hold two jobs'
//     tiles: the inverse's first stage at N = 8192, the first stage at
//     16384);
//   * the table's output columns are ordered so the accumulator fragment
//     gives each thread planes P_0..P_3 of the same two outputs: the
//     reassembly needs no exchange; its K order puts the four digits of an
//     input value side by side, so they are written as one 32-bit word
//     (four bytes from two integer ops: (x' + 0x80808080) ^ 0x80808080);
//   * the reassembly is one 64-bit sum and two Shoup steps, every
//     conditional subtraction one VIADDMNMX, exact for every q < 2^31 (the
//     sum's offset is q shifted into [2^48, 2^49)); stage 1's epilogue
//     twiddles and writes stage 2's digits straight into shared memory, already
//     transposed (the four-step's transpose is indexing); the polynomial
//     is read and written once.

// mma.sync body (smaller rings, N = 256 .. 2048; the first kernel): one block
// per (poly, limb), the polynomial and its digits in shared memory, B
// fragments read from L2 in n-major copies (MxuNttTables.w*), mma.sync
// m16n8k32. Rows of fewer than 64 do not fill a warpgroup's tile.

#include <cstdint>
#include <cstring>

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

// ---------------------------------------------------------------------------
// The mma.sync body: one block per (poly, limb), B fragments from L2.
// ---------------------------------------------------------------------------

constexpr int kMaxLimbs = 32;     // make_params reaches 28 moduli
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 16;        // bytes appended to each digit row
constexpr uint32_t kOff = 1u << 24;

struct LimbConsts {             // the first four: host uint32[4][kMaxLimbs]
  uint32_t q[kMaxLimbs];
  uint32_t c32[kMaxLimbs];      // 2^32 mod q
  uint32_t c32_shoup[kMaxLimbs];
  uint32_t offm[kMaxLimbs];     // 2^24 * (1 + 2^8 + 2^16 + 2^24) mod q
  uint32_t qinv[kMaxLimbs];     // floor(2^32 / q), set by the C entry
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

// (sum_j 2^(8j) P_j) mod q from four plane sums |P_j| <= 2^23, for any
// q < 2^31: the low word is reduced by a Shoup step (qinv its Shoup word).
__device__ __forceinline__ uint32_t reassemble(int32_t p0, int32_t p1,
                                               int32_t p2, int32_t p3,
                                               const uint32_t q,
                                               const uint32_t c32,
                                               const uint32_t c32s,
                                               const uint32_t qinv,
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
  const uint32_t r2 = mul_mod_shoup(lo3, 1, qinv, q);
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
  const uint32_t qinv = kc.qinv[l], offm = kc.offm[l];
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
    return reassemble(p0, p1, p2, p3, q, c32, c32s, qinv, offm);
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

// ---------------------------------------------------------------------------
// The wgmma body (rings with n1, n2 >= 64): limb-grouped tiles, TMA-staged
// tables, warpgroup products.
// ---------------------------------------------------------------------------

// Built with -DK1_PHASE_TRACE (tools/k1_report.py), the wgmma body stamps
// clock64() at six points of each consumer warpgroup into k1_phase_trace
// [block][warpgroup][point]: start, input landed, stage-1 digits written,
// stage 1 done, stage 2 started, done. Compiled out otherwise.
#ifdef K1_PHASE_TRACE
__device__ long long k1_phase_trace[1 << 20];
#define K1_MARK(k)                                                          \
  if ((threadIdx.x & 127) == 0)                                             \
  k1_phase_trace[(blockIdx.x * 2 + (threadIdx.x >> 7)) * 8 + (k)] = clock64()
#else
#define K1_MARK(k)
#endif

constexpr int kWgConsumers = 256;               // two consumer warpgroups
constexpr int kWgThreads = kWgConsumers + 128;  // and a producer warpgroup

struct WgConsts {               // per limb: q, 2^32 mod q, its Shoup word,
  uint32_t q[kMaxLimbs];        // floor(2^32 / q)
  uint32_t c32[kMaxLimbs];
  uint32_t c32_shoup[kMaxLimbs];
  uint32_t qinv[kMaxLimbs];
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Waits for the phase of `parity` to complete. The loop is inside the asm,
// so the compiler sees no divergent path between wgmma instructions.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// One table tile (128 K bytes x rows) into shared memory, 128B-swizzled.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// One contiguous copy of `bytes` (a multiple of 16) into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint4 ld_shared4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

template <int K>
struct Int2s {
  int2 v[K];
};

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared4(uint32_t addr, uint32_t a,
                                           uint32_t b, uint32_t c,
                                           uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(a),
               "r"(b), "r"(c), "r"(d)
               : "memory");
}

// Generic-proxy shared-memory writes become visible to wgmma after this and
// a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kWgConsumers) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(int32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a K-major, 128B-swizzled operand: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO), every group 1024-aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Byte k of row `row` of a digit matrix with RT rows, stored as K-blocks of
// 128 bytes (RT x 128 each), 16-byte chunks XOR-swizzled by row: the layout
// TMA's 128B swizzle gives the table tiles.
template <int RT>
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int row, int k) {
  return base + (k >> 7) * (RT * 128) + row * 128 +
         ((((k >> 4) & 7) ^ (row & 7)) << 4) + (k & 15);
}

__device__ __forceinline__ void wgmma_n128(int32_t (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The four signed base-256 digits of the centred residue, packed little-
// endian in one word: x' + 0x80808080 has bytes d_i + 128 exactly when
// |x'| < 2^30, and XOR 0x80 maps each back to the int8 d_i.
__device__ __forceinline__ uint32_t digits4(uint32_t x, uint32_t q) {
  const int32_t xs = (int32_t)x - (x > (q >> 1) ? (int32_t)q : 0);
  return ((uint32_t)xs + 0x80808080u) ^ 0x80808080u;
}

// r - q if r >= q, else r, for r < 2q: min(r - q, r) unsigned, one
// VIADDMNMX on sm_90.
__device__ __forceinline__ uint32_t csub(uint32_t r, uint32_t q) {
  return __viaddmin_u32(r, 0u - q, r);
}

// x * w mod q (Shoup, w_shoup = floor(w * 2^32 / q)) for any u32 x.
__device__ __forceinline__ uint32_t mulmod(uint32_t x, uint32_t w,
                                           uint32_t w_shoup, uint32_t q) {
  return csub(x * w - __umulhi(x, w_shoup) * q, q);
}

// The multiple of q that makes reasm64's sum positive: q shifted into
// [2^48, 2^49), for any q < 2^31 (q * 2^18 for a 31-bit q).
__device__ __forceinline__ uint64_t plane_offset(uint32_t q) {
  return (uint64_t)q << (__clz(q) + 17);
}

// (sum_j 2^(8j) P_j) mod q for |P_j| <= 2^23: one 64-bit sum made positive
// with qoff = plane_offset(q) (>= 2^48 > |sum|; s < 2^50), then hi * (2^32
// mod q) + lo, each part reduced by a Shoup step (qinv = floor(2^32 / q) is
// lo's Shoup word).
__device__ __forceinline__ uint32_t reasm64(int32_t p0, int32_t p1, int32_t p2,
                                            int32_t p3, uint32_t q,
                                            uint32_t c32, uint32_t c32s,
                                            uint32_t qinv, uint64_t qoff) {
  const uint64_t s =
      (uint64_t)((int64_t)p0 + (int64_t)p1 * 256 + (int64_t)p2 * 65536 +
                 (int64_t)p3 * 16777216) +
      qoff;
  const uint32_t hi = (uint32_t)(s >> 32), lo = (uint32_t)s;
  return csub(mulmod(hi, c32, c32s, q) + mulmod(lo, 1, qinv, q), q);
}

// Table tiles stream through a ring in shared memory: kRingBytes in stage
// 1, and in stage 2 also the stage-1 digits' space, free by then. A job is
// one 64-row tile x 128 columns, its K in KB tiles of 16 KB. A warpgroup
// issues the first PRE K-blocks of job j + 1 before it waits for job j and
// the rest after job j's epilogue: PRE = KB where the ring holds two jobs'
// tiles, else what fits beside job j's.
constexpr int kRingBytes = 98304;
constexpr int kMaxSlots = 12;
constexpr int kBarSet = 16 * kMaxSlots;   // full[12], empty[12] of a stage

template <int MT, int S, int RB>
struct Stage {
  static constexpr int NT = 128;                  // columns of a job
  static constexpr int SLOT = NT * 128;           // one tile: NT x 128 bytes
  static constexpr int RING =
      RB / SLOT < kMaxSlots ? RB / SLOT : kMaxSlots;
  static constexpr int KB = 4 * S / 128;          // K-blocks of 128 bytes
  static constexpr int PRE = RING - KB < KB ? RING - KB : KB;
  static constexpr int NTILES = 4 * S / NT;
  static constexpr int TILES = NTILES * KB;
  static constexpr int JOBS = NTILES * MT;        // per warpgroup
  static_assert(PRE >= 1 && (MT == 1 || PRE == KB) && JOBS % 2 == 0,
                "the ring holds a job and part of the next");
};

// The producer's side of one stage: tile tau = nt * KB + kb (columns nt*NT,
// K bytes kb*128) into slot tau % RING once its previous use is released.
template <int MT, int S, int RB>
__device__ __forceinline__ void produce(const CUtensorMap* map, int l,
                                        uint32_t ring, uint32_t bars) {
  using St = Stage<MT, S, RB>;
  const uint32_t full = bars, empty = bars + 8 * kMaxSlots;
  for (int tau = 0; tau < St::TILES; ++tau) {
    const int slot = tau % St::RING, use = tau / St::RING;
    if (use > 0) mbar_wait(empty + 8 * slot, (use - 1) & 1);
    mbar_expect_tx(full + 8 * slot, St::SLOT);
    tma_load_3d(ring + slot * St::SLOT, map, (tau % St::KB) * 128,
                (tau / St::KB) * St::NT, l, full + 8 * slot);
  }
}

// Waits until the consumers have released every tile of a stage, so the
// next stage may reuse the ring with other slot sizes.
template <int MT, int S, int RB>
__device__ __forceinline__ void drain(uint32_t bars) {
  using St = Stage<MT, S, RB>;
  const uint32_t empty = bars + 8 * kMaxSlots;
  for (int slot = 0; slot < St::RING && slot < St::TILES; ++slot)
    mbar_wait(empty + 8 * slot, ((St::TILES - 1 - slot) / St::RING) & 1);
}

// K-blocks [K0, K1) of job (nt, i) of a stage St as one wgmma group: wait
// for their tiles, then 4 (K1 - K0) wgmma on the accumulators.
template <typename St, int RT, int K0, int K1>
__device__ __forceinline__ void issue_blocks(int32_t (&acc)[St::NT / 2],
                                             uint32_t A, uint32_t ring,
                                             uint32_t full, int wg, int nt,
                                             int i) {
#pragma unroll
  for (int kb = K0; kb < K1; ++kb) {
    const int tau = nt * St::KB + kb;
    mbar_wait(full + 8 * (tau % St::RING), (tau / St::RING) & 1);
  }
  fence_regs(acc);
  wg_fence();
#pragma unroll
  for (int kb = K0; kb < K1; ++kb) {
    const uint32_t b = ring + ((nt * St::KB + kb) % St::RING) * St::SLOT;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_n128(acc,
                 sw128_desc(A + kb * (RT * 128) + (wg + 2 * i) * 8192 +
                            ks * 32),
                 sw128_desc(b + ks * 32), (kb | ks) != 0);
  }
  wg_commit();
}

// One stage on a consumer warpgroup: C = A . W for the A digits at `A` (RT
// rows, 4S K bytes). Job j is (n-tile, 64-row tile): (j / 2, wg + 2 (j % 2))
// when MT = 2, (j, wg) when MT = 1. Jobs alternate between two
// accumulators: the head (first PRE K-blocks) of job j + 1 is issued, then
// pre(j) (the epilogue's loads), the wait for job j, the release of its
// tiles once the warpgroup's last job on them is done, epi(acc, nt, tile,
// pre's result) while the tensor cores run job j + 1, and job j + 1's tail.
// Every consumer thread arrives on the empty barriers, and the waits loop
// inside asm: no divergent path lies between the wgmma instructions.
template <int MT, int S, int RB, int RT, typename Pre, typename Epi>
__device__ __forceinline__ void run_stage(uint32_t A, uint32_t ring,
                                          uint32_t bars, int wg, Pre&& pre,
                                          Epi&& epi) {
  using St = Stage<MT, S, RB>;
  constexpr int NT = St::NT, KB = St::KB, PRE = St::PRE;
  const uint32_t full = bars, empty = bars + 8 * kMaxSlots;
  int32_t acc0[NT / 2], acc1[NT / 2];

  auto head = [&](int32_t(&acc)[NT / 2], int nt, int i) {
    issue_blocks<St, RT, 0, PRE>(acc, A, ring, full, wg, nt, i);
  };
  auto tail = [&](int32_t(&acc)[NT / 2], int nt, int i) {
    if constexpr (PRE < KB)
      issue_blocks<St, RT, PRE, KB>(acc, A, ring, full, wg, nt, i);
  };
  auto release = [&](int nt) {
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
      mbar_arrive(empty + 8 * ((nt * KB + kb) % St::RING));
  };
  // Pair h: job 2h in acc0, job 2h + 1 in acc1.
  auto even_nt = [](int h) { return MT == 2 ? h : 2 * h; };
  auto odd_nt = [](int h) { return MT == 2 ? h : 2 * h + 1; };
  auto even = [&](int h) {
    const auto loaded = pre(even_nt(h), 0);
    wg_wait<1>();
    fence_regs(acc0);
    if (MT == 1) release(even_nt(h));
    epi(acc0, even_nt(h), 0, loaded);
  };
  auto odd_done = [&](int h, const auto& loaded) {
    fence_regs(acc1);
    release(odd_nt(h));
    epi(acc1, odd_nt(h), MT - 1, loaded);
  };
  constexpr int H = St::JOBS / 2;
  head(acc0, 0, 0);
  tail(acc0, 0, 0);
#pragma unroll 1
  for (int h = 0; h < H - 1; ++h) {   // the last pair is peeled: no branch
    head(acc1, odd_nt(h), MT - 1);
    even(h);
    tail(acc1, odd_nt(h), MT - 1);
    head(acc0, even_nt(h + 1), 0);
    const auto loaded = pre(odd_nt(h), MT - 1);
    wg_wait<1>();
    odd_done(h, loaded);
    tail(acc0, even_nt(h + 1), 0);
  }
  head(acc1, odd_nt(H - 1), MT - 1);
  even(H - 1);
  tail(acc1, odd_nt(H - 1), MT - 1);
  const auto loaded = pre(odd_nt(H - 1), MT - 1);
  wg_wait<0>();
  odd_done(H - 1, loaded);
}

// One CTA: P polynomials of limb l (P = 2, or 1 at N = 16384), both stages.
// x[a*n2 + b] is entry (a, b) of an n1 x n2 matrix.
template <int N1, int N2, bool FWD>
__global__ void __launch_bounds__(kWgThreads, 1)
    ntt_wg_kernel(const __grid_constant__ CUtensorMap tm1,
                  const __grid_constant__ CUtensorMap tm2,
                  int32_t* __restrict__ out, const int32_t* __restrict__ x,
                  const int2* __restrict__ mid, const WgConsts kc, int B,
                  int L) {
  constexpr int N = N1 * N2;
  constexpr int P = N <= 8192 ? 2 : 1;
  // Stage 1 contracts S1 over R1 rows per polynomial, stage 2 S2 over R2.
  constexpr int R1 = FWD ? N2 : N1, S1 = FWD ? N1 : N2;
  constexpr int R2 = FWD ? N1 : N2, S2 = FWD ? N2 : N1;
  constexpr int RT1 = P * R1, RT2 = P * R2;
  constexpr int MT1 = RT1 / 128, MT2 = RT2 / 128;
  static_assert(MT1 >= 1 && MT1 <= 2 && MT2 >= 1 && MT2 <= 2,
                "two warpgroups of one or two 64-row tiles");
  // Shared memory: A2 | A1 | ring. Stage 2's ring starts at A1.
  constexpr int RB1 = kRingBytes, RB2 = kRingBytes + 4 * P * N;
  constexpr int NT1 = Stage<MT1, S1, RB1>::NT, NT2 = Stage<MT2, S2, RB2>::NT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023) & ~1023u;
  const uint32_t A2 = base, A1 = base + 4 * P * N;   // digits of each stage
  const uint32_t ring = A1 + 4 * P * N;
  const uint32_t bars1 = ring + kRingBytes, bars2 = bars1 + kBarSet;
  const uint32_t xbar = bars2 + kBarSet;
  const int groups = (B + P - 1) / P;
  const int l = blockIdx.x / groups, grp = blockIdx.x % groups;   // limb-major

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kMaxSlots; ++i) {   // full, then empty
      mbar_init(bars1 + 8 * i, i < kMaxSlots ? 1 : kWgConsumers);
      mbar_init(bars2 + 8 * i, i < kMaxSlots ? 1 : kWgConsumers);
    }
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kWgConsumers) {
    // Producer: the P polynomials into A2 (raw), then every table tile.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == kWgConsumers) {
      mbar_expect_tx(xbar, 4 * P * N);
      for (int p = 0; p < P; ++p) {
        const int gp = min(grp * P + p, B - 1);   // B odd: a copy, not stored
        bulk_load(A2 + p * 4 * N, x + ((size_t)gp * L + l) * N, 4 * N, xbar);
      }
      produce<MT1, S1, RB1>(&tm1, l, ring, bars1);
      drain<MT1, S1, RB1>(bars1);   // and stage 1's products are done
      produce<MT2, S2, RB2>(&tm2, l, A1, bars2);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  K1_MARK(0);

  const uint32_t q = kc.q[l], c32 = kc.c32[l], c32s = kc.c32_shoup[l];
  const uint32_t qinv = kc.qinv[l];
  const uint64_t qoff = plane_offset(q);
  const int2* mid_l = mid + (size_t)l * N;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;

  // Stage-1 digits from the raw polynomials. Forward: row (p, b) holds
  // column b, K byte 4a + i. Inverse: row (p, a) holds row a, K byte 4b + i.
  // Sixteen bytes a store.
  mbar_wait(xbar, 0);
  K1_MARK(1);
  if (FWD) {
    constexpr int ITEMS = P * N2 * (N1 / 4);
#pragma unroll 4
    for (int it = threadIdx.x; it < ITEMS; it += kWgConsumers) {
      const int b = it % N2, a4 = (it / N2) % (N1 / 4), p = it / (N2 * N1 / 4);
      const uint32_t src = A2 + 4 * (p * N + a4 * 4 * N2 + b);
      st_shared4(a_addr<RT1>(A1, p * N2 + b, a4 * 16),
                 digits4(ld_shared(src), q), digits4(ld_shared(src + 4 * N2), q),
                 digits4(ld_shared(src + 8 * N2), q),
                 digits4(ld_shared(src + 12 * N2), q));
    }
  } else {
    constexpr int ITEMS = P * N1 * (N2 / 4);
#pragma unroll 4
    for (int it = threadIdx.x; it < ITEMS; it += kWgConsumers) {
      const int b4 = it % (N2 / 4), a = (it / (N2 / 4)) % N1;
      const int p = it / (N1 * N2 / 4);
      const uint4 v = ld_shared4(A2 + 4 * (p * N + a * N2 + b4 * 4));
      st_shared4(a_addr<RT1>(A1, p * N1 + a, b4 * 16), digits4(v.x, q),
                 digits4(v.y, q), digits4(v.z, q), digits4(v.w, q));
    }
  }
  fence_async_smem();
  consumers_sync();
  K1_MARK(2);

  // Stage 1. Output (r, t): reassemble, twiddle (index t*n2 + b forward,
  // a*n2 + c inverse), and write its digits as stage 2's row (p, t), K byte
  // 4r: the four-step's transpose. A job's twiddles are loaded before the
  // wait for its products.
  run_stage<MT1, S1, RB1, RT1>(
      A1, ring, bars1, wg,
      [&](int nt, int i) {
        const int r0 = ((wg + 2 * i) * 64 + warp * 16 + g) % R1;
        Int2s<NT1 / 8> m;
#pragma unroll
        for (int t8 = 0; t8 < NT1 / 32; ++t8)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + 8 * (e >> 1);
            const int t = nt * (NT1 / 4) + t8 * 8 + 2 * tq + (e & 1);
            m.v[t8 * 4 + e] = __ldg(mid_l + (FWD ? t * N2 + r : r * N2 + t));
          }
        return m;
      },
      [&](const int32_t(&acc)[NT1 / 2], int nt, int i,
          const Int2s<NT1 / 8>& m) {
#pragma unroll
        for (int t8 = 0; t8 < NT1 / 32; ++t8)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = (wg + 2 * i) * 64 + warp * 16 + g + 8 * (e >> 1);
            const int p = row / R1, r = row % R1;
            const int t = nt * (NT1 / 4) + t8 * 8 + 2 * tq + (e & 1);
            const int2 w = m.v[t8 * 4 + e];
            uint32_t v = reasm64(acc[t8 * 16 + e], acc[t8 * 16 + 4 + e],
                                 acc[t8 * 16 + 8 + e], acc[t8 * 16 + 12 + e],
                                 q, c32, c32s, qinv, qoff);
            v = mulmod(v, (uint32_t)w.x, (uint32_t)w.y, q);
            st_shared(a_addr<RT2>(A2, p * R2 + t, 4 * r), digits4(v, q));
          }
      });
  K1_MARK(3);
  fence_async_smem();
  consumers_sync();
  K1_MARK(4);
  // Stage 2. Output (r, t) is out[r*n2 + t] forward, out[t*n2 + r] inverse.
  run_stage<MT2, S2, RB2, RT2>(
      A2, A1, bars2, wg, [](int, int) { return 0; },
      [&](const int32_t(&acc)[NT2 / 2], int nt, int i, int) {
#pragma unroll
        for (int t8 = 0; t8 < NT2 / 32; ++t8)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = (wg + 2 * i) * 64 + warp * 16 + g + 8 * h;
            const int p = row / R2, r = row % R2;
            const int t = nt * (NT2 / 4) + t8 * 8 + 2 * tq;
            const int e = 2 * h;
            const uint32_t v0 =
                reasm64(acc[t8 * 16 + e], acc[t8 * 16 + 4 + e],
                        acc[t8 * 16 + 8 + e], acc[t8 * 16 + 12 + e], q, c32,
                        c32s, qinv, qoff);
            const uint32_t v1 =
                reasm64(acc[t8 * 16 + e + 1], acc[t8 * 16 + 5 + e],
                        acc[t8 * 16 + 9 + e], acc[t8 * 16 + 13 + e], q, c32,
                        c32s, qinv, qoff);
            // B odd: the last CTA's copy of polynomial B - 1 writes the
            // same values to the same place (no branch near the wgmmas).
            const int gp = min(grp * P + p, B - 1);
            int32_t* o = out + ((size_t)gp * L + l) * N;
            if (FWD) {
              *reinterpret_cast<int2*>(o + r * N2 + t) =
                  make_int2((int32_t)v0, (int32_t)v1);
            } else {
              o[t * N2 + r] = (int32_t)v0;
              o[(t + 1) * N2 + r] = (int32_t)v1;
            }
          }
      });
  K1_MARK(5);
}

using PfnEncode = PFN_cuTensorMapEncodeTiled_v12000;

PfnEncode encode_fn() {
  static PfnEncode fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<PfnEncode>(p);
  }
  return fn;
}

// The table (L, 4S, 4S) int8 as a TMA tensor: tiles of 128 K bytes x nt rows.
bool table_map(CUtensorMap* map, const void* table, int S, int nt, int L) {
  const PfnEncode encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)(4 * S), (cuuint64_t)(4 * S),
                              (cuuint64_t)L};
  const cuuint64_t strides[2] = {(cuuint64_t)(4 * S), (cuuint64_t)(16 * S * S)};
  const cuuint32_t box[3] = {128, (cuuint32_t)nt, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(table),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N1, int N2, bool FWD>
int launch_wg(void* out, const void* x, const void* w1, const void* w2,
              const void* mid, const WgConsts& kc, int B, int L,
              cudaStream_t stream) {
  constexpr int N = N1 * N2;
  constexpr int P = N <= 8192 ? 2 : 1;
  constexpr int R1 = FWD ? N2 : N1, S1 = FWD ? N1 : N2;
  constexpr int R2 = FWD ? N1 : N2, S2 = FWD ? N2 : N1;
  constexpr int NT1 = Stage<P * R1 / 128, S1, kRingBytes>::NT;
  constexpr int NT2 = Stage<P * R2 / 128, S2, kRingBytes + 4 * P * N>::NT;
  CUtensorMap m1, m2;
  if (!table_map(&m1, FWD ? w1 : w2, S1, NT1, L) ||
      !table_map(&m2, FWD ? w2 : w1, S2, NT2, L))
    return (int)cudaErrorInvalidValue;
  const int smem = 8 * P * N + kRingBytes + 2 * kBarSet + 8 + 1024;
  auto kernel = ntt_wg_kernel<N1, N2, FWD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = L * ((B + P - 1) / P);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      m1, m2, (int32_t*)out, (const int32_t*)x, (const int2*)mid, kc, B, L);
  return (int)cudaGetLastError();
}

template <int N1, int N2>
int launch_wg_dir(void* out, const void* x, const void* w1, const void* w2,
                  const void* mid, const WgConsts& kc, int B, int L,
                  int forward, cudaStream_t stream) {
  return forward
             ? launch_wg<N1, N2, true>(out, x, w1, w2, mid, kc, B, L, stream)
             : launch_wg<N1, N2, false>(out, x, w1, w2, mid, kc, B, L, stream);
}

}  // namespace

// The mma.sync body (rings with n1 or n2 < 64).
// x, out: (B, L, N) int32, N = n1*n2 with n1, n2 multiples of 16, <= 128.
// w1: (L, 4*n1, 4*n1) int8 n-major (MxuNttTables.w*), w2: (L, 4*n2, 4*n2),
// mid: (L, N) int32, mid_shoup: (L, N) int64; limb_consts: host
// uint32[4][32] (q, 2^32 mod q, its Shoup word, the plane offset mod q).
extern "C" int fhe_ntt_mxu_sync(void* out, const void* x, const void* w1,
                           const void* w2, const void* mid,
                           const void* mid_shoup, const void* limb_consts,
                           int B, int L, int n1, int n2, int forward,
                           void* stream) {
  LimbConsts kc;
  std::memcpy(&kc, limb_consts, 4 * sizeof(kc.q));
  for (int l = 0; l < kMaxLimbs; ++l)
    kc.qinv[l] = kc.q[l] ? (uint32_t)((1ull << 32) / kc.q[l]) : 0;
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

// The wgmma body (n1, n2 in {64, 128}).
// x, out: (B, L, N) int32; w1: (L, 4*n1, 4*n1) int8 and w2: (L, 4*n2, 4*n2)
// in wg_layout (ntt/mxu.py); mid_pair: (L, N, 2) int32, each twiddle beside
// the low word of its Shoup companion; limb_consts: host uint32[4][32] as
// for fhe_ntt_mxu_sync.
extern "C" int fhe_ntt_mxu_wg(void* out, const void* x, const void* w1,
                              const void* w2, const void* mid_pair,
                              const void* limb_consts, int B, int L, int n1,
                              int n2, int forward, void* stream) {
  uint32_t c[4][kMaxLimbs];
  std::memcpy(c, limb_consts, sizeof(c));
  WgConsts kc;
  for (int l = 0; l < kMaxLimbs; ++l) {
    kc.q[l] = c[0][l];
    kc.c32[l] = c[1][l];
    kc.c32_shoup[l] = c[2][l];
    kc.qinv[l] = c[0][l] ? (uint32_t)((1ull << 32) / c[0][l]) : 0;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (n1 == 64 && n2 == 64)
    return launch_wg_dir<64, 64>(out, x, w1, w2, mid_pair, kc, B, L, forward, s);
  if (n1 == 64 && n2 == 128)
    return launch_wg_dir<64, 128>(out, x, w1, w2, mid_pair, kc, B, L, forward,
                                  s);
  if (n1 == 128 && n2 == 64)
    return launch_wg_dir<128, 64>(out, x, w1, w2, mid_pair, kc, B, L, forward,
                                  s);
  if (n1 == 128 && n2 == 128)
    return launch_wg_dir<128, 128>(out, x, w1, w2, mid_pair, kc, B, L, forward,
                                   s);
  return (int)cudaErrorInvalidValue;
}

#ifdef K1_PHASE_TRACE
extern "C" int fhe_k1_phase_trace(void* host, int count) {
  return (int)cudaMemcpyFromSymbol(host, k1_phase_trace,
                                   sizeof(long long) * count);
}
#endif
