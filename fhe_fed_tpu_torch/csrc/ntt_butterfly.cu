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
//   * one thread block per (poly, limb) of a (B, L, N) int32 batch (two at
//     N = 65536, below); the whole polynomial stays in dynamic shared
//     memory for all stages (128 KB at N = 32768, of the 227 KB a block may
//     have), so each coefficient is
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
// registers and warp shuffles for the last five stages, and one kernel
// that fuses the key switch's intt -> lift -> ntt.
//
// N = 65536: 256 KB of residues do not fit one block's 227 KB, so a
// polynomial takes two blocks, each holding one 128 KB half (H = 2; N <=
// 32768 keeps the one-block body, H = 1). Only one stage spans the halves:
// the forward's first (t = N/2, twiddle tab[1]) and the inverse's last
// (t = N/2, itab[1], then N^-1). Every other stage is the one-block code on
// a half, its twiddle index offset by the half's first block of the stage
// (tab[m + h*m/2 + i]). The forward's first stage runs as the halves are
// loaded: each block reads both halves from device memory (the partner's
// from L2, where its own block has just brought it) and keeps its own
// outputs, so the forward needs no cluster. The inverse's last stage needs
// the other half as it stands after stage log2(N) - 1: the two blocks form
// a thread-block cluster, and each reads its partner's half over
// distributed shared memory after a cluster barrier, writes its outputs,
// and waits at a second barrier so that its own half outlives the
// partner's reads.

#include <cstdint>
#include <cstring>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLimbs = 64;
constexpr int kMaxThreads = 1024;
constexpr int kMinRing = 256;
constexpr int kMaxBlockRing = 32768;   // one block's shared memory
constexpr int kMaxRing = 65536;        // two blocks

struct NttConsts {               // host layout: uint32[3][kMaxLimbs]
  uint32_t q[kMaxLimbs];
  uint32_t ninv[kMaxLimbs];      // N^-1 mod q
  uint32_t ninv_shoup[kMaxLimbs];
};

__device__ __forceinline__ uint4 scale4(uint4 v, uint32_t w, uint32_t ws,
                                        uint32_t q) {
  return make_uint4(mul_mod_shoup(v.x, w, ws, q), mul_mod_shoup(v.y, w, ws, q),
                    mul_mod_shoup(v.z, w, ws, q), mul_mod_shoup(v.w, w, ws, q));
}

__device__ __forceinline__ uint4 add4(uint4 a, uint4 b, uint32_t q) {
  return make_uint4(add_mod(a.x, b.x, q), add_mod(a.y, b.y, q),
                    add_mod(a.z, b.z, q), add_mod(a.w, b.w, q));
}

__device__ __forceinline__ uint4 sub4(uint4 a, uint4 b, uint32_t q) {
  return make_uint4(sub_mod(a.x, b.x, q), sub_mod(a.y, b.y, q),
                    sub_mod(a.z, b.z, q), sub_mod(a.w, b.w, q));
}

// H blocks per polynomial (1, or 2 at N = 65536), block h holding residues
// [h*N/H, (h+1)*N/H).
template <bool kForward, int H>
__global__ void __launch_bounds__(kMaxThreads)
ntt_butterfly_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x,
                     const uint2* __restrict__ tw, const NttConsts c, int L,
                     int log_n) {
  extern __shared__ __align__(16) uint32_t s[];
  const int n = 1 << log_n;
  const int nl = n / H;                  // residues this block holds
  const int half = nl >> 1;              // butterflies per stage
  const long long poly = blockIdx.x / H;
  const int h = H == 1 ? 0 : (int)(blockIdx.x % H);
  const int l = (int)(poly % L);
  const uint32_t q = c.q[l];
  const uint2* twl = tw + (size_t)l * n;

  const uint4* src = reinterpret_cast<const uint4*>(x + poly * n);
  uint4* s4 = reinterpret_cast<uint4*>(s);
  if constexpr (kForward && H == 2) {
    // The first stage pairs i with i + N/2 under tab[1]: block 0 keeps the
    // sums, block 1 the differences.
    const uint2 w = __ldg(twl + 1);
    for (int i = threadIdx.x; i < nl / 4; i += blockDim.x) {
      const uint4 u = __ldg(src + i);
      const uint4 v = scale4(__ldg(src + nl / 4 + i), w.x, w.y, q);
      s4[i] = h == 0 ? add4(u, v, q) : sub4(u, v, q);
    }
  } else {
    for (int i = threadIdx.x; i < nl / 4; i += blockDim.x)
      s4[i] = __ldg(src + h * (nl / 4) + i);
  }
  __syncthreads();

  uint4* dst = reinterpret_cast<uint4*>(out + poly * n + h * nl);
  if constexpr (kForward) {
    // Stage of m blocks of span t = 2^log_t: butterfly j pairs
    // i0 = 2*t*(j/t) + j%t with i0 + t under twiddle tab[m + j/t], j/t
    // counted from this half's first block of the stage, h*m/H.
    int log_t = log_n - H;
    for (int m = H; m < n; m <<= 1, --log_t) {
      const int tmask = (1 << log_t) - 1;
      const uint2* twm = twl + m + h * (m / H);
      for (int j = threadIdx.x; j < half; j += blockDim.x) {
        const int i = j >> log_t;
        const int i0 = (i << (log_t + 1)) + (j & tmask);
        const int i1 = i0 + (1 << log_t);
        const uint2 w = __ldg(twm + i);
        const uint32_t u = s[i0];
        const uint32_t v = mul_mod_shoup(s[i1], w.x, w.y, q);
        s[i0] = add_mod(u, v, q);
        s[i1] = sub_mod(u, v, q);
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < nl / 4; i += blockDim.x) dst[i] = s4[i];
  } else {
    // Stage of hb blocks of span t = 2^log_t, t = 1 .. N/(2H), twiddle
    // itab[hb + j/t], j/t counted from this half's first block, h*hb/H.
    int log_t = 0;
    for (int hb = n >> 1; hb >= H; hb >>= 1, ++log_t) {
      const int tmask = (1 << log_t) - 1;
      const uint2* twh = twl + hb + h * (hb / H);
      for (int j = threadIdx.x; j < half; j += blockDim.x) {
        const int i = j >> log_t;
        const int i0 = (i << (log_t + 1)) + (j & tmask);
        const int i1 = i0 + (1 << log_t);
        const uint2 w = __ldg(twh + i);
        const uint32_t x0 = s[i0];
        const uint32_t x1 = s[i1];
        s[i0] = add_mod(x0, x1, q);
        s[i1] = mul_mod_shoup(sub_mod(x0, x1, q), w.x, w.y, q);
      }
      __syncthreads();
    }
    const uint32_t ni = c.ninv[l];
    const uint32_t nis = c.ninv_shoup[l];
    if constexpr (H == 1) {
      for (int i = threadIdx.x; i < nl / 4; i += blockDim.x)
        dst[i] = scale4(s4[i], ni, nis, q);
    } else {
      // The last stage pairs i with i + N/2 under itab[1]: the partner's
      // half over distributed shared memory.
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      const uint4* p4 =
          reinterpret_cast<const uint4*>(cluster.map_shared_rank(s, h ^ 1));
      const uint2 w = __ldg(twl + 1);
      for (int i = threadIdx.x; i < nl / 4; i += blockDim.x) {
        const uint4 x0 = h == 0 ? s4[i] : p4[i];
        const uint4 x1 = h == 0 ? p4[i] : s4[i];
        const uint4 r = h == 0 ? add4(x0, x1, q)
                               : scale4(sub4(x0, x1, q), w.x, w.y, q);
        dst[i] = scale4(r, ni, nis, q);
      }
      cluster.sync();
    }
  }
}

template <bool kForward, int H>
int launch(int32_t* out, const int32_t* x, const uint2* tw,
           const NttConsts& c, int B, int L, int log_n, cudaStream_t stream) {
  auto kern = &ntt_butterfly_kernel<kForward, H>;
  const int nl = (1 << log_n) / H;
  const int smem = nl * (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)B * L * H));
  cfg.blockDim = dim3(nl / 2 < kMaxThreads ? nl / 2 : kMaxThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (!kForward && H == 2) {    // the inverse's two halves form a cluster
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kern, out, x, tw, c, L, log_n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (B, L, n) int32 residues, 16-byte aligned; tw: (L, n, 2) int32
// (twiddle, low 32 bits of its Shoup word), forward or inverse tables;
// consts: host NttConsts. n a power of two in [256, 65536], 1 <= L <= 64.
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
  int32_t* o = static_cast<int32_t*>(out);
  const int32_t* xi = static_cast<const int32_t*>(x);
  const uint2* t = static_cast<const uint2*>(tw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kMaxBlockRing)
    return forward ? launch<true, 1>(o, xi, t, c, B, L, log_n, s)
                   : launch<false, 1>(o, xi, t, c, B, L, log_n, s);
  return forward ? launch<true, 2>(o, xi, t, c, B, L, log_n, s)
                 : launch<false, 2>(o, xi, t, c, B, L, log_n, s);
}
