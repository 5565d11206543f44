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
// What bounds it on an H100: not device-memory bytes (at the rotation
// path's (1, 8, 9, 32768) forward, 9.4 MB in and out, ~3 us at 3.35 TB/s)
// but instruction issue. Each SM holds one 128 KB polynomial at N = 32768
// and runs its 15 x 16384 butterflies on the CUDA cores, whose integer
// instructions issue at half rate. So the design cuts instructions and
// barriers per butterfly:
//
//   * one thread block per (poly, limb) of a (B, L, N) int32 batch (two at
//     N = 65536, below); the polynomial stays in dynamic shared memory
//     (128 KB at N = 32768, of the 227 KB a block may have) and each
//     coefficient is read from and written to device memory once;
//   * the S = log2(residues a block holds) stages run in GROUPS of up to
//     five consecutive stages. For a group a thread takes 2^K residues (a
//     "unit": base + r * stride, r < 2^K, stride the group's smallest span)
//     into registers, runs the group's K * 2^(K-1) butterflies there with
//     compile-time register indices, and writes them back; one
//     __syncthreads() follows each group, not each stage. At N = 32768 the
//     15 stages are three groups of five: 3 barriers instead of 15, ~0.8
//     shared-memory accesses a butterfly instead of 4, and the index
//     arithmetic done once per unit;
//   * the group whose spans are 1 .. 16 (the forward's last, the inverse's
//     first) holds 32 contiguous residues a thread. Its shared accesses
//     are 16-byte vectors, and shared memory is XOR-swizzled (word a lives
//     at a ^ (((a >> 5) & 7) << 2): the 16-byte chunk index is XORed with
//     bits 3..5 of itself), so the eight threads of each quarter warp hit
//     eight different chunks of one 32-word row, no bank conflict. Every
//     other group has stride >= 32 (the split below puts the five-stage
//     group at that end), so a warp reads 32 consecutive words of one row
//     for each r, which the swizzle only permutes: conflict-free too;
//   * the load from device memory is folded into the first group, with no
//     shared round trip: the forward's strided group reads 4 bytes a
//     thread, a warp's 32 on 128 consecutive bytes; the inverse's
//     contiguous group 16 bytes a thread, 128 contiguous bytes a thread,
//     which L1 gathers. The store is not folded: the contiguous group's
//     16-byte stores would put a warp's 32 on 32 lines, and the strided
//     group's 4-byte stores were slower too, so the last group writes
//     back to shared memory like the others, and a coalesced 16-byte
//     copy-out follows (times N^-1 for the inverse). Each choice was timed
//     on the H100 against the other (tools/k2_report.py --time);
//   * a twiddle and the low 32 bits of its Shoup word (w < q < 2^31, so the
//     word is < 2^32) come as one 8-byte __ldg from the (L, N, 2) int32
//     copy in ntt/tables.py (tw_fwd / tw_inv), two of them as one 16-byte
//     __ldg where a unit needs two or more in one stage; a unit loads each
//     twiddle of its group once (2^K - 1 loads per 2^K residues);
//   * modular reduction in the two-instruction unsigned-min form (below);
//   * 512 threads a block at most, so up to 128 registers a thread: a unit
//     of 32 residues and its stage's 16 twiddle pairs fit without spills
//     (tools/k2_report.py prints `ptxas -v` and the SASS count).
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

#include <atomic>
#include <cstdint>
#include <cstring>
#include <utility>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLimbs = 64;
constexpr int kMinLogRing = 8;         // N = 256
constexpr int kMaxLogRing = 16;        // two blocks: 65536
constexpr int kGroup = 5;              // stages of the contiguous group

struct NttConsts {               // host layout: uint32[3][kMaxLimbs]
  uint32_t q[kMaxLimbs];
  uint32_t ninv[kMaxLimbs];      // N^-1 mod q
  uint32_t ninv_shoup[kMaxLimbs];
};

// Arithmetic on canonical residues, 0 <= a, b < q < 2^31 (every modulus the
// port uses is a prime below 2^31). Each result is canonical again, so
// nothing is lazy: a lazy [0, 2q) operand of an add could reach 3q > 2^32.
//
//   reduce(r), r < 2q < 2^32: if r >= q, r - q < q <= r; if r < q, r - q
//     wraps to 2^32 - (q - r) > 2^31 > r. So min(r, r - q) is r mod q.
//   add: a + b < 2q, then reduce.
//   sub: d = a - b mod 2^32. If a >= b, d < q and d + q < 2q < 2^32, so
//     min(d, d + q) = d. If a < b, d = 2^32 - (b - a) > 2^31 and d + q wraps
//     to q - (b - a) in (0, q), the min.
//   Shoup: w < q, ws = floor(w * 2^32 / q) < 2^32; for x < 2^32,
//     x*w - floor(x*ws / 2^32)*q lies in [0, 2q), so its low 32 bits are
//     exact; then reduce.
__device__ __forceinline__ uint32_t reduce(uint32_t r, uint32_t q) {
  return min(r, r - q);
}

__device__ __forceinline__ uint32_t addq(uint32_t a, uint32_t b, uint32_t q) {
  return reduce(a + b, q);
}

__device__ __forceinline__ uint32_t subq(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t d = a - b;
  return min(d, d + q);
}

__device__ __forceinline__ uint32_t mulq(uint32_t x, uint32_t w, uint32_t ws,
                                         uint32_t q) {
  return reduce(x * w - __umulhi(x, ws) * q, q);
}

__device__ __forceinline__ uint4 scale4(uint4 v, uint32_t w, uint32_t ws,
                                        uint32_t q) {
  return make_uint4(mulq(v.x, w, ws, q), mulq(v.y, w, ws, q),
                    mulq(v.z, w, ws, q), mulq(v.w, w, ws, q));
}

__device__ __forceinline__ uint4 add4(uint4 a, uint4 b, uint32_t q) {
  return make_uint4(addq(a.x, b.x, q), addq(a.y, b.y, q), addq(a.z, b.z, q),
                    addq(a.w, b.w, q));
}

__device__ __forceinline__ uint4 sub4(uint4 a, uint4 b, uint32_t q) {
  return make_uint4(subq(a.x, b.x, q), subq(a.y, b.y, q), subq(a.z, b.z, q),
                    subq(a.w, b.w, q));
}

// Shared-memory swizzle of word address a, and of 16-byte chunk index c
// (the same map: chunk c holds words 4c .. 4c + 3).
__device__ __forceinline__ int swz(int a) {
  return a ^ (((a >> 5) & 7) << 2);
}

__device__ __forceinline__ int swz4(int c) { return c ^ ((c >> 3) & 7); }

// The stage groups of a block's S in-block stages: the contiguous group of
// kGroup stages (spans 1 .. 16), and the other S - kGroup stages in
// ceil((S - kGroup) / kGroup) groups as even as can be, the larger first
// (S = 15: 5 + 5 | 5; 11: 3 + 3 | 5; 8: 3 | 5). The forward runs them from
// the largest span down, the inverse from span 1 up.
__host__ __device__ constexpr int rest_groups(int S) {
  return (S - 1) / kGroup;
}

__host__ __device__ constexpr int rest_size(int S, int g) {
  return (S - kGroup) / rest_groups(S) +
         (g < (S - kGroup) % rest_groups(S) ? 1 : 0);
}

__host__ __device__ constexpr int threads(int S) {
  return S >= 14 ? 512 : 1 << (S - kGroup);
}

struct Ctx {
  uint32_t* s;                   // the block's residues, swizzled
  const uint32_t* gin;           // device memory: the block's input
  const uint2* tw;               // the limb's (twiddle, Shoup) pairs
  int twk;                       // H + h: stage of m local blocks starts at
                                 // tw[twk * m] (tab[m_global + h * m])
  uint32_t q;
};

// Twiddles sb0 .. sb0 + NB - 1 of one stage, NB <= 16, 16 bytes a load
// where NB >= 2 (the first index is even then, and the table 16-byte
// aligned).
template <int NB>
__device__ __forceinline__ void load_tw(const uint2* t, uint32_t* w,
                                        uint32_t* ws) {
  if constexpr (NB == 1) {
    const uint2 p = __ldg(t);
    w[0] = p.x;
    ws[0] = p.y;
  } else {
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) {
      const uint4 p = __ldg(reinterpret_cast<const uint4*>(t) + i);
      w[2 * i] = p.x;
      ws[2 * i] = p.y;
      w[2 * i + 1] = p.z;
      ws[2 * i + 1] = p.w;
    }
  }
}

// Stage J of a group of K (compile-time, so that every register index is):
// NB twiddles, pairs (r, r + half) with r = sb * 2 * half + r0.
template <int S, int K, int LS, bool kForward, int J>
__device__ __forceinline__ void stage(uint32_t (&v)[1 << K], const Ctx& c,
                                      int b) {
  constexpr int R = 1 << K;
  constexpr int half = kForward ? R >> (J + 1) : 1 << J;
  constexpr int NB = R / (2 * half);
  const uint32_t q = c.q;
  uint32_t w[NB], ws[NB];
  if constexpr (kForward)
    load_tw<NB>(c.tw + ((c.twk * (1 << (S - K - LS)) + b) << J), w, ws);
  else
    load_tw<NB>(c.tw + c.twk * (1 << (S - 1 - J - LS)) + (b << (K - 1 - J)),
                w, ws);
#pragma unroll
  for (int sb = 0; sb < NB; ++sb)
#pragma unroll
    for (int r0 = 0; r0 < half; ++r0) {
      const int r = sb * 2 * half + r0;
      const uint32_t x = v[r];
      if constexpr (kForward) {
        const uint32_t y = mulq(v[r + half], w[sb], ws[sb], q);
        v[r] = addq(x, y, q);
        v[r + half] = subq(x, y, q);
      } else {
        const uint32_t y = v[r + half];
        v[r] = addq(x, y, q);
        v[r + half] = mulq(subq(x, y, q), w[sb], ws[sb], q);
      }
    }
}

template <int S, int K, int LS, bool kForward, int... J>
__device__ __forceinline__ void stages(uint32_t (&v)[1 << K], const Ctx& c,
                                       int b,
                                       std::integer_sequence<int, J...>) {
  (stage<S, K, LS, kForward, J>(v, c, b), ...);
}

// One group of K stages over the block's 2^S residues, unit stride 2^LS.
// Unit u: b = u >> LS, residues base + r * 2^LS with base = b * 2^(LS+K) +
// u % 2^LS. Forward, stage j of the group (span 2^(LS+K-1-j)): local block
// (b << j) + (r >> (K - j)) of m0 << j, m0 = 2^(S-K-LS). Inverse, stage j
// (span 2^(LS+j)): local block (b << (K-1-j)) + (r >> (j + 1)) of
// 2^(S-1-j-LS).
template <int S, int K, int LS, bool kForward, bool kLoadG>
__device__ __forceinline__ void group(const Ctx& c) {
  constexpr int R = 1 << K;
  constexpr int kUnits = 1 << (S - K);
  constexpr int T = threads(S);
  constexpr bool kContig = LS == 0;
  static_assert(!kContig || K == kGroup, "contiguous groups hold 32");
  static_assert(kContig || LS >= 5, "strided groups have stride >= 32");
#pragma unroll
  for (int it = 0; it < kUnits / T; ++it) {
    const int u = it * T + (int)threadIdx.x;
    const int b = u >> LS;
    const int base = (b << (LS + K)) | (u & ((1 << LS) - 1));
    uint32_t v[R];
    if constexpr (kContig) {
      const uint4* src =
          kLoadG ? reinterpret_cast<const uint4*>(c.gin + base) : nullptr;
#pragma unroll
      for (int i = 0; i < R / 4; ++i) {
        const uint4 t = kLoadG
            ? __ldg(src + i)
            : reinterpret_cast<const uint4*>(c.s)[swz4((base >> 2) + i)];
        v[4 * i] = t.x;
        v[4 * i + 1] = t.y;
        v[4 * i + 2] = t.z;
        v[4 * i + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[r] = kLoadG ? __ldg(c.gin + base + (r << LS))
                      : c.s[swz(base + (r << LS))];
    }

    stages<S, K, LS, kForward>(v, c, b, std::make_integer_sequence<int, K>());

    if constexpr (kContig) {
#pragma unroll
      for (int i = 0; i < R / 4; ++i)
        reinterpret_cast<uint4*>(c.s)[swz4((base >> 2) + i)] = make_uint4(
            v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) c.s[swz(base + (r << LS))] = v[r];
    }
  }
}

// The strided groups, G onward, C stages of them done: the forward runs
// them first (the first reads device memory at H = 1), the inverse last.
template <bool kForward, int H, int S, int G, int C>
__device__ __forceinline__ void rest(const Ctx& c) {
  if constexpr (G < rest_groups(S)) {
    constexpr int K = rest_size(S, G);
    constexpr int LS = kForward ? S - C - K : kGroup + C;
    group<S, K, LS, kForward, kForward && H == 1 && G == 0>(c);
    __syncthreads();
    rest<kForward, H, S, G + 1, C + K>(c);
  }
}

// H blocks per polynomial (1, or 2 at N = 65536), block h holding residues
// [h*N/H, (h+1)*N/H); S = log2(N/H).
template <bool kForward, int H, int S>
__global__ void __launch_bounds__(threads(S))
ntt_butterfly_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x,
                     const uint2* __restrict__ tw, const NttConsts c, int L) {
  extern __shared__ __align__(16) uint32_t s[];
  constexpr int nl = 1 << S;             // residues this block holds
  constexpr int n = nl * H;
  const long long poly = blockIdx.x / H;
  const int h = H == 1 ? 0 : (int)(blockIdx.x % H);
  const int l = (int)(poly % L);
  const uint32_t q = c.q[l];
  const uint2* twl = tw + (size_t)l * n;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(x + poly * n);
  uint4* dst4 = reinterpret_cast<uint4*>(out + poly * n + h * nl);
  const Ctx ctx{s, src + h * nl, twl, H + h, q};
  uint4* s4 = reinterpret_cast<uint4*>(s);

  if constexpr (kForward) {
    if constexpr (H == 2) {
      // The first stage pairs i with i + N/2 under tab[1]: block 0 keeps
      // the sums, block 1 the differences.
      const uint4* src4 = reinterpret_cast<const uint4*>(src);
      const uint2 w = __ldg(twl + 1);
      for (int i = threadIdx.x; i < nl / 4; i += blockDim.x) {
        const uint4 u = __ldg(src4 + i);
        const uint4 v = scale4(__ldg(src4 + nl / 4 + i), w.x, w.y, q);
        s4[swz4(i)] = h == 0 ? add4(u, v, q) : sub4(u, v, q);
      }
      __syncthreads();
    }
    rest<true, H, S, 0, 0>(ctx);
    group<S, kGroup, 0, true, false>(ctx);
    __syncthreads();
    for (int i = threadIdx.x; i < nl / 4; i += blockDim.x)
      dst4[i] = s4[swz4(i)];
  } else {
    group<S, kGroup, 0, false, true>(ctx);
    __syncthreads();
    rest<false, H, S, 0, 0>(ctx);
    if constexpr (H == 1) {
      for (int i = threadIdx.x; i < nl / 4; i += blockDim.x)
        dst4[i] = scale4(s4[swz4(i)], c.ninv[l], c.ninv_shoup[l], q);
    } else {
      // The last stage pairs i with i + N/2 under itab[1]: the partner's
      // half over distributed shared memory (swizzled as this one is).
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      const uint4* p4 =
          reinterpret_cast<const uint4*>(cluster.map_shared_rank(s, h ^ 1));
      const uint2 w = __ldg(twl + 1);
      for (int i = threadIdx.x; i < nl / 4; i += blockDim.x) {
        const int k = swz4(i);
        const uint4 x0 = h == 0 ? s4[k] : p4[k];
        const uint4 x1 = h == 0 ? p4[k] : s4[k];
        const uint4 r = h == 0 ? add4(x0, x1, q)
                               : scale4(sub4(x0, x1, q), w.x, w.y, q);
        dst4[i] = scale4(r, c.ninv[l], c.ninv_shoup[l], q);
      }
      cluster.sync();
    }
  }
}

template <bool kForward, int H, int S>
int launch(int32_t* out, const int32_t* x, const uint2* tw,
           const NttConsts& c, int B, int L, cudaStream_t stream) {
  auto kern = &ntt_butterfly_kernel<kForward, H, S>;
  constexpr int smem = (int)sizeof(uint32_t) << S;
  cudaError_t err;
  if constexpr (smem > 48 * 1024) {
    // The shared-memory opt-in, once per device and instantiation.
    static std::atomic<unsigned long long> ready{0};   // bit d: device d
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (!(ready.load(std::memory_order_acquire) & bit)) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      ready.fetch_or(bit, std::memory_order_release);
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)B * L * H));
  cfg.blockDim = dim3(threads(S));
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
  err = cudaLaunchKernelEx(&cfg, kern, out, x, tw, c, L);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool kForward>
int dispatch(int log_n, int32_t* o, const int32_t* x, const uint2* t,
             const NttConsts& c, int B, int L, cudaStream_t s) {
  switch (log_n) {
    case 8: return launch<kForward, 1, 8>(o, x, t, c, B, L, s);
    case 9: return launch<kForward, 1, 9>(o, x, t, c, B, L, s);
    case 10: return launch<kForward, 1, 10>(o, x, t, c, B, L, s);
    case 11: return launch<kForward, 1, 11>(o, x, t, c, B, L, s);
    case 12: return launch<kForward, 1, 12>(o, x, t, c, B, L, s);
    case 13: return launch<kForward, 1, 13>(o, x, t, c, B, L, s);
    case 14: return launch<kForward, 1, 14>(o, x, t, c, B, L, s);
    case 15: return launch<kForward, 1, 15>(o, x, t, c, B, L, s);
    case 16: return launch<kForward, 2, 15>(o, x, t, c, B, L, s);
  }
  return (int)cudaErrorInvalidValue;
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
  if ((1 << log_n) != n || log_n < kMinLogRing || log_n > kMaxLogRing ||
      L < 1 || L > kMaxLimbs || B < 1)
    return (int)cudaErrorInvalidValue;
  NttConsts c;
  std::memcpy(&c, consts, sizeof(c));
  int32_t* o = static_cast<int32_t*>(out);
  const int32_t* xi = static_cast<const int32_t*>(x);
  const uint2* t = static_cast<const uint2*>(tw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return forward ? dispatch<true>(log_n, o, xi, t, c, B, L, s)
                 : dispatch<false>(log_n, o, xi, t, c, B, L, s);
}
