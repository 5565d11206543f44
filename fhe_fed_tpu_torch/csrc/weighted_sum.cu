// Kernel K3: the encrypted FedAvg weighted sum,
//   out = sum_k x_k * w_{k,l} mod q_l,
// over stacked ciphertexts (K, chunks, 2, live, N) -> (chunks, 2, live, N).
//
// Replaces fhe_fed_tpu/ckks/pallas_agg.py::_ws_kernel (reached through
// weighted_sum_fused). Bit-identical to both lowerings of
// ckks/ops.py::_weighted_sum_impl (the K <= 8 chain and modsum_clients):
// every step is exact modular arithmetic on canonical residues.
//
// What bounds it: device memory. Each input byte is read once and each
// output byte written once (K + 1 passes of 53.5 MB at the bench shape
// (3, 204, 2, 4, 8192): 214 MB, 0.064 ms at 3.35 TB/s), against two Shoup
// multiplies per 4 bytes. Design, all of it to keep bytes in flight and
// the host out of the way:
//   * a grid of (row, column tile), a row being one (chunk, c, l)
//     polynomial of N residues, so the limb is row % live, once per block
//     (no 64-bit division per thread);
//   * each thread takes two 16-byte vectors of every client, a block's
//     threads neighbouring addresses; for K <= 8 the kernel is a template
//     on K and issues all 2K loads before any arithmetic; a larger K runs a
//     loop that issues the loads of four clients at a time;
//   * the inputs are read once: ld.global.nc.L1::no_allocate, and the sum
//     is stored with st.global.cs (evict-first);
//   * no host copy per call: the live moduli and, where K * live <= 384,
//     the (weight, low word of its Shoup companion) pairs are one by-value
//     parameter block (__grid_constant__, read through the constant bank;
//     96 bytes of pairs at K = 3, live 4); above that (up to K = 65536) the
//     pairs come from a device buffer the wrapper stages from pinned host
//     memory.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kMaxClients = 65536;
constexpr int kMaxLive = 32;     // make_params reaches 27 live limbs
constexpr int kParamPairs = 384; // pairs passed by value (3,072 bytes)
constexpr int kThreads = 256;
constexpr int kVecs = 2;         // 16-byte vectors per thread and client
constexpr int kTile = kThreads * 4 * kVecs;   // residues per block

struct WsParams {                // host layout: the block weight_block builds
  uint32_t q[kMaxLive];
  uint2 w[kParamPairs];          // [k * live + l]
};

__device__ __forceinline__ uint4 ld_once(const int32_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 scale4(uint4 v, uint2 w, uint32_t q) {
  return make_uint4(mul_mod_shoup(v.x, w.x, w.y, q),
                    mul_mod_shoup(v.y, w.x, w.y, q),
                    mul_mod_shoup(v.z, w.x, w.y, q),
                    mul_mod_shoup(v.w, w.x, w.y, q));
}

__device__ __forceinline__ uint4 add4(uint4 a, uint4 b, uint32_t q) {
  return make_uint4(add_mod(a.x, b.x, q), add_mod(a.y, b.y, q),
                    add_mod(a.z, b.z, q), add_mod(a.w, b.w, q));
}

// KT in 1..8: exactly KT clients, every load issued first. KT == 0: any K,
// four clients' loads at a time.
template <int KT>
__global__ void __launch_bounds__(kThreads)
weighted_sum_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x,
                    const uint2* __restrict__ wdev,
                    const __grid_constant__ WsParams p, int K, int live,
                    int n, long long per_client) {
  const int row = blockIdx.x;
  const int l = row % live;
  const uint32_t q = p.q[l];
  const int e0 = blockIdx.y * kTile + threadIdx.x * 4;
  const size_t base = (size_t)row * n + e0;
  bool ok[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) ok[j] = e0 + j * kThreads * 4 < n;
  auto pair = [&](int k) -> uint2 {
    return wdev != nullptr ? __ldg(wdev + (size_t)k * live + l)
                           : p.w[k * live + l];
  };
  auto src = [&](int k, int j) {
    return x + (size_t)k * per_client + base + j * kThreads * 4;
  };
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 acc[kVecs];
  if constexpr (KT > 0) {
    uint4 v[KT][kVecs];
#pragma unroll
    for (int k = 0; k < KT; ++k)
#pragma unroll
      for (int j = 0; j < kVecs; ++j)
        v[k][j] = ok[j] ? ld_once(src(k, j)) : zero;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const uint2 w = pair(k);
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const uint4 t = scale4(v[k][j], w, q);
        acc[j] = k == 0 ? t : add4(acc[j], t, q);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) acc[j] = zero;
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      uint4 v[4][kVecs];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kVecs; ++j)
          v[i][j] = ok[j] ? ld_once(src(k + i, j)) : zero;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint2 w = pair(k + i);
#pragma unroll
        for (int j = 0; j < kVecs; ++j)
          acc[j] = add4(acc[j], scale4(v[i][j], w, q), q);
      }
    }
    for (; k < K; ++k) {
      const uint2 w = pair(k);
#pragma unroll
      for (int j = 0; j < kVecs; ++j)
        if (ok[j]) acc[j] = add4(acc[j], scale4(ld_once(src(k, j)), w, q), q);
    }
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j)
    if (ok[j])
      __stcs(reinterpret_cast<uint4*>(out + base + j * kThreads * 4), acc[j]);
}

template <int KT>
int launch(int32_t* out, const int32_t* x, const uint2* wdev,
           const WsParams& p, int K, int live, int n, int rows,
           cudaStream_t stream) {
  const dim3 grid((unsigned)rows, (unsigned)((n + kTile - 1) / kTile));
  weighted_sum_kernel<KT><<<grid, kThreads, 0, stream>>>(
      out, x, wdev, p, K, live, n, (long long)rows * n);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (K, rows, n) int32 with rows = chunks*2*live and n % 4 == 0; out:
// (rows, n) int32; block: host uint32 [live moduli | (K, live, 2) pairs of
// the weight and the low 32 bits of its Shoup word] (pallas_agg.
// weight_block); wdev: null when K * live <= 384 (the pairs then go by
// value), else a device copy of the pairs. 1 <= K <= 65536,
// 1 <= live <= 32.
extern "C" int fhe_weighted_sum(void* out, const void* x, const void* wdev,
                                const void* block, int K, int live, int n,
                                int rows, void* stream) {
  if (K < 1 || K > kMaxClients || live < 1 || live > kMaxLive || n % 4 ||
      rows < 1 || (wdev == nullptr && K * live > kParamPairs))
    return (int)cudaErrorInvalidValue;
  WsParams p;
  std::memset(&p, 0, sizeof(p));
  const uint32_t* b = static_cast<const uint32_t*>(block);
  std::memcpy(p.q, b, sizeof(uint32_t) * live);
  if (wdev == nullptr) std::memcpy(p.w, b + live, sizeof(uint2) * K * live);
  int32_t* o = static_cast<int32_t*>(out);
  const int32_t* xi = static_cast<const int32_t*>(x);
  const uint2* w = static_cast<const uint2*>(wdev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch<1>(o, xi, w, p, K, live, n, rows, s);
    case 2: return launch<2>(o, xi, w, p, K, live, n, rows, s);
    case 3: return launch<3>(o, xi, w, p, K, live, n, rows, s);
    case 4: return launch<4>(o, xi, w, p, K, live, n, rows, s);
    case 5: return launch<5>(o, xi, w, p, K, live, n, rows, s);
    case 6: return launch<6>(o, xi, w, p, K, live, n, rows, s);
    case 7: return launch<7>(o, xi, w, p, K, live, n, rows, s);
    case 8: return launch<8>(o, xi, w, p, K, live, n, rows, s);
    default: return launch<0>(o, xi, w, p, K, live, n, rows, s);
  }
}
