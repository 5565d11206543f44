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
// output byte written once (K+1 passes of 16 MB per client ciphertext at the
// bench shape), against 2 Shoup multiplies per 4 bytes. Design: one thread
// per 4 coefficients with 16-byte loads and stores, neighbouring threads on
// neighbouring addresses; the client loop runs inside the thread, so each
// client's ciphertext is read once, for any K from 1 to 65536; the moduli
// are a by-value kernel argument (constant bank); the (K, live) weights and
// the low 32 bits of their Shoup words come in pairs from a small device
// buffer, one 8-byte load through the read-only cache per client and
// thread (a warp's threads share the pair, so it is a broadcast). The entry
// point stages the pairs from host memory with cudaMemcpyAsync on the
// launch stream: from pageable memory that returns once the bytes are
// staged, without waiting for the stream, so the host keeps queueing work.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kMaxClients = 65536;
constexpr int kMaxLimbs = 16;
constexpr int kThreads = 256;

struct WsModuli {               // host layout: uint32[kMaxLimbs]
  uint32_t q[kMaxLimbs];
};

__device__ __forceinline__ uint4 scale4(uint4 v, uint32_t w, uint32_t ws,
                                        uint32_t q) {
  return make_uint4(mul_mod_shoup(v.x, w, ws, q), mul_mod_shoup(v.y, w, ws, q),
                    mul_mod_shoup(v.z, w, ws, q), mul_mod_shoup(v.w, w, ws, q));
}

__global__ void __launch_bounds__(kThreads)
weighted_sum_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x,
                    const uint2* __restrict__ w, const WsModuli c, int K,
                    int live, int n, long long per_client) {
  const long long e =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;   // element index
  if (e >= per_client) return;
  const int l = (int)((e / n) % live);
  const uint32_t q = c.q[l];
  uint2 wk = __ldg(w + l);
  uint4 acc = scale4(__ldg(reinterpret_cast<const uint4*>(x + e)), wk.x, wk.y,
                     q);
  for (int k = 1; k < K; ++k) {
    wk = __ldg(w + (size_t)k * live + l);
    const uint4 t = scale4(
        __ldg(reinterpret_cast<const uint4*>(x + k * per_client + e)), wk.x,
        wk.y, q);
    acc = make_uint4(add_mod(acc.x, t.x, q), add_mod(acc.y, t.y, q),
                     add_mod(acc.z, t.z, q), add_mod(acc.w, t.w, q));
  }
  *reinterpret_cast<uint4*>(out + e) = acc;
}

}  // namespace

// x: (K, per_client) int32 with per_client = chunks*2*live*n, n % 4 == 0;
// out: (per_client,) int32; w_host: host (K, live, 2) uint32 pairs (weight,
// low 32 bits of its Shoup word), copied into w, a device buffer of the
// same size; moduli: host WsModuli; 1 <= K <= 65536, 1 <= live <= 16.
extern "C" int fhe_weighted_sum(void* out, const void* x, void* w,
                                const void* w_host, const void* moduli,
                                int K, int live, int n, long long per_client,
                                void* stream) {
  if (K < 1 || K > kMaxClients || live < 1 || live > kMaxLimbs)
    return (int)cudaErrorInvalidValue;
  WsModuli c;
  std::memcpy(&c, moduli, sizeof(c));
  cudaError_t err =
      cudaMemcpyAsync(w, w_host, (size_t)K * live * sizeof(uint2),
                      cudaMemcpyHostToDevice, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const long long vecs = per_client / 4;
  const long long blocks = (vecs + kThreads - 1) / kThreads;
  weighted_sum_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)x, (const uint2*)w, c, K, live, n,
      per_client);
  return (int)cudaGetLastError();
}
