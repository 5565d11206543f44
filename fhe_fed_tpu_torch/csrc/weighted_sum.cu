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
// neighbouring addresses; the client loop runs inside the thread; the
// (K, live) weights, Shoup words and moduli are a by-value kernel argument,
// so they sit in the constant bank.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kMaxClients = 16;
constexpr int kMaxLimbs = 16;
constexpr int kThreads = 256;

struct WsConsts {               // host layout: uint32[1 + 2*kMaxClients][kMaxLimbs]
  uint32_t q[kMaxLimbs];
  uint32_t w[kMaxClients][kMaxLimbs];
  uint32_t w_shoup[kMaxClients][kMaxLimbs];
};

__device__ __forceinline__ uint4 scale4(uint4 v, uint32_t w, uint32_t ws,
                                        uint32_t q) {
  return make_uint4(mul_mod_shoup(v.x, w, ws, q), mul_mod_shoup(v.y, w, ws, q),
                    mul_mod_shoup(v.z, w, ws, q), mul_mod_shoup(v.w, w, ws, q));
}

__global__ void __launch_bounds__(kThreads)
weighted_sum_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x,
                    const WsConsts c, int K, int live, int n,
                    long long per_client) {
  const long long e =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;   // element index
  if (e >= per_client) return;
  const int l = (int)((e / n) % live);
  const uint32_t q = c.q[l];
  uint4 acc = scale4(__ldg(reinterpret_cast<const uint4*>(x + e)), c.w[0][l],
                     c.w_shoup[0][l], q);
  for (int k = 1; k < K; ++k) {
    const uint4 t = scale4(
        __ldg(reinterpret_cast<const uint4*>(x + k * per_client + e)),
        c.w[k][l], c.w_shoup[k][l], q);
    acc = make_uint4(add_mod(acc.x, t.x, q), add_mod(acc.y, t.y, q),
                     add_mod(acc.z, t.z, q), add_mod(acc.w, t.w, q));
  }
  *reinterpret_cast<uint4*>(out + e) = acc;
}

}  // namespace

// x: (K, per_client) int32 with per_client = chunks*2*live*n, n % 4 == 0;
// out: (per_client,) int32; consts: host WsConsts; 1 <= K <= 16, live <= 16.
extern "C" int fhe_weighted_sum(void* out, const void* x, const void* consts,
                                int K, int live, int n, long long per_client,
                                void* stream) {
  WsConsts c;
  std::memcpy(&c, consts, sizeof(c));
  const long long vecs = per_client / 4;
  const long long blocks = (vecs + kThreads - 1) / kThreads;
  weighted_sum_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)x, c, K, live, n, per_client);
  return (int)cudaGetLastError();
}
