// Key splits on the card: jax.random.split under threefry2x32, bit for bit,
// in one launch for a whole key batch.
//
// Replaces no Pallas kernel: it is XLA's lowering of the threefry2x32 hash
// that jax/_src/prng.py `_threefry_split_foldlike` reaches, which the port's
// plain version (fhe_fed_tpu_torch/utils/threefry.py `split_plain`) runs as
// some 175 int64 torch ops a split. Split word pair i of key (k0, k1) is
// threefry2x32 of the counter words (i >> 32, i & 0xFFFFFFFF): 20 rounds
// with the rotations (13, 15, 26, 6) / (17, 29, 16, 24) and the key
// schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA), injected every 4 rounds with
// the injection count added to the second word. rbg keys split each of
// their two halves so (utils/prng.py), as a batch of twice the keys.
//
// What bounds it: neither bytes nor operations. A split reads 16 bytes a
// key and writes 16 a counter, and hashes some 80 integer instructions a
// counter; at the path's sizes (1 to a few hundred keys, 2 to a few
// hundred counters) that is nanoseconds of work, so the launch itself
// sets its time. Design: one thread an output word pair, 32-bit words in
// registers, the rounds unrolled, one 16-byte store a thread; the key
// words read from device memory, so nothing goes to the host and the
// split queues like any other kernel.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[4 * (i % 2) + j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(x0, x1);
}

__global__ void __launch_bounds__(kThreads)
threefry_split_kernel(long long* __restrict__ out,
                      const long long* __restrict__ key, long long num,
                      long long total) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long b = t / num;                    // the key
  const unsigned long long i = t - b * num;       // its counter
  const uint2 y = threefry2x32((uint32_t)__ldg(key + 2 * b),
                               (uint32_t)__ldg(key + 2 * b + 1),
                               (uint32_t)(i >> 32), (uint32_t)i);
  reinterpret_cast<longlong2*>(out)[t] = make_longlong2(y.x, y.y);
}

}  // namespace

// out: (nkeys, num, 2) int64 words, 16-byte aligned; key: (nkeys, 2) int64
// key words (their low 32 bits are the words) on the device. Returns
// cudaGetLastError() after the launch.
extern "C" int fhe_threefry_split(long long* out, const long long* key,
                                  long long nkeys, long long num,
                                  void* stream) {
  if (out == nullptr || key == nullptr || nkeys < 1 || num < 1)
    return (int)cudaErrorInvalidValue;
  const long long total = nkeys * num;
  const long long grid = (total + kThreads - 1) / kThreads;
  if (total / num != nkeys || grid > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  threefry_split_kernel<<<(unsigned)grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(out, key, num,
                                                               total);
  return (int)cudaGetLastError();
}
