// Selective FedAvg's tree on the card: the clients' leaves split by the
// policy and their plaintext remainder averaged where they lie, in three
// launches over one table (fed/tree_average.py builds it, fed/fedavg.py
// `fhe_fedavg` runs them). A leaf is float32 or bfloat16, the same dtype
// in every client; the outputs are float32.
//
// Replaces no Pallas kernel: the JAX package flattens, splits, averages and
// merges a model's tree on the host in numpy (fhe_fed_tpu/fed/fedavg.py),
// and so does the port's host path (flatten_params, split_by_policy, the
// f64 average, merge_by_policy, unflatten_params). For leaf i of n_i values
// with an encrypted prefix of k_i, client c's leaf x_c,i and weight w_c:
//
//   gather:  enc[c][e_i + j] = x_c,i[j]                          j < k_i
//   average: out[o_i + j]  = f32(((+0.0 + w_0 x_0,i[j]) + w_1 x_1,i[j]) ...)
//                                                        k_i <= j < n_i
//   scatter: out[o_i + j]  = dec[e_i + j]                        j < k_i
//
// The average is the host's `sum(w * p.astype(np.float64) ...)` in float64:
// Python's sum starts from +0.0 and adds the clients in order, and
// __dmul_rn / __dadd_rn keep nvcc from contracting a product and a sum into
// an FMA, so each value is the host's bit for bit. A bfloat16 value is the
// top half of a float32's bits, so it is read and widened exactly, and the
// results equal those over the leaves cast to float32 first.
//
// What bounds it: bytes. The average reads K float32 values and writes one
// a position, with 2K float64 operations; gather and scatter copy. Design:
// each launch runs over one flat space (each client's encrypted prefixes,
// or the plain positions in layout order) in tiles of kTile positions,
// kItems a thread with neighbouring threads on neighbouring values of a
// leaf. A tile finds its first and last leaf by binary search over the
// table's offsets, so a tile inside one leaf (nearly every tile of a large
// model) does no search a position, and one across small leaves searches
// only between those two. A thread issues its kItems loads of a client
// before the arithmetic that uses them. The leaves are read in place
// through the table's pointers: nothing is flattened first. Gather and
// average come in three instantiations, chosen by the host from the
// leaves' dtypes: every leaf float32 (the loads of a float32-only kernel),
// every leaf bfloat16, or mixed, where each load reads its leaf's code.
//
// The table, int64 on the device, for L leaves and K clients:
//   [0, L]               e: the leaves' offsets in the encrypted vector
//   [L + 1, 2L + 1]      p: their offsets in the plain positions
//   [2L + 2, 3L + 1]     k: their encrypted prefixes
//   [3L + 2, 4L + 1]     o: their offsets in the output (layout order)
//   [4L + 2, 5L + 1]     d: their dtype codes, 0 float32, 1 bfloat16
//   [5L + 2, 5L + 2 + KL) the leaves' addresses, client by client
//   then K               the weights, as float64 bit patterns

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr long long kTile = (long long)kThreads * kItems;

// The leaves' dtypes over a launch (the host's `mode`).
constexpr int kF32 = 0;
constexpr int kBf16 = 1;
constexpr int kMixed = 2;

struct Table {
  const long long* e;
  const long long* p;
  const long long* k;
  const long long* o;
  const long long* d;
  const long long* x;
  const long long* w;
};

__device__ __forceinline__ Table table_at(const long long* t, int L, int K) {
  Table tb;
  tb.e = t;
  tb.p = t + (L + 1);
  tb.k = tb.p + (L + 1);
  tb.o = tb.k + L;
  tb.d = tb.o + L;
  tb.x = tb.d + L;
  tb.w = tb.x + (long long)K * L;
  return tb;
}

// Value j of client c's leaf i as float32: a float32 load, or a bfloat16
// one widened exactly (its 16 bits as the top half of the float32's).
template <int Mode>
__device__ __forceinline__ float leaf_value(const Table& tb, int L, int c,
                                            int i, long long j) {
  const long long addr = __ldg(tb.x + (long long)c * L + i);
  if (Mode == kBf16 || (Mode == kMixed && __ldg(tb.d + i) != 0)) {
    const unsigned short h =
        __ldg(reinterpret_cast<const unsigned short*>(addr) + j);
    return __uint_as_float((unsigned)h << 16);
  }
  return __ldg(reinterpret_cast<const float*>(addr) + j);
}

// The leaf that holds position q of the space whose leaf offsets are s: the
// largest i in [lo, hi] with s[i] <= q, where s[lo] <= q. An empty leaf
// (s[i] == s[i + 1]) is never the largest such i.
__device__ __forceinline__ int leaf_of(const long long* s, int lo, int hi,
                                       long long q) {
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (__ldg(s + mid) <= q)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// The first and last leaf of the tile [first, last], one search each, by
// two warps at once.
__device__ __forceinline__ int2 tile_leaves(const long long* s, int L,
                                            long long first,
                                            long long last) {
  __shared__ int sh[2];
  if (threadIdx.x == 0) sh[0] = leaf_of(s, 0, L - 1, first);
  if (threadIdx.x == 32) sh[1] = leaf_of(s, 0, L - 1, last);
  __syncthreads();
  return make_int2(sh[0], sh[1]);
}

// Each thread's positions in the tile, their leaves and their offsets in
// those leaves (s: the space's leaf offsets, k: added to the offset).
// Positions past the end repeat the last one, so that every load is in
// bounds; they are not stored.
__device__ __forceinline__ void positions(const long long* s,
                                          const long long* k, int2 span,
                                          long long base, long long last,
                                          long long (&q)[kItems],
                                          int (&leaf)[kItems],
                                          long long (&j)[kItems]) {
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long at = base + it * kThreads + threadIdx.x;
    q[it] = at < last ? at : last;
    leaf[it] = span.x == span.y ? span.x : leaf_of(s, span.x, span.y, q[it]);
    j[it] = q[it] - __ldg(s + leaf[it]) + (k ? __ldg(k + leaf[it]) : 0);
  }
}

template <int Mode>
__global__ void __launch_bounds__(kThreads)
tree_gather_kernel(float* __restrict__ enc, const long long* __restrict__ t,
                   int L, int K, long long count, long long tiles) {
  const Table tb = table_at(t, L, K);
  const int c = (int)(blockIdx.x / tiles);
  const long long base = (blockIdx.x - (long long)c * tiles) * kTile;
  const long long last = min(base + kTile, count) - 1;
  const int2 span = tile_leaves(tb.e, L, base, last);
  long long q[kItems], j[kItems];
  int leaf[kItems];
  positions(tb.e, nullptr, span, base, last, q, leaf, j);
  float v[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it)
    v[it] = leaf_value<Mode>(tb, L, c, leaf[it], j[it]);
  float* row = enc + (long long)c * count;
#pragma unroll
  for (int it = 0; it < kItems; ++it)
    if (base + it * kThreads + threadIdx.x <= last) row[q[it]] = v[it];
}

template <int Mode>
__global__ void __launch_bounds__(kThreads)
tree_average_kernel(float* __restrict__ out, const long long* __restrict__ t,
                    int L, int K, long long count) {
  const Table tb = table_at(t, L, K);
  const long long base = (long long)blockIdx.x * kTile;
  const long long last = min(base + kTile, count) - 1;
  const int2 span = tile_leaves(tb.p, L, base, last);
  long long q[kItems], j[kItems];
  int leaf[kItems];
  positions(tb.p, tb.k, span, base, last, q, leaf, j);
  double acc[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) acc[it] = 0.0;
  for (int c = 0; c < K; ++c) {
    const double w = __longlong_as_double(__ldg(tb.w + c));
    float v[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it)
      v[it] = leaf_value<Mode>(tb, L, c, leaf[it], j[it]);
#pragma unroll
    for (int it = 0; it < kItems; ++it)
      acc[it] = __dadd_rn(acc[it], __dmul_rn(w, (double)v[it]));
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it)
    if (base + it * kThreads + threadIdx.x <= last)
      out[__ldg(tb.o + leaf[it]) + j[it]] = __double2float_rn(acc[it]);
}

__global__ void __launch_bounds__(kThreads)
tree_scatter_kernel(float* __restrict__ out, const float* __restrict__ dec,
                    const long long* __restrict__ t, int L, int K,
                    long long count) {
  const Table tb = table_at(t, L, K);
  const long long base = (long long)blockIdx.x * kTile;
  const long long last = min(base + kTile, count) - 1;
  const int2 span = tile_leaves(tb.e, L, base, last);
  long long q[kItems], j[kItems];
  int leaf[kItems];
  positions(tb.e, nullptr, span, base, last, q, leaf, j);
  float v[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) v[it] = __ldg(dec + q[it]);
#pragma unroll
  for (int it = 0; it < kItems; ++it)
    if (base + it * kThreads + threadIdx.x <= last)
      out[__ldg(tb.o + leaf[it]) + j[it]] = v[it];
}

bool valid(const void* a, const void* b, int leaves, int clients,
           long long count, long long blocks) {
  return a != nullptr && b != nullptr && leaves >= 1 && clients >= 1 &&
         count >= 1 && blocks <= 0x7FFFFFFFll;
}

bool valid_mode(int mode) {
  return mode == kF32 || mode == kBf16 || mode == kMixed;
}

template <int Mode>
void gather(float* enc, const long long* table, int leaves, int clients,
            long long count, long long tiles, cudaStream_t stream) {
  tree_gather_kernel<Mode><<<(unsigned)(tiles * clients), kThreads, 0,
                             stream>>>(enc, table, leaves, clients, count,
                                       tiles);
}

template <int Mode>
void average(float* out, const long long* table, int leaves, int clients,
             long long count, long long tiles, cudaStream_t stream) {
  tree_average_kernel<Mode><<<(unsigned)tiles, kThreads, 0, stream>>>(
      out, table, leaves, clients, count);
}

}  // namespace

// enc: (clients, count) float32, count = e[L], the encrypted vector of
// each client; table as above; mode: kF32 when every leaf is float32,
// kBf16 when every leaf is bfloat16, else kMixed. Returns
// cudaGetLastError() after the launch.
extern "C" int fhe_tree_gather(float* enc, const long long* table,
                               int leaves, int clients, long long count,
                               int mode, void* stream) {
  const long long tiles = (count + kTile - 1) / kTile;
  if (!valid(enc, table, leaves, clients, count, tiles * clients) ||
      !valid_mode(mode))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kF32)
    gather<kF32>(enc, table, leaves, clients, count, tiles, s);
  else if (mode == kBf16)
    gather<kBf16>(enc, table, leaves, clients, count, tiles, s);
  else
    gather<kMixed>(enc, table, leaves, clients, count, tiles, s);
  return (int)cudaGetLastError();
}

// out: the float32 output in layout order (o[L - 1] + n[L - 1] values);
// count = p[L], the plain positions, each written once; mode as above.
extern "C" int fhe_tree_average(float* out, const long long* table,
                                int leaves, int clients, long long count,
                                int mode, void* stream) {
  const long long tiles = (count + kTile - 1) / kTile;
  if (!valid(out, table, leaves, clients, count, tiles) || !valid_mode(mode))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kF32)
    average<kF32>(out, table, leaves, clients, count, tiles, s);
  else if (mode == kBf16)
    average<kBf16>(out, table, leaves, clients, count, tiles, s);
  else
    average<kMixed>(out, table, leaves, clients, count, tiles, s);
  return (int)cudaGetLastError();
}

// dec: (count,) float32, the decrypted average of the encrypted vectors,
// count = e[L]; written into the encrypted positions of out.
extern "C" int fhe_tree_scatter(float* out, const float* dec,
                                const long long* table, int leaves,
                                int clients, long long count, void* stream) {
  const long long tiles = (count + kTile - 1) / kTile;
  if (dec == nullptr || !valid(out, table, leaves, clients, count, tiles))
    return (int)cudaErrorInvalidValue;
  tree_scatter_kernel<<<(unsigned)tiles, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      out, dec, table, leaves, clients, count);
  return (int)cudaGetLastError();
}
