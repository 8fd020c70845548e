// Host radix argsort behind the port's sort and merge host path
// (``h2o_tpu_torch/backend/native.py``) — the C++ analog of the reference's
// distributed radix order (`water/rapids/RadixOrder.java`,
// `SplitByMSBLocal.java`, `BinaryMerge.java`): keys are mapped to
// order-preserving uint64, sorted by byte-wise stable LSB radix passes,
// parallelized per pass with per-thread block histograms + global prefix
// offsets (bucket-major, thread-minor, so each pass stays stable).
//
// Exposed via a C ABI for ctypes. All functions are argsorts: they fill
// `order` with a permutation of [0, n), never moving the caller's data.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

constexpr int kRadixBits = 8;
constexpr int kBuckets = 1 << kRadixBits;  // 256

inline int hardware_threads(int requested) {
  if (requested > 0) return requested;
  unsigned hc = std::thread::hardware_concurrency();
  return hc ? static_cast<int>(hc) : 4;
}

// One stable counting pass over byte `shift/8`, scattering idx_in -> idx_out.
// Parallel and stable: threads own contiguous input blocks; global offsets
// are (bucket-major, thread-minor) prefix sums so block order is preserved.
void radix_pass(const uint64_t* keys, const int64_t* idx_in, int64_t* idx_out,
                int64_t n, int shift, int nthreads) {
  const int64_t block = (n + nthreads - 1) / nthreads;
  std::vector<std::vector<int64_t>> hist(nthreads,
                                         std::vector<int64_t>(kBuckets, 0));

  auto count_fn = [&](int t) {
    const int64_t lo = t * block, hi = std::min<int64_t>(n, lo + block);
    auto& h = hist[t];
    for (int64_t i = lo; i < hi; ++i) {
      h[(keys[idx_in[i]] >> shift) & (kBuckets - 1)]++;
    }
  };
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < nthreads; ++t) ts.emplace_back(count_fn, t);
    for (auto& th : ts) th.join();
  }

  // exclusive prefix over (bucket, thread)
  int64_t run = 0;
  for (int b = 0; b < kBuckets; ++b) {
    for (int t = 0; t < nthreads; ++t) {
      int64_t c = hist[t][b];
      hist[t][b] = run;
      run += c;
    }
  }

  auto scatter_fn = [&](int t) {
    const int64_t lo = t * block, hi = std::min<int64_t>(n, lo + block);
    auto& h = hist[t];
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t src = idx_in[i];
      idx_out[h[(keys[src] >> shift) & (kBuckets - 1)]++] = src;
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; ++t) ts.emplace_back(scatter_fn, t);
  for (auto& th : ts) th.join();
}

// Which byte positions actually vary? Skipping constant bytes is the radix
// analog of RadixOrder's column-range compression.
uint64_t key_or_xor_mask(const uint64_t* keys, int64_t n, int nthreads) {
  if (n == 0) return 0;
  const int64_t block = (n + nthreads - 1) / nthreads;
  std::vector<uint64_t> acc(nthreads, 0);
  auto fn = [&](int t) {
    const int64_t lo = t * block, hi = std::min<int64_t>(n, lo + block);
    uint64_t m = 0;
    const uint64_t first = keys[0];
    for (int64_t i = lo; i < hi; ++i) m |= keys[i] ^ first;
    acc[t] = m;
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; ++t) ts.emplace_back(fn, t);
  for (auto& th : ts) th.join();
  uint64_t m = 0;
  for (uint64_t a : acc) m |= a;
  return m;
}

}  // namespace

extern "C" {

// Stable argsort of uint64 keys (order-preserving transforms applied by the
// Python caller). `order` must hold n int64; used as both scratch and result.
void h2otpu_radix_argsort_u64(const uint64_t* keys, int64_t n, int64_t* order,
                              int nthreads) {
  nthreads = hardware_threads(nthreads);
  std::vector<int64_t> tmp(n);
  int64_t* a = order;
  int64_t* b = tmp.data();
  for (int64_t i = 0; i < n; ++i) a[i] = i;

  const uint64_t varying = key_or_xor_mask(keys, n, nthreads);
  for (int shift = 0; shift < 64; shift += kRadixBits) {
    if (((varying >> shift) & (kBuckets - 1)) == 0) continue;  // constant byte
    radix_pass(keys, a, b, n, shift, nthreads);
    std::swap(a, b);
  }
  if (a != order) std::memcpy(order, a, sizeof(int64_t) * n);
}

// Stable argsort refinement: re-sorts an EXISTING permutation by new keys
// (stable ⇒ prior key order is the tiebreak). This is the lexsort building
// block: apply from least-significant key column to most.
void h2otpu_radix_refine_u64(const uint64_t* keys, int64_t n, int64_t* order,
                             int nthreads) {
  nthreads = hardware_threads(nthreads);
  std::vector<int64_t> tmp(n);
  int64_t* a = order;
  int64_t* b = tmp.data();
  const uint64_t varying = key_or_xor_mask(keys, n, nthreads);
  for (int shift = 0; shift < 64; shift += kRadixBits) {
    if (((varying >> shift) & (kBuckets - 1)) == 0) continue;
    radix_pass(keys, a, b, n, shift, nthreads);
    std::swap(a, b);
  }
  if (a != order) std::memcpy(order, a, sizeof(int64_t) * n);
}

// Gather: out[i] = keys[order[i]] — parallel permutation apply, used between
// lexsort passes and by the merge to materialize sorted key columns.
void h2otpu_gather_u64(const uint64_t* keys, const int64_t* order, int64_t n,
                       uint64_t* out, int nthreads) {
  nthreads = hardware_threads(nthreads);
  const int64_t block = (n + nthreads - 1) / nthreads;
  auto fn = [&](int t) {
    const int64_t lo = t * block, hi = std::min<int64_t>(n, lo + block);
    for (int64_t i = lo; i < hi; ++i) out[i] = keys[order[i]];
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; ++t) ts.emplace_back(fn, t);
  for (auto& th : ts) th.join();
}

}  // extern "C"
