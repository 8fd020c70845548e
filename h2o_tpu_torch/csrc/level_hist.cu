// Level histogram of the tree engine — the Hopper kernel that replaces both
// TPU kernels of h2o_tpu/backend/kernels/hist.py: _pallas_flat (one bin
// width for every feature) and _pallas_grouped (the width buckets of
// engine.plan_hist_groups, all in one launch per level).
//
// What it computes: for each row r and each feature f of the plan,
//     c = codes[r, f];  if (c == na_code) c = Bg(f) - 1;
//     hist_f[lc[r], c, :] += vv[r, :]          for 0 <= c < Bg(f)
// with hist_f a (n_lv, Bg(f), V) float32 block at its own offset of one
// output buffer. The flat plan gives every feature Bg = B and na_code = B-1
// (the remap is then the identity); the grouped plan gives each feature its
// group's width, its group-local slot in the group's (Fg, n_lv, Bg, V)
// block, and na_code = nbins_tot - 1, so the global NA bucket lands in the
// group's last slot (hist.py::_one_group_contrib). Codes are read in place
// from the (rows, F) matrix in their stored width (int8 / int16 / int32) and
// sign-extended in registers: a negative code, a code outside [0, Bg) after
// the remap, or a node id outside [0, n_lv) adds nothing (the one-hot
// semantics of the reference). The reference's per-group column gather
// (hist.py:311) exists only because a Pallas body cannot close over index
// arrays; here a per-feature table carries the column instead.
//
// What bounds it: per level it must read Rl*F code bytes + 4*Rl bytes of lc
// + 4*V*Rl bytes of vv; at the HIGGS shape (11,001,856 rows, 28 int8
// features, V = 3) that is about 484 MB, 0.145 ms at 3.35 TB/s, and at the
// airlines shape (116,006,912 rows, 9 int16 features) 3.94 GB, 1.18 ms. The
// bytes bound it on paper; in practice the shared-memory adds do: Rl*F*V of
// them, each a 64-bit integer add, which sm_90 has no native shared
// instruction for (nvcc emits a compare-and-swap loop, ATOMS.CAST.SPIN.64).
//
// The design:
// - Adds. Each 64-bit add is two native 32-bit shared adds: the low word's
//   add returns the old word, whose carry goes into the high word's add
//   (either is skipped when it adds 0). The sum is exact modulo 2^64 in
//   any order. These shared adds are what bounds the kernel now (at about
//   one warp-wide 32-bit add per 6.5 cycles of each SM: PERF.md).
//   Adds aggregated per warp first (lanes grouped by cell with
//   __match_any_sync, summed by a shuffle tree, one add per cell) measured
//   up to twice as slow on the levels where they applied: PERF.md.
// - Tiles. The host plans "items" — (feature, node range [n0, n1)) pieces
//   of the output — and packs them into CTA tiles of shared memory, each
//   tile what the staging ring leaves of the 227 KB a CTA can hold, and
//   cuts a feature into node ranges only where it must: a warp's rows have
//   random nodes, so a tile of node ranges leaves lanes idle in its adds.
//   Tiles are balanced by the rows that reach them. A CTA accumulates into
//   its tile and writes only its non-zero cells out once at the end.
// - One pass over the rows per level. The tiles of a level form a thread
//   block cluster (at most 8 CTAs; more tiles take more clusters). Rank 0
//   of a cluster loads each block of rows — codes, node ids and channels,
//   three contiguous ranges — from device memory once, with 1-D bulk copies
//   multicast to every CTA of the cluster (cp.async.bulk .multicast::
//   cluster), into a ring of stages, each with an mbarrier that counts the
//   bytes in. Every CTA reads the staged rows from its own shared memory
//   and adds only into its own tile: no remote atomics. When a CTA has
//   used a stage it re-arms its own barrier for the stage's next block and
//   signals rank 0's "empty" barrier; rank 0 refills the stage when all
//   CTAs have. Each CTA quantises a row's channels once, and only when the
//   row's node lies in its tile's node range.
// - Why multicast rather than remote atomics: the adds are the scarce
//   resource, and adds into distributed shared memory cost a round trip
//   between SMs each; multicast moves the rows once through the cluster and
//   keeps every add local.
// - Rows past the last whole block of the last chunk are read straight
//   from device memory. So is every row when the host plans no ring
//   (rb = 0): rows too wide for 16 of them to fit two stages beside the
//   widest feature's node, or inputs that do not start on 16 bytes. Every
//   feature one node of which fits the CTA's shared memory beside the item
//   table can then be held (9,621 bins at V = 3).
//
// Why not the TPU's design: the TPU cannot scatter, so the Pallas kernels
// accumulate through one-hot matrix products (or a segment sum, interpreted)
// and carry the sum sequentially across their grid. Hopper CTAs run in
// parallel and in no order, and a scatter-add into shared memory is the
// natural form; the "onehot" and "segsum" modes become the same code.
//
// Determinism: the output is bit-identical from run to run. There are no
// unordered float atomics: every value is converted to 64-bit fixed point
// (q = llrint(v * 2^s), s chosen per channel from Rl * max|v| so that the
// sum of |q| stays below 2^62) and summed with integer adds, whose result
// does not depend on order. The scale comes from a max, which is also
// order-independent, computed on the device with no host sync by a pass of
// its own. Integer-valued channels (row weights) are exact; real channels
// carry an absolute error of at most 2^-63 * Rl * max|v| per row before the
// final rounding to float32. A channel holding a NaN or an infinity comes
// out NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxV = 4;
constexpr int kThreads = 1024;
// one item of the tile plan: column, first node, end node, width, offset of
// its first cell in the CTA's shared tile, offset of its first cell in the
// output (int32 each; the planner keeps every offset below 2^31)
constexpr int kItemInts = 6;
// items per tile; the table is staged in shared memory ahead of the cells
constexpr int kMaxItems = 64;
constexpr int kItemBytes = kMaxItems * kItemInts * 4;
constexpr int kBarBytes = 128;          // full[] and empty[] mbarriers
constexpr int kStages = 2;              // the ring's stages
constexpr int kMaxCluster = 8;
constexpr int kMaxSmemBytes = 232448;   // 227 KB per CTA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// this thread's arrival, expecting `bytes` more to land in the phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// arrival on the barrier at the same offset in CTA `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}

// wait for the phase of `parity` to complete; a wait of more than ~2^34
// cycles (seconds) can only be a broken pipeline, so it traps rather than
// hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// `bytes` (a multiple of 16) from global `src` to `dst` in every CTA of the
// cluster named by `mask`, each copy counted on that CTA's `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar,
                                          int cluster) {
  if (cluster == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
  } else {
    const uint16_t mask = (uint16_t)((1u << cluster) - 1u);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(
            smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
        : "memory");
  }
}

// a 64-bit cell kept as two 32-bit words in two planes of the tile, so a
// warp's adds into random cells spread over all 32 banks: cell += q (mod
// 2^64) as two native 32-bit shared adds, the low word's carry going into
// the high word. A zero word adds nothing and is skipped: an
// integer-valued channel (row weights) at a scale of 2^32 or more has a
// zero low word in every row.
__device__ __forceinline__ void add_u64(unsigned int* lo_word,
                                        unsigned int* hi_word,
                                        unsigned long long q) {
  const unsigned int lo = (unsigned int)q;
  unsigned int hi = (unsigned int)(q >> 32);
  if (lo != 0u) {
    const unsigned int old = atomicAdd(lo_word, lo);
    hi += (old + lo < old) ? 1u : 0u;
  }
  if (hi != 0u) atomicAdd(hi_word, hi);
}

__global__ void absmax_kernel(const float* __restrict__ vv, long long rows,
                              int V, unsigned int* __restrict__ amax_bits) {
  // |v| bit patterns order like the values (finite < inf < NaN), so an
  // unsigned max is the float max and flags non-finite channels for free
  unsigned int m[kMaxV] = {0u, 0u, 0u, 0u};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < rows; r += stride) {
#pragma unroll
    for (int v = 0; v < kMaxV; ++v) {
      if (v < V) {
        unsigned int b = __float_as_uint(fabsf(vv[r * V + v]));
        m[v] = b > m[v] ? b : m[v];
      }
    }
  }
#pragma unroll
  for (int v = 0; v < kMaxV; ++v) {
    if (v < V) {
      unsigned int w = __reduce_max_sync(0xffffffffu, m[v]);
      if ((threadIdx.x & 31) == 0 && w != 0u) atomicMax(&amax_bits[v], w);
    }
  }
}

__global__ void scale_kernel(const unsigned int* __restrict__ amax_bits,
                             long long rows, int V, double* __restrict__ scale) {
  const int v = threadIdx.x;
  if (v >= V) return;
  const unsigned int b = amax_bits[v];
  if (b >= 0x7f800000u) {  // inf or NaN somewhere in the channel
    scale[v] = __longlong_as_double(0x7ff8000000000000ll);
    return;
  }
  const double t = (double)__uint_as_float(b) * (double)rows;
  if (t == 0.0) {
    scale[v] = 1.0;
    return;
  }
  int e;
  frexp(t, &e);                   // t < 2^e
  scale[v] = ldexp(1.0, 62 - e);  // rows * max|v| * scale < 2^62
}

// What a CTA knows of its tile while it adds rows.
struct TileCtx {
  const int* it;                 // the tile's items in shared memory
  int ni;                        // number of items
  int nmin, nmax;                // node range covered by any item
  int V, na_code;
  double sc[kMaxV];
  unsigned int* lo;              // the tile's low words, then its high
  unsigned int* hi;              // words: one plane of `cells` each
};

// one row's adds into the CTA's tile: crow its codes, l its node, v its V
// channel values (shared or global memory)
template <typename CodeT>
__device__ __forceinline__ void add_row(const TileCtx& t, const CodeT* crow,
                                        int l, const float* v) {
  if (l < t.nmin || l >= t.nmax) return;  // also drops l outside [0, n_lv)
  long long q[kMaxV];
  bool any = false;
#pragma unroll
  for (int c = 0; c < kMaxV; ++c) {
    q[c] = c < t.V ? llrint((double)v[c] * t.sc[c]) : 0ll;
    any |= q[c] != 0ll;
  }
  if (!any) return;  // inactive and padding rows carry zeros
  for (int k = 0; k < t.ni; ++k) {
    const int* m = t.it + k * kItemInts;
    if (l < m[1] || l >= m[2]) continue;  // node outside the item's range
    const int bg = m[3];
    int c = (int)crow[m[0]];              // sign-extends int8 / int16
    if (c == t.na_code) c = bg - 1;
    if ((unsigned)c >= (unsigned)bg) continue;
    const int cell = m[4] + ((l - m[1]) * bg + c) * t.V;
#pragma unroll
    for (int ch = 0; ch < kMaxV; ++ch)
      if (ch < t.V)
        add_u64(t.lo + cell + ch, t.hi + cell + ch, (unsigned long long)q[ch]);
  }
}

// One CTA: tile blockIdx.x (cluster-major: cluster blockIdx.x / cluster,
// rank blockIdx.x % cluster) over the rows of chunk blockIdx.y.
template <typename CodeT>
__global__ void __launch_bounds__(kThreads, 1)
level_hist_kernel(const CodeT* __restrict__ codes, const int* __restrict__ lc,
                  const float* __restrict__ vv, long long rows, int F, int V,
                  int na_code, const int* __restrict__ items,
                  const int* __restrict__ tile_start,
                  const double* __restrict__ scale,
                  unsigned long long* __restrict__ acc, int cluster, int rb,
                  long long chunk_rows) {
  // shared memory: the item table, then (when rb > 0) the barriers and the
  // ring, then the tile
  extern __shared__ __align__(128) unsigned char smem[];
  int* it = reinterpret_cast<int*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kItemBytes);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + kItemBytes + kBarBytes;
  const int code_blk = rb * F * (int)sizeof(CodeT);  // multiples of 16
  const int lc_blk = rb * 4;
  const int stage_bytes = code_blk + lc_blk + rb * V * 4;
  unsigned int* tile = reinterpret_cast<unsigned int*>(
      rb > 0 ? ring + kStages * stage_bytes : smem + kItemBytes);
  const int rank = blockIdx.x % cluster;
  const int tid = threadIdx.x;

  const int i0 = tile_start[blockIdx.x];
  const int ni = tile_start[blockIdx.x + 1] - i0;
  for (int i = tid; i < ni * kItemInts; i += blockDim.x)
    it[i] = items[i0 * kItemInts + i];
  const long long c0 = (long long)blockIdx.y * chunk_rows;
  const long long c1 = min(rows, c0 + chunk_rows);
  const int nb = rb > 0 ? (int)((c1 - c0) / rb) : 0;  // whole staged blocks
  if (tid == 0 && rb > 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], cluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages && s < nb; ++s)
      mbar_expect(&full[s], stage_bytes);
  }
  __syncthreads();

  TileCtx t;
  t.it = it;
  t.ni = ni;
  t.V = V;
  t.na_code = na_code;
  t.nmin = 0;
  t.nmax = 0;
  for (int k = 0; k < ni; ++k) {
    const int* m = it + k * kItemInts;
    t.nmin = k == 0 ? m[1] : min(t.nmin, m[1]);
    t.nmax = max(t.nmax, m[2]);
  }
  int cells = 0;
  if (ni > 0) {
    const int* last = it + (ni - 1) * kItemInts;  // items sit back to back
    cells = last[4] + (last[2] - last[1]) * last[3] * V;
  }
  for (int i = tid; i < 2 * cells; i += blockDim.x) tile[i] = 0u;
  t.lo = tile;
  t.hi = tile + cells;
#pragma unroll
  for (int v = 0; v < kMaxV; ++v) {
    const double s = v < V ? scale[v] : 0.0;
    t.sc[v] = isnan(s) ? 0.0 : s;  // a NaN channel is written NaN at the end
  }
  // every CTA's barriers initialised and armed before any copy lands
  cluster_sync();

  auto issue = [&](int b) {
    unsigned char* st = ring + (b % kStages) * stage_bytes;
    const long long r0 = c0 + (long long)b * rb;
    uint64_t* bar = &full[b % kStages];
    bulk_load(st, codes + r0 * F, code_blk, bar, cluster);
    bulk_load(st + code_blk, lc + r0, lc_blk, bar, cluster);
    bulk_load(st + code_blk + lc_blk, vv + r0 * V, rb * V * 4, bar, cluster);
  };
  if (rank == 0 && tid == 0)
    for (int s = 0; s < kStages && s < nb; ++s) issue(s);

  for (int b = 0; b < nb; ++b) {
    const int s = b % kStages;
    mbar_wait(&full[s], (b / kStages) & 1);
    const unsigned char* st = ring + s * stage_bytes;
    const CodeT* cs = reinterpret_cast<const CodeT*>(st);
    const int* ls = reinterpret_cast<const int*>(st + code_blk);
    const float* vs = reinterpret_cast<const float*>(st + code_blk + lc_blk);
    for (int k = tid; k < rb; k += blockDim.x)
      add_row(t, cs + k * F, ls[k], vs + k * V);
    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && b + kStages < nb) {
      mbar_expect(&full[s], stage_bytes);   // arm it for block b + kStages
      mbar_arrive_cluster(&empty[s], 0);
      if (rank == 0) {
        mbar_wait(&empty[s], (b / kStages) & 1);  // all CTAs are done with it
        issue(b + kStages);
      }
    }
  }
  // the rows no block staged, straight from device memory
  for (long long r = c0 + (long long)nb * rb + tid; r < c1; r += blockDim.x)
    add_row(t, codes + r * F, lc[r], vv + r * V);
  __syncthreads();

  for (int k = 0; k < ni; ++k) {
    const int* m = it + k * kItemInts;
    const int n = (m[2] - m[1]) * m[3] * V;
    unsigned long long* out = acc + m[5];
    for (int i = tid; i < n; i += blockDim.x) {
      const unsigned long long x =
          (unsigned long long)t.hi[m[4] + i] << 32 | t.lo[m[4] + i];
      if (x != 0ull) atomicAdd(out + i, x);
    }
  }
  // no CTA leaves while a peer may still signal its barriers
  cluster_sync();
}

__global__ void finalize_kernel(const long long* __restrict__ acc,
                                long long n, int V,
                                const double* __restrict__ scale,
                                float* __restrict__ out) {
  // every feature's block is (n_lv, Bg, V) with V innermost, so a cell's
  // channel is its index mod V
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const double s = scale[i % V];
    out[i] = isnan(s) ? __int_as_float(0x7fc00000) : (float)((double)acc[i] / s);
  }
}

template <typename CodeT>
cudaError_t launch_hist(const void* codes, const int* lc, const float* vv,
                        long long rows, int F, int V, int na_code,
                        const int* items, const int* tile_start, int n_tiles,
                        int cluster, int tile_cells, int rb,
                        const double* scale, unsigned long long* acc,
                        cudaStream_t stream) {
  const long long stage_bytes =
      (long long)rb * (F * (long long)sizeof(CodeT) + 4 + 4LL * V);
  const long long ring = rb > 0 ? kBarBytes + kStages * stage_bytes : 0;
  const long long smem = kItemBytes + ring + 8LL * tile_cells;
  if (smem > kMaxSmemBytes || ((long long)rb * F * sizeof(CodeT)) % 16 != 0)
    return cudaErrorInvalidValue;
  auto kern = level_hist_kernel<CodeT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorInvalidConfiguration;
  // one wave: every cluster walks one row chunk and flushes its tiles once;
  // chunks are whole staged blocks (of a CTA's rows when there is no ring)
  const int n_cl = n_tiles / cluster;
  const long long step = rb > 0 ? rb : kThreads;
  long long chunks = active / n_cl;
  const long long max_chunks = (rows + step - 1) / step;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  long long chunk_rows = (rows + chunks - 1) / chunks;
  chunk_rows = (chunk_rows + step - 1) / step * step;
  chunks = (rows + chunk_rows - 1) / chunk_rows;
  cfg.gridDim = dim3((unsigned)n_tiles, (unsigned)chunks, 1);
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const CodeT*>(codes), lc,
                           vv, rows, F, V, na_code, items, tile_start, scale,
                           acc, cluster, rb, chunk_rows);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* h2o_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// codes (rows, F) int8/int16/int32 (code_bytes 1/2/4), lc (rows,) int32,
// vv (rows, V) float32 — all on the device. items (n_items, 6) int32 and
// tile_start (n_tiles + 1,) int32 are the device copy of the host's tile
// plan: n_tiles CTAs in clusters of `cluster`, tile_cells its largest tile;
// rb rows per staged block in a ring of kStages (rb a multiple of 16 up to
// 1024, and codes, lc and vv then 16-byte aligned), or rb = 0: every row
// read from device memory. acc (n_cells int64) and amax_bits (V
// uint32) must be zeroed by the caller; scale (V float64) is scratch; out
// (n_cells float32) is written. Returns 0 or the first CUDA error of the
// launches.
int h2o_level_hist(const void* codes, int code_bytes, const int* lc,
                   const float* vv, long long rows, int F, int V, int na_code,
                   const int* items, const int* tile_start, int n_tiles,
                   int cluster, int tile_cells, int rb,
                   unsigned long long* acc, long long n_cells,
                   unsigned int* amax_bits, double* scale, float* out,
                   cudaStream_t stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(codes) |
                          reinterpret_cast<uintptr_t>(lc) |
                          reinterpret_cast<uintptr_t>(vv);
  if (V < 1 || V > kMaxV || F < 1 || rows < 1 || n_tiles < 1 ||
      cluster < 1 || cluster > kMaxCluster || n_tiles % cluster != 0 ||
      n_tiles > 65535 || tile_cells < 1 || n_cells < 1 || rb < 0 ||
      rb > kThreads || rb % 16 != 0 || (rb > 0 && (align & 15) != 0))
    return (int)cudaErrorInvalidValue;
  int dev = 0, num_sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  long long blocks = (rows + 255) / 256;
  if (blocks > 8LL * num_sms) blocks = 8LL * num_sms;
  absmax_kernel<<<(unsigned)blocks, 256, 0, stream>>>(vv, rows, V, amax_bits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scale_kernel<<<1, 32, 0, stream>>>(amax_bits, rows, V, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  switch (code_bytes) {
    case 1:
      err = launch_hist<int8_t>(codes, lc, vv, rows, F, V, na_code, items,
                                tile_start, n_tiles, cluster, tile_cells, rb,
                                scale, acc, stream);
      break;
    case 2:
      err = launch_hist<int16_t>(codes, lc, vv, rows, F, V, na_code, items,
                                 tile_start, n_tiles, cluster, tile_cells, rb,
                                 scale, acc, stream);
      break;
    case 4:
      err = launch_hist<int32_t>(codes, lc, vv, rows, F, V, na_code, items,
                                 tile_start, n_tiles, cluster, tile_cells, rb,
                                 scale, acc, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;

  long long fblocks = (n_cells + 255) / 256;
  if (fblocks > 8LL * num_sms) fblocks = 8LL * num_sms;
  finalize_kernel<<<(unsigned)fblocks, 256, 0, stream>>>(
      reinterpret_cast<const long long*>(acc), n_cells, V, scale, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
