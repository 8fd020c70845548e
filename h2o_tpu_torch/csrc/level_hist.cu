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
// What bounds it: memory traffic, not arithmetic. Per level it must read
// Rl*F code bytes + 4*Rl bytes of lc + 4*V*Rl bytes of vv; at the HIGGS
// shape (11,001,856 rows, 28 int8 features, V = 3) that is about 484 MB, or
// 0.145 ms at 3.35 TB/s, and at the airlines shape (9 int16 features) about
// 374 MB, 0.112 ms. The adds (Rl*F*V) take far less at the card's integer
// rate. The design reads every input once per tile and keeps all
// accumulation on chip.
//
// Tiling: the host plans "items" — (feature, node range [n0, n1)) pieces of
// the output — and packs them into tiles of at most ~112 KB of shared memory,
// balanced by cells, not features (a 301-wide categorical at n_lv = 16 is a
// 115 KB tile by itself and is split into two node ranges; a 21-bin numeric
// feature is 8 KB). A CTA owns one row chunk x one tile: it accumulates into
// a shared-memory tile, skips rows whose node lies outside an item's range,
// and writes only its non-zero cells out once at the end. Any feature whose
// one-node slice Bg * V * 8 bytes fits in shared memory can be held.
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
// sum of |q| stays below 2^62) and summed with integer atomics, whose
// result does not depend on order. The scale comes from a max, which is
// also order-independent, computed on the device with no host sync.
// Integer-valued channels (row weights) are exact; real channels carry an
// absolute error of at most 2^-63 * Rl * max|v| per row before the final
// rounding to float32. A channel holding a NaN or an infinity comes out NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxV = 4;
constexpr int kThreads = 512;
// one item of the tile plan: column, first node, end node, width, offset of
// its first cell in the CTA's shared tile, offset of its first cell in the
// output (int32 each; the planner keeps every offset below 2^31)
constexpr int kItemInts = 6;
// items per tile; the table is staged in shared memory ahead of the cells
constexpr int kMaxItems = 64;
constexpr int kItemWords = kMaxItems * kItemInts / 2;  // in 8-byte words
constexpr int kMaxSmemBytes = 232448;                   // 227 KB per CTA

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

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
level_hist_kernel(const CodeT* __restrict__ codes, const int* __restrict__ lc,
                  const float* __restrict__ vv, long long rows, int F, int V,
                  int n_lv, int na_code, const int* __restrict__ items,
                  const int* __restrict__ tile_start,
                  const double* __restrict__ scale,
                  unsigned long long* __restrict__ acc) {
  extern __shared__ unsigned long long smem[];
  int* it = reinterpret_cast<int*>(smem);
  unsigned long long* tile = smem + kItemWords;
  const int i0 = tile_start[blockIdx.y];
  const int ni = tile_start[blockIdx.y + 1] - i0;
  for (int i = threadIdx.x; i < ni * kItemInts; i += blockDim.x)
    it[i] = items[i0 * kItemInts + i];
  __syncthreads();
  // items of a tile sit back to back in shared memory
  const int* last = it + (ni - 1) * kItemInts;
  const int cells = last[4] + (last[2] - last[1]) * last[3] * V;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) tile[i] = 0ull;

  double sc[kMaxV];
#pragma unroll
  for (int v = 0; v < kMaxV; ++v) {
    const double s = v < V ? scale[v] : 0.0;
    sc[v] = isnan(s) ? 0.0 : s;  // a NaN channel is written NaN at the end
  }
  __syncthreads();

  const long long per = (rows + gridDim.x - 1) / gridDim.x;
  const long long r0 = (long long)blockIdx.x * per;
  const long long r1 = min(rows, r0 + per);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int l = lc[r];
    if ((unsigned)l >= (unsigned)n_lv) continue;
    long long q[kMaxV];
    bool any = false;
#pragma unroll
    for (int v = 0; v < kMaxV; ++v) {
      q[v] = v < V ? llrint((double)vv[r * V + v] * sc[v]) : 0ll;
      any |= q[v] != 0ll;
    }
    if (!any) continue;  // inactive and padding rows carry zeros
    const CodeT* row = codes + r * F;
    for (int k = 0; k < ni; ++k) {
      const int* m = it + k * kItemInts;
      if (l < m[1] || l >= m[2]) continue;  // node outside the item's range
      const int bg = m[3];
      int c = (int)row[m[0]];               // sign-extends int8 / int16
      if (c == na_code) c = bg - 1;
      if ((unsigned)c >= (unsigned)bg) continue;
      unsigned long long* cell = tile + m[4] + ((l - m[1]) * bg + c) * V;
#pragma unroll
      for (int v = 0; v < kMaxV; ++v)
        if (v < V) atomicAdd(cell + v, (unsigned long long)q[v]);
    }
  }
  __syncthreads();

  for (int k = 0; k < ni; ++k) {
    const int* m = it + k * kItemInts;
    const int n = (m[2] - m[1]) * m[3] * V;
    const unsigned long long* src = tile + m[4];
    unsigned long long* out = acc + m[5];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const unsigned long long x = src[i];
      if (x != 0ull) atomicAdd(out + i, x);
    }
  }
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
                        long long rows, int F, int V, int n_lv, int na_code,
                        const int* items, const int* tile_start, int n_tiles,
                        int tile_cells, const double* scale,
                        unsigned long long* acc, int num_sms,
                        cudaStream_t stream) {
  const size_t smem = ((size_t)kItemWords + (size_t)tile_cells) * 8;
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kern = level_hist_kernel<CodeT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // one wave: every CTA walks one row chunk and flushes its tile once
  long long chunks = (long long)num_sms * per_sm / n_tiles;
  const long long max_chunks = (rows + kThreads - 1) / kThreads;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  dim3 grid((unsigned)chunks, (unsigned)n_tiles);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const CodeT*>(codes), lc, vv, rows, F, V, n_lv, na_code,
      items, tile_start, scale, acc);
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
// plan, tile_cells its largest tile. acc (n_cells int64) and amax_bits
// (V uint32) must be zeroed by the caller; scale (V float64) is scratch;
// out (n_cells float32) is written. Returns 0 or the first CUDA error of
// the launches.
int h2o_level_hist(const void* codes, int code_bytes, const int* lc,
                   const float* vv, long long rows, int F, int V, int n_lv,
                   int na_code, const int* items, const int* tile_start,
                   int n_tiles, int tile_cells, unsigned long long* acc,
                   long long n_cells, unsigned int* amax_bits, double* scale,
                   float* out, cudaStream_t stream) {
  if (V < 1 || V > kMaxV || F < 1 || n_lv < 1 || rows < 1 || n_tiles < 1 ||
      n_tiles > 65535 || tile_cells < 1 || n_cells < 1)
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
      err = launch_hist<int8_t>(codes, lc, vv, rows, F, V, n_lv, na_code,
                                items, tile_start, n_tiles, tile_cells, scale,
                                acc, num_sms, stream);
      break;
    case 2:
      err = launch_hist<int16_t>(codes, lc, vv, rows, F, V, n_lv, na_code,
                                 items, tile_start, n_tiles, tile_cells, scale,
                                 acc, num_sms, stream);
      break;
    case 4:
      err = launch_hist<int32_t>(codes, lc, vv, rows, F, V, n_lv, na_code,
                                 items, tile_start, n_tiles, tile_cells, scale,
                                 acc, num_sms, stream);
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
