// Weighted Gram of GLM's IRLS step — the Hopper kernel that replaces the TPU
// kernel h2o_tpu/backend/kernels/gram.py::_pallas_gram.
//
// What it computes, for X (R, P) row-major float32, W (R,) and optionally z
// (R,):
//     G[i, j] = sum_r (X[r, i] * W[r]) * X[r, j]        (P x P)
//     b[i]    = sum_r (X[r, i] * W[r]) * z[r]           (P), when z is given
// i.e. one product of the weighted left operand (W o X)^T with the augmented
// right operand [X | z] (Q = P + 1 columns; P without z). G is its first P
// columns and b its last column. W is applied once (X^T diag(W) X), which is
// what a 0/1 mask caller (PCA) relies on.
//
// What bounds it: at GLM's HIGGS width (R = 11,001,856, P = 29) it must read
// X plus W and z, 1.364 GB, or 0.41 ms at 3.35 TB/s: the bytes bound it. At
// the airlines one-hot width (P = 690) the operations do: G's triangle and b
// are 501 GFLOP at 1,048,576 rows, 3.04 ms at the tensor cores' 3xTF32 rate
// (495 / 3 TFLOP/s), 7.48 ms at the 67 TFLOP/s float32 FMA rate.
//
// The design:
// - Tensor cores at float32 accuracy (3xTF32). Each operand a, with the left
//   one formed as x * w rounded to float32 first (as the plain version forms
//   W o X), is split into hi = tf32(a) and lo = a - hi; every m16n8k8
//   fragment product takes lo*hi + hi*lo + hi*hi (mma.sync ... tf32) into a
//   fragment that starts at zero, which a float32 add (round to nearest)
//   folds into the accumulator: the tensor cores round their own sums
//   toward zero, so a long chain of them would drift. The narrow case folds
//   after every 8 rows (3 products), the wide case after every 64 (24).
// - Rows staged once, asynchronously. A CTA copies its rows into a ring of
//   kStages shared-memory buffers with cp.async (zero-filling past the end),
//   kStages - 1 blocks ahead of the block it multiplies. Narrow case: a
//   block of BK rows of X is one contiguous span, copied in 16-byte pieces
//   (block starts are multiples of 4 rows, so every span starts on 16 bytes);
//   the two operands are then the same staged rows. Wide case: the CTA's two
//   128-column slabs, in pieces of 16, 8 or 4 bytes as P's alignment allows;
//   a diagonal tile (ti == tj) stages its one slab once and reads both
//   operands from it.
// - Triangle-only work. G is symmetric: only output tiles with ti <= tj run
//   (the host's tile list; b rides in the last tile column), and inside a
//   tile the pieces wholly below the diagonal or past P / Q are skipped
//   (m16n8 fragments in the narrow case, 32 x 32 warp tiles in the wide
//   one). The reduce pass mirrors G from its upper triangle.
// - Narrow case (Q <= 32): one 32 x 32 tile, 6 of its 8 fragments; each of
//   the 8 warps takes its own 8-row slices of every staged block with a full
//   set of accumulators, and the warps are summed in a fixed order through
//   shared memory at the end of the chunk. Wide case: 128 x 128 tiles, 16
//   warps as 4 x 4 warp tiles of 32 x 32 (2 x 4 fragments each), at most
//   128 registers a thread so the SM keeps 16 warps in flight.
//
// What bounds this design: the mma.sync pipe. In tools/kernel_times.py's
// timings on an H100 (700 W) both forms run close to one m16n8k8 TF32
// product per 4 cycles per SM, a quarter of the card's dense TF32 rate,
// which only wgmma reaches, and 3xTF32 issues three of them per product.
// wgmma wants its tf32 operands K-major in shared memory (here K is rows,
// so a transposing pass): the next step for the wide case.
//
// Why not the TPU's design: the Pallas kernel keeps the (P, P) accumulator
// resident in VMEM and walks its grid of row blocks in order. Hopper CTAs run
// in parallel and in no order, so the grid is (output tile, row chunk): each
// CTA writes its tile of one chunk into a per-chunk partial buffer, and a
// second launch sums the partials of each entry in ascending chunk order.
//
// Determinism: no float atomics. Each warp adds its slices in ascending
// order, warps are summed in ascending order, and chunks too, so G and b are
// bit-identical from run to run. The chunk count is chosen by the host from
// R and P alone (never from the SM count), so two cards give the same bits.
// The order differs from the reference's, which adds balanced row blocks in
// sequence: each entry carries its own float32 rounding of a sum of R terms.
//
// Masking: rows past the chunk's end load as zeros (cp.async zero fill), as
// do columns past P; column P of the right operand is z. Every such term
// adds an exact +0.0. The caller's X is read where it lies; no padded copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // 8 warps (narrow case)
constexpr int kWarps = kThreads / 32;
constexpr int kWideThreads = 512;        // 16 warps (wide case)
constexpr int kStages = 3;
constexpr int kNarrowTile = 32;
constexpr int kNarrowBK = 256;           // rows per staged block, narrow case
constexpr int kWideTile = 128;
constexpr int kWideBK = 64;              // rows per staged block, wide case
constexpr int kWideLd = kWideTile + 8;   // slab row stride: conflict-free frags

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of kBytes (4, 8 or 16) into shared memory: the first src_bytes
// are read from global memory, the rest are zero-filled
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(kBytes), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// nbytes of a contiguous 16-byte-aligned span into dst, covering `cover`
// bytes (a multiple of 16) with zeros past nbytes
__device__ __forceinline__ void stage_span(void* dst, const void* src,
                                           long long nbytes, int cover,
                                           int threads) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  for (int o = threadIdx.x * 16; o < cover; o += threads * 16) {
    const long long rem = nbytes - o;
    const int n = rem >= 16 ? 16 : (rem > 0 ? (int)rem : 0);
    cp_async<16>(d + o, n > 0 ? s + o : s, n);
  }
}

// a = hi + lo: hi is a rounded to TF32 (nearest, ties away from zero, by
// integer ops on its bits: a conversion instruction costs more), lo = a - hi
// is exact in float32 and goes to the tensor cores as it is, which read its
// leading TF32 bits: an error of at most 2^-21 of a
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += (ahi + alo)(bhi + blo) less the lo*lo term, through a zeroed
// fragment
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, bh);
  mma_tf32(t, ah, bl);
  mma_tf32(t, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// Narrow case: Q <= 32, one 32 x 32 output tile, row chunk blockIdx.y.
// Fragments (mi, ni) of 16 x 8; (1, 0) and (1, 1) lie below the diagonal.
constexpr int kNarrowFrags = 6;
__device__ __forceinline__ constexpr int narrow_mi(int f) {
  return f < 4 ? 0 : 1;
}
__device__ __forceinline__ constexpr int narrow_ni(int f) {
  return f < 4 ? f : f - 2;
}

__global__ void __launch_bounds__(kThreads, 2)
gram_narrow(const float* __restrict__ X, const float* __restrict__ W,
            const float* __restrict__ z, long long R, int P, int Q,
            long long chunk_rows, float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  const int xs_floats = (kNarrowBK * P + 3) & ~3;
  const int stage_floats = xs_floats + 2 * kNarrowBK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool has_z = Q > P;
  const long long chunk = blockIdx.y;
  const long long r_begin = chunk * chunk_rows;
  const long long r_end = min(R, r_begin + chunk_rows);
  const int nblk = (int)((r_end - r_begin + kNarrowBK - 1) / kNarrowBK);

  auto issue = [&](int blk) {
    float* st = smem + (blk % kStages) * stage_floats;
    const long long r0 = r_begin + (long long)blk * kNarrowBK;
    const long long n = min((long long)kNarrowBK, r_end - r0);
    stage_span(st, X + r0 * P, n * P * 4, xs_floats * 4, kThreads);
    stage_span(st + xs_floats, W + r0, n * 4, kNarrowBK * 4, kThreads);
    if (has_z) stage_span(st + xs_floats + kNarrowBK, z + r0, n * 4,
                          kNarrowBK * 4, kThreads);
  };

  // this lane's columns g + 8q of the staged rows: X, z (column P) or 0
  bool colx[4], colz[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    colx[q] = g + 8 * q < P;
    colz[q] = has_z && g + 8 * q == P;
  }
  float acc[kNarrowFrags][4];
#pragma unroll
  for (int f = 0; f < kNarrowFrags; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nblk) issue(s);
    cp_async_commit();
  }
  for (int blk = 0; blk < nblk; ++blk) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (blk + kStages - 1 < nblk) issue(blk + kStages - 1);
    cp_async_commit();
    const float* xs = smem + (blk % kStages) * stage_floats;
    const float* ws = xs + xs_floats;
    const float* zs = ws + kNarrowBK;
    const int n = (int)min((long long)kNarrowBK,
                           r_end - (r_begin + (long long)blk * kNarrowBK));
    for (int kb = warp * 8; kb < n; kb += kWarps * 8) {
      const int k0 = kb + t, k1 = k0 + 4;
      const float w0 = ws[k0], w1 = ws[k1];
      const float z0 = has_z ? zs[k0] : 0.f, z1 = has_z ? zs[k1] : 0.f;
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x0 = colx[q] ? xs[k0 * P + g + 8 * q] : 0.f;
        const float x1 = colx[q] ? xs[k1 * P + g + 8 * q] : 0.f;
        split_tf32(colz[q] ? z0 : x0, bh[q][0], bl[q][0]);
        split_tf32(colz[q] ? z1 : x1, bh[q][1], bl[q][1]);
        // A fragment mi = q / 2: rows g (q even) or g + 8 (q odd)
        split_tf32(x0 * w0, ah[q >> 1][q & 1], al[q >> 1][q & 1]);
        split_tf32(x1 * w1, ah[q >> 1][2 + (q & 1)], al[q >> 1][2 + (q & 1)]);
      }
#pragma unroll
      for (int f = 0; f < kNarrowFrags; ++f)
        mma_3xtf32(acc[f], ah[narrow_mi(f)], al[narrow_mi(f)],
                   bh[narrow_ni(f)], bl[narrow_ni(f)]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // warps' partials through shared memory, summed in ascending warp order
  float* red = smem;
  constexpr int kTileCells = kNarrowTile * kNarrowTile;
#pragma unroll
  for (int f = 0; f < kNarrowFrags; ++f) {
    const int i = 16 * narrow_mi(f) + g, j = 8 * narrow_ni(f) + 2 * t;
    float* o = red + warp * kTileCells;
    o[i * kNarrowTile + j] = acc[f][0];
    o[i * kNarrowTile + j + 1] = acc[f][1];
    o[(i + 8) * kNarrowTile + j] = acc[f][2];
    o[(i + 8) * kNarrowTile + j + 1] = acc[f][3];
  }
  __syncthreads();
  float* out = partial + chunk * (long long)P * Q;
  for (int e = threadIdx.x; e < kTileCells; e += kThreads) {
    const int i = e / kNarrowTile, j = e % kNarrowTile;
    if (i >= P || j >= Q || j < i) continue;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * kTileCells + e];
    out[(long long)i * Q + j] = s;
  }
}

// Wide case: output tile tiles[blockIdx.x] = (ti, tj), ti <= tj, of 128 x
// 128; row chunk blockIdx.y. 16 warps as 4 x 4 warp tiles of 32 x 32 (2 x 4
// fragments). kVec floats per cp.async piece of X; a diagonal tile stages
// only slab 0 and takes its right operand from it too. Each fragment's products
// of one staged block chain into a partial that starts at zero and is added
// into the accumulator once per block (round to nearest), which keeps the
// tensor cores' accumulation rounding to 24 products per add.
template <int kVec>
__global__ void __launch_bounds__(kWideThreads, 1)
gram_wide(const float* __restrict__ X, const float* __restrict__ W,
          const float* __restrict__ z, long long R, int P, int Q,
          const int* __restrict__ tiles, long long chunk_rows,
          float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kSlab = kWideBK * kWideLd;
  constexpr int kStageFloats = 2 * kSlab + 2 * kWideBK;
  constexpr int kPieces = kWideTile / kVec;  // pieces per slab row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const bool has_z = Q > P;
  const int i0 = tiles[2 * blockIdx.x] * kWideTile;
  const int j0 = tiles[2 * blockIdx.x + 1] * kWideTile;
  const int n_slabs = i0 == j0 ? 1 : 2;
  const long long chunk = blockIdx.y;
  const long long r_begin = chunk * chunk_rows;
  const long long r_end = min(R, r_begin + chunk_rows);
  const int nblk = (int)((r_end - r_begin + kWideBK - 1) / kWideBK);

  auto issue = [&](int blk) {
    float* st = smem + (blk % kStages) * kStageFloats;
    const long long r0 = r_begin + (long long)blk * kWideBK;
    const int n = (int)min((long long)kWideBK, r_end - r0);
    for (int e = threadIdx.x; e < n_slabs * kWideBK * kPieces;
         e += kWideThreads) {
      const int slab = e / (kWideBK * kPieces);
      const int k = (e / kPieces) % kWideBK;
      const int c = (e % kPieces) * kVec;
      const int col = (slab ? j0 : i0) + c;
      const bool ok = k < n && col < P;
      const float* src = ok ? X + (r0 + k) * P + col : X;
      cp_async<kVec * 4>(st + slab * kSlab + k * kWideLd + c, src,
                         ok ? kVec * 4 : 0);
    }
    stage_span(st + 2 * kSlab, W + r0, (long long)n * 4, kWideBK * 4,
               kWideThreads);
    if (has_z) stage_span(st + 2 * kSlab + kWideBK, z + r0, (long long)n * 4,
                          kWideBK * 4, kWideThreads);
  };

  // a warp whose fragments all lie past P / Q or wholly below the diagonal
  // computes nothing; the others compute all 8 (a branch per fragment
  // would cut the products into blocks the scheduler cannot overlap)
  const int row0 = i0 + wm * 32, col0 = j0 + wn * 32;
  const bool run = row0 < P && col0 < Q && col0 + 31 >= row0;
  bool zcol[4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) zcol[ni] = has_z && col0 + 8 * ni + g == P;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nblk) issue(s);
    cp_async_commit();
  }
  for (int blk = 0; blk < nblk; ++blk) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (blk + kStages - 1 < nblk) issue(blk + kStages - 1);
    cp_async_commit();
    if (!run) continue;
    const float* as = smem + (blk % kStages) * kStageFloats + wm * 32;
    const float* bs = smem + (blk % kStages) * kStageFloats +
                      (n_slabs - 1) * kSlab + wn * 32;
    const float* ws = smem + (blk % kStages) * kStageFloats + 2 * kSlab;
    const float* zs = ws + kWideBK;
    const int n = (int)min((long long)kWideBK,
                           r_end - (r_begin + (long long)blk * kWideBK));
    float part[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < kWideBK; kb += 8) {
      if (kb >= n) break;
      const int k0 = kb + t, k1 = k0 + 4;
      const float w0 = ws[k0], w1 = ws[k1];
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = 16 * mi + g;
        split_tf32(as[k0 * kWideLd + r] * w0, ah[mi][0], al[mi][0]);
        split_tf32(as[k0 * kWideLd + r + 8] * w0, ah[mi][1], al[mi][1]);
        split_tf32(as[k1 * kWideLd + r] * w1, ah[mi][2], al[mi][2]);
        split_tf32(as[k1 * kWideLd + r + 8] * w1, ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = 8 * ni + g;
        split_tf32(zcol[ni] ? zs[k0] : bs[k0 * kWideLd + c], bh[ni][0],
                   bl[ni][0]);
        split_tf32(zcol[ni] ? zs[k1] : bs[k1 * kWideLd + c], bh[ni][1],
                   bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_tf32(part[mi][ni], al[mi], bh[ni]);
          mma_tf32(part[mi][ni], ah[mi], bl[ni]);
          mma_tf32(part[mi][ni], ah[mi], bh[ni]);
        }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  }
  cp_async_wait<0>();
  if (!run) return;

  float* out = partial + chunk * (long long)P * Q;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row0 + 16 * mi + g + (e >= 2 ? 8 : 0);
        const int j = col0 + 8 * ni + 2 * t + (e & 1);
        if (i < P && j < Q) out[(long long)i * Q + j] = acc[mi][ni][e];
      }
}

// Second pass: entry (i, j) of the (P, Q) result is the sum over chunks, in
// ascending chunk order, of the partials of (min(i, j), max(i, j)) — the
// upper triangle the tiles computed; column P (with z) goes to b.
__global__ void gram_reduce(const float* __restrict__ partial, int n_chunks,
                            int P, int Q, float* __restrict__ G,
                            float* __restrict__ b) {
  const long long n = (long long)P * Q;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int i = (int)(e / Q);
  const int j = (int)(e % Q);
  const long long src = j < i ? (long long)j * Q + i : e;
  float s = 0.0f;
#pragma unroll 8
  for (int c = 0; c < n_chunks; ++c) s += partial[(long long)c * n + src];
  if (j < P) G[(long long)i * P + j] = s;
  else b[i] = s;
}

template <int kVec>
cudaError_t launch_wide(const float* X, const float* W, const float* z,
                        long long R, int P, int Q, const int* tiles,
                        int n_tiles, int n_chunks, long long chunk_rows,
                        float* partial, cudaStream_t stream) {
  const int smem = kStages * (2 * kWideBK * kWideLd + 2 * kWideBK) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gram_wide<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gram_wide<kVec><<<dim3(n_tiles, n_chunks), kWideThreads, smem, stream>>>(
      X, W, z, R, P, Q, tiles, chunk_rows, partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// X (R, P) float32 row-major, W (R,) float32, z (R,) float32 or null — all
// on the device, each 16-byte aligned. The kernel takes one 32 x 32 tile
// (rows staged kNarrowBK = 256 at a time) when Q = P + (z != null) <= 32,
// else 128 x 128 tiles (kWideBK = 64); tiles (n_tiles x 2 int32, on the
// device) lists the output tiles (ti, tj) with ti <= tj, (0, 0) alone in
// the narrow case; n_chunks row chunks of chunk_rows rows (a multiple of
// the form's rows per staged block) cover R. partial (n_chunks * P * Q
// float32) is scratch; G (P * P) and, with z, b (P) are written. Returns 0
// or the first CUDA error of the two launches.
int h2o_gram(const float* X, const float* W, const float* z, long long R,
             int P, const int* tiles, int n_tiles, int n_chunks,
             long long chunk_rows, float* partial, float* G, float* b,
             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int Q = P + (z != nullptr ? 1 : 0);
  const bool narrow = Q <= kNarrowTile;
  const int bk = narrow ? kNarrowBK : kWideBK;
  const uintptr_t align = reinterpret_cast<uintptr_t>(X) |
                          reinterpret_cast<uintptr_t>(W) |
                          reinterpret_cast<uintptr_t>(z);
  if (P < 1 || n_chunks < 1 || n_chunks > 65535 || n_tiles < 1 ||
      chunk_rows < 1 || chunk_rows % bk != 0 || (align & 15) != 0 ||
      (long long)n_chunks * chunk_rows < R)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (narrow) {
    if (n_tiles != 1) return (int)cudaErrorInvalidValue;
    const int stage = ((kNarrowBK * P + 3) & ~3) + 2 * kNarrowBK;
    int smem = kStages * stage * 4;
    const int red = kWarps * kNarrowTile * kNarrowTile * 4;
    if (smem < red) smem = red;
    err = cudaFuncSetAttribute(gram_narrow,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    gram_narrow<<<dim3(1, n_chunks), kThreads, smem, stream>>>(
        X, W, z, R, P, Q, chunk_rows, partial);
    err = cudaGetLastError();
  } else {
    if (P % 4 == 0)
      err = launch_wide<4>(X, W, z, R, P, Q, tiles, n_tiles, n_chunks,
                           chunk_rows, partial, stream);
    else if (P % 2 == 0)
      err = launch_wide<2>(X, W, z, R, P, Q, tiles, n_tiles, n_chunks,
                           chunk_rows, partial, stream);
    else
      err = launch_wide<1>(X, W, z, R, P, Q, tiles, n_tiles, n_chunks,
                           chunk_rows, partial, stream);
  }
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)P * Q;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  gram_reduce<<<(unsigned)blocks, threads, 0, stream>>>(partial, n_chunks, P,
                                                        Q, G, b);
  return (int)cudaGetLastError();
}

}  // extern "C"
