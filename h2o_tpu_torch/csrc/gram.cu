// Weighted Gram of GLM's IRLS step — the Hopper kernel that replaces the TPU
// kernel h2o_tpu/backend/kernels/gram.py::_pallas_gram.
//
// What it computes, for X (R, P) row-major float32, W (R,) and optionally z
// (R,):
//     G[i, j] = sum_r (X[r, i] * W[r]) * X[r, j]        (P x P)
//     b[i]    = sum_r (X[r, i] * W[r]) * z[r]           (P), when z is given
// i.e. one product of the weighted left operand (W o X)^T with the augmented
// right operand [X | z] (P + 1 columns; P without z). G is its first P
// columns and b its last column. W is applied once (X^T diag(W) X), which is
// what a 0/1 mask caller (PCA) relies on.
//
// What bounds it: at GLM's HIGGS width (R = 11,001,856, P = 29) it must read
// X (1.276 GB) plus W and z, 1.364 GB in all, or 0.41 ms at 3.35 TB/s, and
// do 2 * R * 29 * 30 = 19.1 GFLOP, 0.29 ms at 67 TFLOP/s of float32 FMA: the
// bytes bound it. At the airlines one-hot width (P = 690) the operations do
// (about 14.9 ms per million rows against 0.83 ms of bytes). The design below
// reads every row of X once per output tile and keeps all accumulation in
// registers; it is a simple, right first design, not a tuned one. It leaves
// the tensor cores alone: the reference pins IEEE float32 products, and TF32
// would move the IRLS coefficients. A later design (wgmma on 3xTF32 split
// operands, TMA row staging, or a triangle-only grid that halves the
// operations of the wide case) would aim at those two bounds.
//
// Why not the TPU's design: the Pallas kernel keeps the (P, P) accumulator
// resident in VMEM and walks its grid of row blocks in order, adding each
// block into it. Hopper CTAs run in parallel and in no order, so that carry
// does not translate. Here the grid is (output tile, row chunk): each CTA
// owns one row chunk and one tile of the P x (P+1) result, stages BK-row
// slices of its two column ranges through shared memory (multiplying W into
// the left operand as it loads it), accumulates a TM x TM register
// micro-tile per thread with float32 FMAs, and writes its tile into a
// per-chunk partial buffer. A second launch sums the partials of each entry
// in ascending chunk order.
//
// Determinism: no float atomics. Each CTA adds its rows in ascending order
// and the second pass adds the chunks in ascending order, so G and b are
// bit-identical from run to run. The chunk count is chosen by the host from
// R and P alone (never from the SM count), so two cards give the same bits.
// The order differs from the reference's, which adds balanced blocks of
// about 2^25 / P rows in sequence (ten blocks of 1,100,186 rows at HIGGS
// width): each entry carries its own float32 rounding of a sum of R terms.
//
// Masking: a row at or past the chunk's end (or R), and a column at or past
// P (or P + 1 with z), loads as 0 and adds an exact +0.0. The caller's X is
// read where it lies; no padded copy is made.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads per CTA
constexpr int kBK = 32;         // rows staged per step

// One CTA: output tile (ti, tj) = blockIdx.x over a (nti, ntj) tile grid,
// row chunk blockIdx.y. Thread (ty, tx) owns entries (ty + 16 a, tx + 16 c)
// of the tile, a, c < TM: strided, so a warp's shared-memory reads hit
// distinct banks or broadcast.
template <int TM>
__global__ void __launch_bounds__(kThreads)
gram_tiles(const float* __restrict__ X, const float* __restrict__ W,
           const float* __restrict__ z, long long R, int P, int Q, int ntj,
           long long chunk_rows, float* __restrict__ partial) {
  constexpr int TILE = 16 * TM;
  __shared__ float As[kBK][TILE];
  __shared__ float Bs[kBK][TILE];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int i0 = (blockIdx.x / ntj) * TILE;
  const int j0 = (blockIdx.x % ntj) * TILE;
  const long long chunk = blockIdx.y;
  const long long r_begin = chunk * chunk_rows;
  long long r_end = r_begin + chunk_rows;
  if (r_end > R) r_end = R;

  float acc[TM][TM];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TM; ++c) acc[a][c] = 0.0f;

  for (long long r0 = r_begin; r0 < r_end; r0 += kBK) {
    // stage BK rows: As[k][i] = X[r, i0 + i] * W[r], Bs[k][j] = [X | z][r, j0 + j]
#pragma unroll
    for (int e = tid; e < kBK * TILE; e += kThreads) {
      const int k = e / TILE;
      const int col = e % TILE;
      const long long r = r0 + k;
      float a = 0.0f, bv = 0.0f;
      if (r < r_end) {
        const float* row = X + r * (long long)P;
        const int ci = i0 + col;
        if (ci < P) a = row[ci] * W[r];
        const int cj = j0 + col;
        if (cj < P) bv = row[cj];
        else if (cj < Q) bv = z[r];   // Q == P + 1 only when z is given
      }
      As[k][col] = a;
      Bs[k][col] = bv;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float av[TM], bv[TM];
#pragma unroll
      for (int a = 0; a < TM; ++a) av[a] = As[k][ty + 16 * a];
#pragma unroll
      for (int c = 0; c < TM; ++c) bv[c] = Bs[k][tx + 16 * c];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TM; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
    }
    __syncthreads();
  }

  float* out = partial + chunk * (long long)P * Q;
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= P) continue;
#pragma unroll
    for (int c = 0; c < TM; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j < Q) out[(long long)i * Q + j] = acc[a][c];
    }
  }
}

// Second pass: entry e of the (P, Q) result is the sum of the partials of
// every chunk, added in ascending chunk order; columns < P go to G, column
// P (with z) to b.
__global__ void gram_reduce(const float* __restrict__ partial, int n_chunks,
                            int P, int Q, float* __restrict__ G,
                            float* __restrict__ b) {
  const long long n = (long long)P * Q;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s += partial[(long long)c * n + e];
  const int i = (int)(e / Q);
  const int j = (int)(e % Q);
  if (j < P) G[(long long)i * P + j] = s;
  else b[i] = s;
}

template <int TM>
cudaError_t launch_tiles(const float* X, const float* W, const float* z,
                         long long R, int P, int Q, int n_chunks,
                         long long chunk_rows, float* partial,
                         cudaStream_t stream) {
  constexpr int TILE = 16 * TM;
  const int nti = (P + TILE - 1) / TILE;
  const int ntj = (Q + TILE - 1) / TILE;
  dim3 grid(nti * ntj, n_chunks);
  gram_tiles<TM><<<grid, kThreads, 0, stream>>>(X, W, z, R, P, Q, ntj,
                                                chunk_rows, partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// X (R, P) float32 row-major, W (R,) float32, z (R,) float32 or null — all
// on the device. tile is 32 or 128 (the CTA's output tile edge); n_chunks
// row chunks of chunk_rows rows cover R. partial (n_chunks * P * Q float32,
// Q = P + (z != null)) is scratch; G (P * P) and, with z, b (P) are
// written. Returns 0 or the first CUDA error of the two launches.
int h2o_gram(const float* X, const float* W, const float* z, long long R,
             int P, int tile, int n_chunks, long long chunk_rows,
             float* partial, float* G, float* b, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (P < 1 || n_chunks < 1 || n_chunks > 65535 || chunk_rows < 1 ||
      (long long)n_chunks * chunk_rows < R)
    return (int)cudaErrorInvalidValue;
  const int Q = P + (z != nullptr ? 1 : 0);
  cudaError_t err;
  if (tile == 32)
    err = launch_tiles<2>(X, W, z, R, P, Q, n_chunks, chunk_rows, partial,
                          stream);
  else if (tile == 128)
    err = launch_tiles<8>(X, W, z, R, P, Q, n_chunks, chunk_rows, partial,
                          stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)P * Q;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  gram_reduce<<<(unsigned)blocks, threads, 0, stream>>>(partial, n_chunks, P,
                                                        Q, G, b);
  return (int)cudaGetLastError();
}

}  // extern "C"
