// K2: the note-grid tail of the pitched style applier, forward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mst_tpu/ops/pallas_grid.py:_fwd_kernel
// (launched by _tail_t_fwd, :217-231, from fused_grid_tail) and holds the
// numerics of the serving path's _tail_unrolled (:284-310). For each row n
// of the flattened (B, C, R, T, F10) lead dims and each (o, d, f):
//
//   y[o,d,f] = sum_{k ascending} LR(LR(xo[n,o,k]) + LR(xd[n,d,k])) * w[k,f]
//   out[n, o*D+d, f] = sigmoid(y + rest[row(n), o*D+d, f]) * scale[f]
//
// with LR = leaky_relu(0.01). `rest` (the melody term plus bias) is shared
// by the C channels of a song: row(n) drops the channel index, so the
// (B, 1, R, T, F10, 56, 5) tensor is read as it is and never expanded.
//
// What bounds it on the H100: bytes. Per row it reads 240 + 210 floats of
// embeddings and writes 280 outputs (about 1.5 GB at the main path's
// 491,520 rows, 0.45 ms at 3.35 TB/s) against ~20 kFLOP of fp32 work
// (~10 GFLOP in all, 0.15 ms at 67 TFLOP/s). The (O, D, K) grid behind each
// row would be 1,680 floats — 3.3 GB over the batch — and never leaves
// registers here: each thread owns one (row, o, d), recomputes its 30 grid
// values from the two embeddings in shared memory, and keeps its 5 sums in
// registers.
//
// Design: a block takes ROWS consecutive rows. Its threads copy the rows'
// embeddings (leaky applied once), the matching rest rows and w into
// shared memory with coalesced loads, then thread (r, o, d) forms its five
// sums in ascending k — one multiply and one add per term, as the plain
// torch version does; the library is built with --fmad=false so neither is
// contracted into an FMA — and the results go back through shared memory
// as coalesced stores. The TPU kernel's transposed rows-on-lanes layout
// (pallas_grid.py:23-28) is a TPU artefact; rows stay in their natural
// layout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int O = 8;    // octaves
constexpr int D = 7;    // scale degrees
constexpr int K = 30;   // grid depth (5 features x 6)
constexpr int F = 5;    // output features
constexpr int M = O * D;
constexpr int OUT = M * F;
constexpr int ROWS = 8;
constexpr int THREADS = ROWS * M;  // 448

__device__ __forceinline__ float leaky(float x) {
  return x >= 0.0f ? x : 0.01f * x;
}

__global__ void __launch_bounds__(THREADS)
grid_tail_kernel(const float* __restrict__ xo, const float* __restrict__ xd,
                 const float* __restrict__ w, const float* __restrict__ rest,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int64_t n, int64_t rest_rep, int64_t rest_inner) {
  __shared__ float s_xo[ROWS * O * K];
  __shared__ float s_xd[ROWS * D * K];
  __shared__ float s_y[ROWS * OUT];
  __shared__ float s_w[K * F];
  __shared__ float s_scale[F];

  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * ROWS;
  const int rows = static_cast<int>(n - row0 < ROWS ? n - row0 : ROWS);

  for (int i = tid; i < K * F; i += THREADS) s_w[i] = w[i];
  if (tid < F) s_scale[tid] = scale[tid];
  for (int i = tid; i < rows * O * K; i += THREADS) {
    s_xo[i] = leaky(xo[row0 * (O * K) + i]);
  }
  for (int i = tid; i < rows * D * K; i += THREADS) {
    s_xd[i] = leaky(xd[row0 * (D * K) + i]);
  }
  for (int i = tid; i < rows * OUT; i += THREADS) {
    const int64_t r = row0 + i / OUT;
    const int64_t rr = (r / (rest_rep * rest_inner)) * rest_inner +
                       r % rest_inner;
    s_y[i] = rest[rr * OUT + i % OUT];
  }
  __syncthreads();

  const int r = tid / M;
  const int m = tid % M;
  if (r < rows) {
    const float* ao = s_xo + r * (O * K) + (m / D) * K;
    const float* ad = s_xd + r * (D * K) + (m % D) * K;
    float y[F];
#pragma unroll
    for (int f = 0; f < F; ++f) y[f] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float g = leaky(ao[k] + ad[k]);
#pragma unroll
      for (int f = 0; f < F; ++f) y[f] = y[f] + g * s_w[k * F + f];
    }
    float* o_ = s_y + r * OUT + m * F;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float z = y[f] + o_[f];
      o_[f] = (1.0f / (1.0f + expf(-z))) * s_scale[f];
    }
  }
  __syncthreads();

  for (int i = tid; i < rows * OUT; i += THREADS) {
    out[row0 * OUT + i] = s_y[i];
  }
}

}  // namespace

// Launches K2 on `stream`: xo (n, 8, 30), xd (n, 7, 30), w (30, 5),
// rest (n / rest_rep, 56, 5) where each run of rest_rep * rest_inner rows
// shares one block of rest_inner rest rows, scale (5,), out (n, 56, 5), all
// fp32 and contiguous. Returns cudaGetLastError().
extern "C" int mst_grid_tail(const void* xo, const void* xd, const void* w,
                             const void* rest, const void* scale, void* out,
                             int64_t n, int64_t rest_rep, int64_t rest_inner,
                             void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + ROWS - 1) / ROWS;
    grid_tail_kernel<<<static_cast<unsigned int>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xo), static_cast<const float*>(xd),
        static_cast<const float*>(w), static_cast<const float*>(rest),
        static_cast<const float*>(scale), static_cast<float*>(out), n,
        rest_rep, rest_inner);
  }
  return static_cast<int>(cudaGetLastError());
}
