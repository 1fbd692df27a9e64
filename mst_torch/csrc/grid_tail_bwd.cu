// K3: the note-grid tail of the pitched style applier, backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mst_tpu/ops/pallas_grid.py:_bwd_kernel
// (:167-194, launched by _tail_t_bwd, :234-258, the custom VJP of
// fused_grid_tail). The forward (K2, csrc/grid_tail.cu) is
//
//   out[n, o*D+d, f] = sigmoid(y[n,o,d,f] + rest) * scale[f]
//   y[n,o,d,f]       = sum_k LR(gp[n,o,d,k]) * w[k,f]
//   gp[n,o,d,k]      = LR(xo[n,o,k]) + LR(xd[n,d,k])
//
// with LR = leaky_relu(0.01). Given the saved output and the cotangent ct
// of out, this kernel recomputes gp from the two embeddings and writes:
//
//   ct_y[n,m,f]   = ct * (scale * s * (1 - s)),  s = out * (1 / scale)
//   ct_G[n,o,d,k] = sum_{f ascending} ct_y[n,o*D+d,f] * w[k,f]
//   ct_gp         = dLR(gp) * ct_G
//   ct_xo[n,o,k]  = dLR(xo) * sum_{d ascending} ct_gp[n,o,d,k]
//   ct_xd[n,d,k]  = dLR(xd) * sum_{o ascending} ct_gp[n,o,d,k]
//   ct_w parts    = per block, sum over its rows and (o, d) of
//                   LR(gp)[.,k] * ct_y[.,f]   -> (blocks, K, F)
//
// ct_y is also d rest before the channel sum (the wrapper does that sum).
// The per-block ct_w partials are summed by the wrapper, as
// ct_w_parts.sum(axis=0) is at pallas_grid.py:258. No float atomics: every
// sum runs in a fixed order, so two runs give bit-equal gradients. It
// follows _bwd_kernel's numerics, not autodiff's: s comes from the saved
// output times the reciprocal of the scale. The library is built with
// --fmad=false, so each multiply and add rounds on its own, as in the plain
// torch version (grid_kernel.grid_tail_bwd_plain), and ct_y, ct_xo and
// ct_xd agree with it bit for bit.
//
// What bounds it on the H100: bytes. Per row it reads xo, xd, out and ct
// (240 + 210 + 280 + 280 floats) and writes ct_xo, ct_xd and ct_y (240 +
// 210 + 280): 1,740 floats, 6,960 B. At the 327,680-row budget shape
// (8 x 8 x 128 x 4 x 10) that is 2.28 GB, 0.68 ms at 3.35 TB/s, against
// ~700 operations per (row, o, d), ~12.8 GFLOP, 0.19 ms at 67 TFLOP/s.
// Prediction before the first card run: about 3x the byte bound, as K2
// landed (1.49 ms against 0.45 ms), because this first version recomputes
// the grid three times (once per cotangent) and its ct_w phase runs on
// 300 of 448 threads.
//
// Design: a block takes ROWS consecutive rows. Its threads copy the rows'
// embeddings (leaky applied once) and w into shared memory, form ct_y from
// out and ct (written straight to global memory and kept in shared
// memory), and then compute, from shared memory only:
//   - ct_xo: one thread per (row, o, k) sums its 7 d terms in order;
//   - ct_xd: one thread per (row, d, k) sums its 8 o terms in order;
//   - ct_w: two threads per (k, f), each over half of the block's rows in
//     (row, o, d) order; their two sums are added in a fixed order.
// The (row, o, d, k) grid is never stored: each phase recomputes gp from
// the two embeddings. Rows stay in their natural layout; the TPU kernel's
// transposed rows-on-lanes layout is a TPU artefact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int O = 8;    // octaves
constexpr int D = 7;    // scale degrees
constexpr int K = 30;   // grid depth
constexpr int F = 5;    // output features
constexpr int M = O * D;
constexpr int OUT = M * F;
constexpr int ROWS = 8;
constexpr int THREADS = ROWS * M;  // 448
constexpr int KF = K * F;

struct Scale {
  float v[F];
};

__device__ __forceinline__ float leaky(float x) {
  return x >= 0.0f ? x : 0.01f * x;
}

// dLR(x) * c, without forming the derivative
__device__ __forceinline__ float dleaky_mul(float x, float c) {
  return x >= 0.0f ? c : 0.01f * c;
}

// ct_G[k] for one (row, o, d): ct_y[0] * w[k,0] + ... + ct_y[4] * w[k,4]
__device__ __forceinline__ float ct_grid(const float* cty, const float* w,
                                         int k) {
  float g = cty[0] * w[k * F];
#pragma unroll
  for (int f = 1; f < F; ++f) g = g + cty[f] * w[k * F + f];
  return g;
}

__global__ void __launch_bounds__(THREADS)
grid_tail_bwd_kernel(const float* __restrict__ xo,
                     const float* __restrict__ xd,
                     const float* __restrict__ out,
                     const float* __restrict__ ct,
                     const float* __restrict__ w, Scale scale,
                     float* __restrict__ ct_xo, float* __restrict__ ct_xd,
                     float* __restrict__ ct_y, float* __restrict__ ct_w_parts,
                     int64_t n) {
  __shared__ float s_ao[ROWS * O * K];
  __shared__ float s_ad[ROWS * D * K];
  __shared__ float s_cty[ROWS * OUT];
  __shared__ float s_w[KF];
  __shared__ float s_part[2 * KF];
  __shared__ float s_scale[F];

  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * ROWS;
  const int rows = static_cast<int>(n - row0 < ROWS ? n - row0 : ROWS);

  for (int i = tid; i < KF; i += THREADS) s_w[i] = w[i];
  if (tid == 0) {
#pragma unroll
    for (int f = 0; f < F; ++f) s_scale[f] = scale.v[f];
  }
  __syncthreads();
  for (int i = tid; i < rows * O * K; i += THREADS) {
    s_ao[i] = leaky(xo[row0 * (O * K) + i]);
  }
  for (int i = tid; i < rows * D * K; i += THREADS) {
    s_ad[i] = leaky(xd[row0 * (D * K) + i]);
  }
  for (int i = tid; i < rows * OUT; i += THREADS) {
    const float sc = s_scale[i % F];
    const float s = out[row0 * OUT + i] * (1.0f / sc);
    const float c = ct[row0 * OUT + i] * (sc * s * (1.0f - s));
    s_cty[i] = c;
    ct_y[row0 * OUT + i] = c;
  }
  __syncthreads();

  // ct_xo: thread per (row, o, k), sum over d in ascending order. LR keeps
  // the sign, so the leaky embedding's sign is the raw one's.
  for (int i = tid; i < rows * O * K; i += THREADS) {
    const int r = i / (O * K);
    const int o = (i / K) % O;
    const int k = i % K;
    const float ao = s_ao[i];
    const float* ad = s_ad + r * (D * K) + k;
    const float* cty = s_cty + r * OUT + o * (D * F);
    float acc = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float c = dleaky_mul(ao + ad[d * K], ct_grid(cty + d * F, s_w, k));
      acc = d == 0 ? c : acc + c;
    }
    ct_xo[row0 * (O * K) + i] = dleaky_mul(ao, acc);
  }

  // ct_xd: thread per (row, d, k), sum over o in ascending order
  for (int i = tid; i < rows * D * K; i += THREADS) {
    const int r = i / (D * K);
    const int d = (i / K) % D;
    const int k = i % K;
    const float ad = s_ad[i];
    const float* ao = s_ao + r * (O * K) + k;
    const float* cty = s_cty + r * OUT + d * F;
    float acc = 0.0f;
    for (int o = 0; o < O; ++o) {
      const float c = dleaky_mul(ao[o * K] + ad,
                                 ct_grid(cty + o * (D * F), s_w, k));
      acc = o == 0 ? c : acc + c;
    }
    ct_xd[row0 * (D * K) + i] = dleaky_mul(ad, acc);
  }

  // ct_w: two threads per (k, f), each over half of the block's rows
  if (tid < 2 * KF) {
    const int h = tid / KF;
    const int k = (tid % KF) / F;
    const int f = tid % F;
    const int r_end = rows < (h + 1) * (ROWS / 2) ? rows : (h + 1) * (ROWS / 2);
    float acc = 0.0f;
    for (int r = h * (ROWS / 2); r < r_end; ++r) {
      const float* ao = s_ao + r * (O * K) + k;
      const float* ad = s_ad + r * (D * K) + k;
      const float* cty = s_cty + r * OUT + f;
      for (int o = 0; o < O; ++o) {
        for (int d = 0; d < D; ++d) {
          acc = acc + leaky(ao[o * K] + ad[d * K]) * cty[(o * D + d) * F];
        }
      }
    }
    s_part[tid] = acc;
  }
  __syncthreads();
  if (tid < KF) {
    ct_w_parts[static_cast<int64_t>(blockIdx.x) * KF + tid] =
        s_part[tid] + s_part[KF + tid];
  }
}

}  // namespace

// Rows per block: the wrapper sizes the ct_w partials as
// (ceil(n / mst_grid_tail_bwd_rows()), 30, 5).
extern "C" int mst_grid_tail_bwd_rows() { return ROWS; }

// Launches K3 on `stream`: xo (n, 8, 30), xd (n, 7, 30), out and ct
// (n, 56, 5), w (30, 5), the five scales by value; writes ct_xo
// (n, 8, 30), ct_xd (n, 7, 30), ct_y (n, 56, 5) and ct_w_parts
// (ceil(n / 8), 30, 5). All fp32 and contiguous. Returns
// cudaGetLastError().
extern "C" int mst_grid_tail_bwd(const void* xo, const void* xd,
                                 const void* out, const void* ct,
                                 const void* w, float s0, float s1,
                                 float s2, float s3, float s4, void* ct_xo, void* ct_xd, void* ct_y,
                                 void* ct_w_parts, int64_t n, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + ROWS - 1) / ROWS;
    const Scale scale = {{s0, s1, s2, s3, s4}};
    grid_tail_bwd_kernel<<<static_cast<unsigned int>(blocks), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xo), static_cast<const float*>(xd),
        static_cast<const float*>(out), static_cast<const float*>(ct),
        static_cast<const float*>(w), scale, static_cast<float*>(ct_xo), static_cast<float*>(ct_xd),
        static_cast<float*>(ct_y), static_cast<float*>(ct_w_parts), n);
  }
  return static_cast<int>(cudaGetLastError());
}
