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
// What bounds it on the H100: instruction issue, then bytes. Per row it
// reads 240 + 210 floats of embeddings and 280 of rest and writes 280
// outputs: 1.50 GB at the main path's 491,520 rows, 0.449 ms at 3.35 TB/s.
// The library is built with --fmad=false so that every term rounds its
// multiply and its add apart, as the plain torch version does: a term is
// an add, the leaky (FMUL + FMNMX) and 5 x (FMUL + FADD), plus the loads
// of its operands, and each of the 280 outputs of a row ends in an IEEE
// expf and division (the bits of torch's sigmoid), ~30 instructions each.
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py) the launch takes
// 0.80 ms computing alone and 0.61 ms moving its bytes alone, and 0.83 ms
// doing both: the copies hide behind the arithmetic. The (O, D, K) grid
// behind each row (3.3 GB over the batch) never leaves registers.
//
// Design: a persistent grid (as many blocks as the card holds, at most
// one per tile) walks tiles of ROWS = 8 rows. In each block one producer
// warp keeps up to STAGES tiles in flight: 1-D TMA bulk copies
// (cp.async.bulk with an mbarrier) of the tile's contiguous xo, xd and
// rest spans into a ring in shared memory. The rest span is found once per
// tile: one division gives the first rest row, and rows step from there in
// 32-bit arithmetic, wrapping at rest_inner, with one copy per contiguous
// run (a tile that crosses a (song, channel) boundary takes two). 448
// consumer threads, one per (row, o, d), apply the leaky to the tile's
// embeddings in place, then sum in ascending k: the embeddings come from
// shared memory 2 k at a time, the weights from the constant bank (w is
// copied to __constant__ memory, stream-ordered, before the launch), so a
// term costs an add, the leaky (FMUL + FMNMX) and 5 x (FMUL + FADD). Each
// thread overwrites its 5 rest values in the ring with its outputs, and
// one thread stores the (rows, 280) tile back with a TMA bulk store. The
// scale comes by value. A ragged last tile (fewer than 8 rows) is copied
// by the producer warp with plain loads. The TPU kernel's transposed
// rows-on-lanes layout (pallas_grid.py:23-28) is a TPU artefact; rows stay
// in their natural layout. The ring's barriers and bulk copies come from
// tile_ring.cuh, which K3 (grid_tail_bwd.cu) shares.
//
// w lives in one __constant__ array per process: two launches on two
// streams with different weights would race. The port runs on one stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_ring.cuh"

namespace {

using namespace tile_ring;

constexpr int O = 8;    // octaves
constexpr int D = 7;    // scale degrees
constexpr int K = 30;   // grid depth (5 features x 6)
constexpr int F = 5;    // output features
constexpr int M = O * D;
constexpr int OUT = M * F;            // 280 floats per row
constexpr int ROWS = 8;               // rows per tile
constexpr int CONSUMERS = ROWS * M;   // 448: one thread per (row, o, d)
constexpr int THREADS = CONSUMERS + 32;   // + one producer warp
constexpr int STAGES = 4;
constexpr int XO_BYTES = ROWS * O * K * 4;     // 7,680
constexpr int XD_BYTES = ROWS * D * K * 4;     // 6,720
constexpr int REST_BYTES = ROWS * OUT * 4;     // 8,960
constexpr int STAGE_BYTES = XO_BYTES + XD_BYTES + REST_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8;

__constant__ float c_w[K * F];

struct Scale {
  float v[F];
};

__device__ __forceinline__ float leaky(float x) {
  // the same bits as x >= 0 ? x : 0.01f * x for every x, +-0 and NaN
  return fmaxf(x, 0.01f * x);
}

__device__ __forceinline__ void consumers_sync() {
  named_sync<CONSUMERS>();
}

// the rest row of output row r: the channel index dropped
__device__ __forceinline__ int64_t rest_row(int64_t r, int64_t rest_rep,
                                            int64_t rest_inner) {
  return (r / (rest_rep * rest_inner)) * rest_inner + r % rest_inner;
}

// one term: y[f] += LR(gp) * w[k, f], one rounded multiply and add each
#define MST_TERM(k, gp)                          \
  {                                              \
    const float g_ = leaky(gp);                  \
    y0 = y0 + g_ * c_w[(k) * F + 0];             \
    y1 = y1 + g_ * c_w[(k) * F + 1];             \
    y2 = y2 + g_ * c_w[(k) * F + 2];             \
    y3 = y3 + g_ * c_w[(k) * F + 3];             \
    y4 = y4 + g_ * c_w[(k) * F + 4];             \
  }

// The consumers' work on one tile in the ring: the leaky in place, then
// thread (r, o, d) sums its 30 terms for its 5 features and overwrites its
// 5 rest values with the outputs.
__device__ __forceinline__ void compute_tile(float* s_xo, float* s_xd,
                                             float* s_rest, int rows, int tid,
                                             int r, int mm, int o, int d,
                                             const Scale& scale) {
  // the leaky, once per element, in place (both spans are whole float2s)
  float2* xo2 = reinterpret_cast<float2*>(s_xo);
  float2* xd2 = reinterpret_cast<float2*>(s_xd);
  for (int j = tid; j < rows * (O * K / 2); j += CONSUMERS) {
    const float2 v = xo2[j];
    xo2[j] = make_float2(leaky(v.x), leaky(v.y));
  }
  for (int j = tid; j < rows * (D * K / 2); j += CONSUMERS) {
    const float2 v = xd2[j];
    xd2[j] = make_float2(leaky(v.x), leaky(v.y));
  }
  consumers_sync();
  if (r >= rows) return;
  const float2* ao = reinterpret_cast<const float2*>(s_xo + r * (O * K) +
                                                     o * K);
  const float2* ad = reinterpret_cast<const float2*>(s_xd + r * (D * K) +
                                                     d * K);
  float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f, y3 = 0.0f, y4 = 0.0f;
#pragma unroll
  for (int kk = 0; kk < K / 2; ++kk) {
    const float2 a = ao[kk];
    const float2 b = ad[kk];
    MST_TERM(2 * kk, a.x + b.x);
    MST_TERM(2 * kk + 1, a.y + b.y);
  }
  float* o_ = s_rest + r * OUT + mm * F;
  const float y[F] = {y0, y1, y2, y3, y4};
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float z = y[f] + o_[f];
    o_[f] = (1.0f / (1.0f + expf(-z))) * scale.v[f];
  }
}

// What a launch does. FULL is K2. The other two exist to measure it
// (chip_smoke.py times them): COPY_ONLY moves the same bytes through the
// ring (the tile's rest span goes back out as its output) and computes
// nothing; COMPUTE_ONLY runs the consumers on a zeroed ring and neither
// reads nor writes device memory.
enum Mode { FULL = 0, COPY_ONLY = 1, COMPUTE_ONLY = 2 };

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
grid_tail_kernel(const float* __restrict__ xo, const float* __restrict__ xd,
                 const float* __restrict__ rest, float* __restrict__ out,
                 int64_t n, int64_t rest_rep, int64_t rest_inner,
                 Scale scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const int64_t n_tiles = (n + ROWS - 1) / ROWS;

  if (MODE == COMPUTE_ONLY) {
    for (int j = tid; j < STAGES * STAGE_BYTES / 4; j += THREADS) {
      reinterpret_cast<float*>(smem)[j] = 0.0f;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warp ----
    const int lane = tid - CONSUMERS;
    int i = 0;
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
      const int s = i % STAGES;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
      unsigned char* st = smem + s * STAGE_BYTES;
      float* s_xo = reinterpret_cast<float*>(st);
      float* s_xd = reinterpret_cast<float*>(st + XO_BYTES);
      float* s_rest = reinterpret_cast<float*>(st + XO_BYTES + XD_BYTES);
      const int64_t r0 = t * ROWS;
      const int rows = static_cast<int>(n - r0 < ROWS ? n - r0 : ROWS);
      if (MODE == COMPUTE_ONLY) {
        if (lane == 0) mbar_arrive(&full[s]);
      } else if (rows == ROWS) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], STAGE_BYTES);
          bulk_load(s_xo, xo + r0 * (O * K), XO_BYTES, &full[s]);
          bulk_load(s_xd, xd + r0 * (D * K), XD_BYTES, &full[s]);
          // the rest rows: one division for the tile, then 32-bit steps;
          // with rest_rep 1 they are the tile's own rows
          const int64_t q = r0 / rest_inner;      // (song, channel) index
          int m = static_cast<int>(r0 - q * rest_inner);
          int64_t base = (q / rest_rep) * rest_inner;
          int64_t qi = q;
          int done = 0;
          if (rest_rep == 1) {
            bulk_load(s_rest, rest + r0 * OUT, REST_BYTES, &full[s]);
            done = ROWS;
          }
          while (done < ROWS) {
            const int64_t left = rest_inner - m;
            const int len = static_cast<int>(left < ROWS - done ? left
                                                                : ROWS - done);
            bulk_load(s_rest + done * OUT, rest + (base + m) * OUT,
                      static_cast<uint32_t>(len) * OUT * 4, &full[s]);
            done += len;
            m = 0;
            ++qi;
            base = (qi / rest_rep) * rest_inner;
          }
        }
      } else {
        // the ragged last tile: plain loads by the whole warp
        for (int j = lane; j < rows * O * K; j += 32) {
          s_xo[j] = xo[r0 * (O * K) + j];
        }
        for (int j = lane; j < rows * D * K; j += 32) {
          s_xd[j] = xd[r0 * (D * K) + j];
        }
        for (int j = lane; j < rows * OUT; j += 32) {
          const int64_t rr = rest_row(r0 + j / OUT, rest_rep, rest_inner);
          s_rest[j] = rest[rr * OUT + j % OUT];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumers: thread (r, o, d) ----
  const int r = tid / M;
  const int mm = tid % M;
  const int o = mm / D;
  const int d = mm % D;
  int i = 0;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
    const int s = i % STAGES;
    unsigned char* st = smem + s * STAGE_BYTES;
    float* s_xo = reinterpret_cast<float*>(st);
    float* s_xd = reinterpret_cast<float*>(st + XO_BYTES);
    float* s_rest = reinterpret_cast<float*>(st + XO_BYTES + XD_BYTES);
    const int64_t r0 = t * ROWS;
    const int rows = static_cast<int>(n - r0 < ROWS ? n - r0 : ROWS);
    mbar_wait(&full[s], (i / STAGES) & 1);
    if (MODE != COPY_ONLY) {
      compute_tile(s_xo, s_xd, s_rest, rows, tid, r, mm, o, d, scale);
    }
    fence_async_smem();
    consumers_sync();

    if (tid == 0) {
      if (MODE != COMPUTE_ONLY) {
        bulk_store(out + r0 * OUT, s_rest,
                   static_cast<uint32_t>(rows) * OUT * 4);
        bulk_commit();
      }
      // the previous tile's store has read its stage: hand that stage back
      bulk_wait_read<1>();
      if (i > 0) mbar_arrive(&empty[(i - 1) % STAGES]);
    }
  }
  if (tid == 0) bulk_wait_all();
}

#undef MST_TERM

}  // namespace

// (dynamic shared memory bytes, threads per block, resident blocks per SM)
// of K2's launch. The first call sets the kernel's shared-memory limit.
extern "C" int mst_grid_tail_info(int* info) {
  static int per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (per_sm == 0) {
    const void* kernels[] = {
        reinterpret_cast<const void*>(grid_tail_kernel<FULL>),
        reinterpret_cast<const void*>(grid_tail_kernel<COPY_ONLY>),
        reinterpret_cast<const void*>(grid_tail_kernel<COMPUTE_ONLY>)};
    for (const void* kernel : kernels) {
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      }
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, grid_tail_kernel<FULL>, THREADS, SMEM_BYTES);
    }
  }
  info[0] = SMEM_BYTES;
  info[1] = THREADS;
  info[2] = per_sm;
  return static_cast<int>(err);
}

namespace {

int launch(int mode, const void* xo, const void* xd, const void* w,
           const void* rest, Scale scale, void* out, int64_t n,
           int64_t rest_rep, int64_t rest_inner, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int info[3];
  int device = 0, sms = 0;
  cudaError_t err = static_cast<cudaError_t>(mst_grid_tail_info(info));
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbolAsync(c_w, w, sizeof(float) * K * F, 0,
                                  cudaMemcpyDeviceToDevice, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info[2] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t tiles = (n + ROWS - 1) / ROWS;
  int64_t blocks = static_cast<int64_t>(info[2]) * sms;
  if (blocks > tiles) blocks = tiles;
  auto kernel = mode == COPY_ONLY      ? grid_tail_kernel<COPY_ONLY>
                : mode == COMPUTE_ONLY ? grid_tail_kernel<COMPUTE_ONLY>
                                       : grid_tail_kernel<FULL>;
  kernel<<<static_cast<unsigned int>(blocks), THREADS, SMEM_BYTES, st>>>(
      static_cast<const float*>(xo), static_cast<const float*>(xd),
      static_cast<const float*>(rest), static_cast<float*>(out), n, rest_rep,
      rest_inner, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K2 on `stream`: xo (n, 8, 30), xd (n, 7, 30), w (30, 5),
// rest (n / rest_rep, 56, 5) where each run of rest_rep * rest_inner rows
// shares one block of rest_inner rest rows, out (n, 56, 5), all fp32,
// contiguous and 16-byte aligned; the five scales by value. Returns the
// first CUDA error, or 0.
extern "C" int mst_grid_tail(const void* xo, const void* xd, const void* w,
                             const void* rest, float s0, float s1, float s2,
                             float s3, float s4, void* out, int64_t n,
                             int64_t rest_rep, int64_t rest_inner,
                             void* stream) {
  return launch(FULL, xo, xd, w, rest, Scale{{s0, s1, s2, s3, s4}}, out, n,
                rest_rep, rest_inner, stream);
}

// The same launch in one of the measuring modes (1: copy only, 2: compute
// only); `out` then holds no result.
extern "C" int mst_grid_tail_variant(int mode, const void* xo,
                                     const void* xd, const void* w,
                                     const void* rest, void* out, int64_t n,
                                     int64_t rest_rep, int64_t rest_inner,
                                     void* stream) {
  return launch(mode, xo, xd, w, rest, Scale{{1.0f, 1.0f, 1.0f, 1.0f, 1.0f}},
                out, n, rest_rep, rest_inner, stream);
}
