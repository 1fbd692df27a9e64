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
//
// The bf16 form (BF16 = true; the bf16 storage policy) reads xo and xd as
// bf16 and writes the output as bf16; w and rest stay fp32. It rounds
// where JAX's jnp tail rounds on bf16 inputs (pallas_grid.py:264-273, its
// jaxpr; grid_kernel.grid_tail_plain lists the points): LR(xo), LR(xd),
// their sum gp and LR(gp) are bf16 values, the slope is bf16(0.01) and
// each product or sum rounds once (fp32 arithmetic, then
// __float2bfloat16_rn; the fp32 product of two bf16 values is exact);
// grid * w, the K-sum, the sigmoid and the scale are fp32; the output
// rounds once to bf16 (appliers.py:89's cast_storage, fused). Per row it
// moves 480 + 420 B of embeddings, 1,120 B of rest and 560 B of output:
// 1.27 GB at 491,520 rows (0.78 GB with rest read once per song, a bound
// of 0.23 ms). Each rounding is a cvt.rn.bf16.f32 and a shift back, four
// of them a term, so this form is bound by issue: on an NVIDIA H100 80GB
// HBM3 at 700 W (chip_smoke.py) the launch takes 1.11 ms at 491,520 rows,
// 1.12 ms computing alone and 0.30 ms moving its bytes alone. Its tile
// keeps the output in a slot of its own (4,480 B), so a stage is 20,640 B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
constexpr float SLOPE_BF16 = 0.010009765625f;  // bf16(0.01)

// The element type of xo, xd and the output, and a pair of them, by form.
template <bool BF16>
using Elem = typename std::conditional<BF16, __nv_bfloat16, float>::type;
template <bool BF16>
using Pair = typename std::conditional<BF16, __nv_bfloat162, float2>::type;

// The tile's layout in one stage of the ring, by form: xo, xd, rest and,
// for bf16, the output (the fp32 form writes its output over rest).
template <bool BF16>
struct Layout {
  static constexpr int E = sizeof(Elem<BF16>);
  static constexpr int XO_BYTES = ROWS * O * K * E;     // 7,680 / 3,840
  static constexpr int XD_BYTES = ROWS * D * K * E;     // 6,720 / 3,360
  static constexpr int REST_BYTES = ROWS * OUT * 4;     // 8,960
  static constexpr int OUT_BYTES = BF16 ? ROWS * OUT * E : 0;  // 0 / 4,480
  static constexpr int STAGE_BYTES =
      XO_BYTES + XD_BYTES + REST_BYTES + OUT_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(STAGE_BYTES % 16 == 0, "stages start on 16 bytes");
};

__constant__ float c_w[K * F];

struct Scale {
  float v[F];
};

// x rounded to bf16, as a float
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  return BF16 ? rbf(x) : x;
}

template <bool BF16>
__device__ __forceinline__ float leaky(float x) {
  // the same bits as x >= 0 ? x : 0.01f * x for every x, +-0 and NaN; in
  // the bf16 form the product is bf16(0.01) * x, rounded to bf16
  return BF16 ? fmaxf(x, rbf(SLOPE_BF16 * x)) : fmaxf(x, 0.01f * x);
}

__device__ __forceinline__ float2 to_float2(float2 v) { return v; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

// the leaky of a pair, stored back at the pair's type (exact: the result
// is a value of that type)
__device__ __forceinline__ float2 leaky_pair(float2 v) {
  return make_float2(leaky<false>(v.x), leaky<false>(v.y));
}
__device__ __forceinline__ __nv_bfloat162 leaky_pair(__nv_bfloat162 v) {
  const float2 f = __bfloat1622float2(v);
  return __floats2bfloat162_rn(leaky<true>(f.x), leaky<true>(f.y));
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
    const float g_ = leaky<BF16>(gp);            \
    y0 = y0 + g_ * c_w[(k) * F + 0];             \
    y1 = y1 + g_ * c_w[(k) * F + 1];             \
    y2 = y2 + g_ * c_w[(k) * F + 2];             \
    y3 = y3 + g_ * c_w[(k) * F + 3];             \
    y4 = y4 + g_ * c_w[(k) * F + 4];             \
  }

// The consumers' work on one tile in the ring: the leaky in place, then
// thread (r, o, d) sums its 30 terms for its 5 features and writes its 5
// outputs: over its rest values (fp32 form) or into the output slot (bf16).
template <bool BF16>
__device__ __forceinline__ void compute_tile(Elem<BF16>* s_xo,
                                             Elem<BF16>* s_xd,
                                             float* s_rest, Elem<BF16>* s_out,
                                             int rows, int tid, int r, int mm,
                                             int o, int d,
                                             const Scale& scale) {
  // the leaky, once per element, in place (both spans are whole pairs)
  Pair<BF16>* xo2 = reinterpret_cast<Pair<BF16>*>(s_xo);
  Pair<BF16>* xd2 = reinterpret_cast<Pair<BF16>*>(s_xd);
  for (int j = tid; j < rows * (O * K / 2); j += CONSUMERS) {
    xo2[j] = leaky_pair(xo2[j]);
  }
  for (int j = tid; j < rows * (D * K / 2); j += CONSUMERS) {
    xd2[j] = leaky_pair(xd2[j]);
  }
  consumers_sync();
  if (r >= rows) return;
  const Pair<BF16>* ao =
      reinterpret_cast<const Pair<BF16>*>(s_xo + r * (O * K) + o * K);
  const Pair<BF16>* ad =
      reinterpret_cast<const Pair<BF16>*>(s_xd + r * (D * K) + d * K);
  float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f, y3 = 0.0f, y4 = 0.0f;
#pragma unroll
  for (int kk = 0; kk < K / 2; ++kk) {
    const float2 a = to_float2(ao[kk]);
    const float2 b = to_float2(ad[kk]);
    MST_TERM(2 * kk, rnd<BF16>(a.x + b.x));
    MST_TERM(2 * kk + 1, rnd<BF16>(a.y + b.y));
  }
  float* o_ = s_rest + r * OUT + mm * F;
  const float y[F] = {y0, y1, y2, y3, y4};
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float z = y[f] + o_[f];
    const float v = (1.0f / (1.0f + expf(-z))) * scale.v[f];
    if constexpr (BF16) {
      s_out[r * OUT + mm * F + f] = __float2bfloat16_rn(v);
    } else {
      o_[f] = v;
    }
  }
}

// What a launch does. FULL is K2. The other two exist to measure it
// (chip_smoke.py times them): COPY_ONLY moves the same bytes through the
// ring (the tile's rest span goes back out as its output) and computes
// nothing; COMPUTE_ONLY runs the consumers on a zeroed ring and neither
// reads nor writes device memory.
enum Mode { FULL = 0, COPY_ONLY = 1, COMPUTE_ONLY = 2 };

template <int MODE, bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
grid_tail_kernel(const Elem<BF16>* __restrict__ xo,
                 const Elem<BF16>* __restrict__ xd,
                 const float* __restrict__ rest, Elem<BF16>* __restrict__ out,
                 int64_t n, int64_t rest_rep, int64_t rest_inner,
                 Scale scale) {
  using L = Layout<BF16>;
  using E = Elem<BF16>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + STAGES * L::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const int64_t n_tiles = (n + ROWS - 1) / ROWS;

  if (MODE == COMPUTE_ONLY) {
    for (int j = tid; j < STAGES * L::STAGE_BYTES / 4; j += THREADS) {
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
      unsigned char* st = smem + s * L::STAGE_BYTES;
      E* s_xo = reinterpret_cast<E*>(st);
      E* s_xd = reinterpret_cast<E*>(st + L::XO_BYTES);
      float* s_rest = reinterpret_cast<float*>(st + L::XO_BYTES +
                                               L::XD_BYTES);
      const int64_t r0 = t * ROWS;
      const int rows = static_cast<int>(n - r0 < ROWS ? n - r0 : ROWS);
      if (MODE == COMPUTE_ONLY) {
        if (lane == 0) mbar_arrive(&full[s]);
      } else if (rows == ROWS) {
        if (lane == 0) {
          mbar_expect_tx(&full[s],
                         L::XO_BYTES + L::XD_BYTES + L::REST_BYTES);
          bulk_load(s_xo, xo + r0 * (O * K), L::XO_BYTES, &full[s]);
          bulk_load(s_xd, xd + r0 * (D * K), L::XD_BYTES, &full[s]);
          // the rest rows: one division for the tile, then 32-bit steps;
          // with rest_rep 1 they are the tile's own rows
          const int64_t q = r0 / rest_inner;      // (song, channel) index
          int m = static_cast<int>(r0 - q * rest_inner);
          int64_t base = (q / rest_rep) * rest_inner;
          int64_t qi = q;
          int done = 0;
          if (rest_rep == 1) {
            bulk_load(s_rest, rest + r0 * OUT, L::REST_BYTES, &full[s]);
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
    unsigned char* st = smem + s * L::STAGE_BYTES;
    E* s_xo = reinterpret_cast<E*>(st);
    E* s_xd = reinterpret_cast<E*>(st + L::XO_BYTES);
    float* s_rest =
        reinterpret_cast<float*>(st + L::XO_BYTES + L::XD_BYTES);
    E* s_out = reinterpret_cast<E*>(st + L::XO_BYTES + L::XD_BYTES +
                                    L::REST_BYTES);
    const int64_t r0 = t * ROWS;
    const int rows = static_cast<int>(n - r0 < ROWS ? n - r0 : ROWS);
    mbar_wait(&full[s], (i / STAGES) & 1);
    if (MODE != COPY_ONLY) {
      compute_tile<BF16>(s_xo, s_xd, s_rest, s_out, rows, tid, r, mm, o, d,
                         scale);
    }
    fence_async_smem();
    consumers_sync();

    if (tid == 0) {
      if (MODE != COMPUTE_ONLY) {
        // the fp32 form's outputs overwrote rest; the bf16 form's have a
        // slot (in copy-only mode it holds no result)
        const void* src = BF16 ? static_cast<const void*>(s_out)
                               : static_cast<const void*>(s_rest);
        bulk_store(out + r0 * OUT, src,
                   static_cast<uint32_t>(rows) * OUT * sizeof(E));
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

// (dynamic shared memory bytes, threads per block, resident blocks per SM)
// of K2's launch in the fp32 form (bf16 0) or the bf16 form (bf16 1). The
// first call for a form sets its kernels' shared-memory limit.
template <bool BF16>
int launch_info(int* info) {
  static int per_sm = 0;
  constexpr int smem = Layout<BF16>::SMEM_BYTES;
  cudaError_t err = cudaSuccess;
  if (per_sm == 0) {
    const void* kernels[] = {
        reinterpret_cast<const void*>(grid_tail_kernel<FULL, BF16>),
        reinterpret_cast<const void*>(grid_tail_kernel<COPY_ONLY, BF16>),
        reinterpret_cast<const void*>(grid_tail_kernel<COMPUTE_ONLY, BF16>)};
    for (const void* kernel : kernels) {
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      }
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, grid_tail_kernel<FULL, BF16>, THREADS, smem);
    }
  }
  info[0] = smem;
  info[1] = THREADS;
  info[2] = per_sm;
  return static_cast<int>(err);
}

template <bool BF16>
int launch(int mode, const void* xo, const void* xd, const void* w,
           const void* rest, Scale scale, void* out, int64_t n,
           int64_t rest_rep, int64_t rest_inner, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int info[3];
  int device = 0, sms = 0;
  cudaError_t err = static_cast<cudaError_t>(launch_info<BF16>(info));
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
  auto kernel = mode == COPY_ONLY ? grid_tail_kernel<COPY_ONLY, BF16>
                : mode == COMPUTE_ONLY
                    ? grid_tail_kernel<COMPUTE_ONLY, BF16>
                    : grid_tail_kernel<FULL, BF16>;
  using E = Elem<BF16>;
  kernel<<<static_cast<unsigned int>(blocks), THREADS, info[0], st>>>(
      static_cast<const E*>(xo), static_cast<const E*>(xd),
      static_cast<const float*>(rest), static_cast<E*>(out), n, rest_rep,
      rest_inner, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_form(int bf16, int mode, const void* xo, const void* xd,
                const void* w, const void* rest, Scale scale, void* out,
                int64_t n, int64_t rest_rep, int64_t rest_inner,
                void* stream) {
  return bf16 ? launch<true>(mode, xo, xd, w, rest, scale, out, n, rest_rep,
                             rest_inner, stream)
              : launch<false>(mode, xo, xd, w, rest, scale, out, n, rest_rep,
                              rest_inner, stream);
}

}  // namespace

extern "C" int mst_grid_tail_info(int bf16, int* info) {
  return bf16 ? launch_info<true>(info) : launch_info<false>(info);
}

// Launches K2 on `stream`: xo (n, 8, 30), xd (n, 7, 30), w (30, 5),
// rest (n / rest_rep, 56, 5) where each run of rest_rep * rest_inner rows
// shares one block of rest_inner rest rows, out (n, 56, 5), contiguous and
// 16-byte aligned; the five scales by value. xo, xd and out are fp32, or
// bf16 when `bf16` is not 0; w and rest are fp32. Returns the first CUDA
// error, or 0.
extern "C" int mst_grid_tail(const void* xo, const void* xd, const void* w,
                             const void* rest, float s0, float s1, float s2,
                             float s3, float s4, void* out, int64_t n,
                             int64_t rest_rep, int64_t rest_inner, int bf16,
                             void* stream) {
  return launch_form(bf16, FULL, xo, xd, w, rest,
                     Scale{{s0, s1, s2, s3, s4}}, out, n, rest_rep,
                     rest_inner, stream);
}

// The same launch in one of the measuring modes (1: copy only, 2: compute
// only); `out` then holds no result.
extern "C" int mst_grid_tail_variant(int mode, int bf16, const void* xo,
                                     const void* xd, const void* w,
                                     const void* rest, void* out, int64_t n,
                                     int64_t rest_rep, int64_t rest_inner,
                                     void* stream) {
  return launch_form(bf16, mode, xo, xd, w, rest,
                     Scale{{1.0f, 1.0f, 1.0f, 1.0f, 1.0f}}, out, n, rest_rep,
                     rest_inner, stream);
}
