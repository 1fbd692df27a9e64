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
// each product or sum rounds once; grid * w, the K-sum, the sigmoid and
// the scale are fp32; the output rounds once to bf16 (appliers.py:89's
// cast_storage, fused). Per row it moves 480 + 420 B of embeddings, 1,120
// B of rest and 560 B of output: a bound of 0.235 ms at 491,520 rows.
// Those bytes leave it bound by issue, and its design spends as few
// instructions on the bf16 roundings as the bits allow. The bf16 work is
// packed two lanes to an instruction (bf16x2.cuh): add.rn.bf16x2,
// mul.rn.bf16x2 and max.bf16x2 each round both halves once and correctly,
// which is what the fp32 operation rounded to bf16 gives. One pass per
// tile writes LR(xo) and LR(xd) (a mul and a max per pair) into padded
// rows of 80 B in shared memory, so a thread reads 8 k of an operand with
// one 16-byte load, without bank conflicts. Each of 224 consumer threads
// owns two cells, (2p, d) and (2p + 1, d) of a row, which share LR(xd)
// and the weights' loads; per pair of k it forms both cells' gp with
// add.rn.bf16x2 and LR(gp) with a mul and a max, then unpacks each bf16
// with one shift or mask for the fp32 terms. The output goes as bf16 over
// the first half of the tile's rest slot (each thread reads its 10 rest
// values first), so a stage is 16,160 B and three blocks fit on an SM.
// What bounds it now: issue, at ~14 SASS instructions a term (one scalar
// cvt and shift per rounding took ~23), 10 of them the fp32 multiplies and
// adds that the bits require (no FMA, no tensor cores: either would round
// otherwise), and the IEEE sigmoid of each output, ~35 instructions, about
// a third of the work. On an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py) it takes 0.72 ms at 491,520 rows, 0.71 ms computing
// alone and 0.31 ms moving its bytes alone. A fast sigmoid (__expf,
// __fdividef) with an exact fallback near bf16 rounding midpoints kept the
// bits (a sweep of all 2**32 z agreed) but was slower end to end: with 32
// lanes of 10 outputs, a sizable share of warps needs a fallback at any
// safe margin, which puts an exact epilogue on nearly every tile's path to
// its barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16x2.cuh"
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
constexpr int STAGES = 4;
constexpr int LR_ROWS = O + D;        // bf16 form: LR rows per tile row
constexpr int LR_PAIRS = 20;          // bf16 pairs per padded LR row (80 B)

// The element type of xo, xd and the output, by form.
template <bool BF16>
using Elem = typename std::conditional<BF16, __nv_bfloat16, float>::type;

// The consumers by form: the fp32 form runs one thread per (row, o, d),
// the bf16 form one per (row, octave pair, d).
template <bool BF16>
struct Shape {
  static constexpr int CONSUMERS = BF16 ? ROWS * (O / 2) * D : ROWS * M;
  static constexpr int THREADS = CONSUMERS + 32;   // + one producer warp
  static constexpr int MIN_BLOCKS = BF16 ? 3 : 2;  // per SM
};

// The tile's layout in one stage of the ring (xo, xd, rest; both forms
// write the output over rest), then, for bf16, the LR rows of the block.
template <bool BF16>
struct Layout {
  static constexpr int E = sizeof(Elem<BF16>);
  static constexpr int XO_BYTES = ROWS * O * K * E;     // 7,680 / 3,840
  static constexpr int XD_BYTES = ROWS * D * K * E;     // 6,720 / 3,360
  static constexpr int REST_BYTES = ROWS * OUT * 4;     // 8,960
  static constexpr int STAGE_BYTES = XO_BYTES + XD_BYTES + REST_BYTES;
  static constexpr int LR_BYTES = BF16 ? ROWS * LR_ROWS * LR_PAIRS * 4 : 0;
  static constexpr int SMEM_BYTES =
      STAGES * STAGE_BYTES + LR_BYTES + 2 * STAGES * 8;
  static_assert(STAGE_BYTES % 16 == 0, "stages start on 16 bytes");
};

__constant__ float c_w[K * F];

struct Scale {
  float v[F];
};

__device__ __forceinline__ float leaky(float x) {
  // the same bits as x >= 0 ? x : 0.01f * x for every x, +-0 and NaN
  return fmaxf(x, 0.01f * x);
}

// sigmoid(z) * scale: torch's sigmoid, 1 / (1 + exp(-z)), in IEEE fp32
__device__ __forceinline__ float sigmoid_scaled(float z, float scale) {
  return (1.0f / (1.0f + expf(-z))) * scale;
}

// one term: y[f] += g * w[k, f], one rounded multiply and add each
#define MST_TERM(y, k, g)                        \
  {                                              \
    const float g_ = (g);                        \
    y[0] = y[0] + g_ * c_w[(k) * F + 0];         \
    y[1] = y[1] + g_ * c_w[(k) * F + 1];         \
    y[2] = y[2] + g_ * c_w[(k) * F + 2];         \
    y[3] = y[3] + g_ * c_w[(k) * F + 3];         \
    y[4] = y[4] + g_ * c_w[(k) * F + 4];         \
  }

template <bool BF16>
__device__ __forceinline__ void consumers_sync() {
  named_sync<Shape<BF16>::CONSUMERS>();
}

// the rest row of output row r: the channel index dropped
__device__ __forceinline__ int64_t rest_row(int64_t r, int64_t rest_rep,
                                            int64_t rest_inner) {
  return (r / (rest_rep * rest_inner)) * rest_inner + r % rest_inner;
}

// The fp32 consumers' work on one tile in the ring: the leaky in place,
// then thread (r, o, d) sums its 30 terms for its 5 features and writes
// its 5 outputs over its rest values.
__device__ __forceinline__ void compute_tile(float* s_xo, float* s_xd,
                                             float* s_rest, int rows, int tid,
                                             int r, int mm, int o, int d,
                                             const Scale& scale) {
  // the leaky, once per element, in place (both spans are whole pairs)
  float2* xo2 = reinterpret_cast<float2*>(s_xo);
  float2* xd2 = reinterpret_cast<float2*>(s_xd);
  for (int j = tid; j < rows * (O * K / 2); j += Shape<false>::CONSUMERS) {
    xo2[j] = make_float2(leaky(xo2[j].x), leaky(xo2[j].y));
  }
  for (int j = tid; j < rows * (D * K / 2); j += Shape<false>::CONSUMERS) {
    xd2[j] = make_float2(leaky(xd2[j].x), leaky(xd2[j].y));
  }
  consumers_sync<false>();
  if (r >= rows) return;
  const float2* ao = reinterpret_cast<const float2*>(s_xo + r * (O * K) +
                                                     o * K);
  const float2* ad = reinterpret_cast<const float2*>(s_xd + r * (D * K) +
                                                     d * K);
  float y[F] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int kk = 0; kk < K / 2; ++kk) {
    const float2 a = ao[kk];
    const float2 b = ad[kk];
    MST_TERM(y, 2 * kk, leaky(a.x + b.x));
    MST_TERM(y, 2 * kk + 1, leaky(a.y + b.y));
  }
  float* o_ = s_rest + r * OUT + mm * F;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    o_[f] = sigmoid_scaled(y[f] + o_[f], scale.v[f]);
  }
}

// The bf16 consumers' work on one tile: thread (r, p, d) owns the cells
// (2p, d) and (2p + 1, d) of row r. The tile's xo and xd stay as they
// came; their LR goes into the block's padded LR rows `lr` (pairs: tile
// row r, LR row e < 8 for octave e, 8 + d for degree d, 20 pairs each).
// The outputs go as bf16 over the first half of the rest slot.
__device__ __forceinline__ void compute_tile_bf16(
    const __nv_bfloat16* s_xo, const __nv_bfloat16* s_xd, float* s_rest,
    uint32_t* lr, int rows, int tid, int r, int p, int d,
    const Scale& scale) {
  constexpr int CONSUMERS = Shape<true>::CONSUMERS;
  // this thread's rest values, read before any thread writes an output
  float rest[2][F];
  if (r < rows) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        rest[c][f] = s_rest[r * OUT + ((2 * p + c) * D + d) * F + f];
      }
    }
  }
  // LR of each (row, LR row, chunk of 8 k): three or four pairs of the
  // unpadded span (4-byte aligned) into one 16-byte store
  for (int j = tid; j < rows * LR_ROWS * 4; j += CONSUMERS) {
    const int c = j & 3;
    const int re = j >> 2;                  // r * LR_ROWS + e
    const int rr = re / LR_ROWS;
    const int e = re - rr * LR_ROWS;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
                              e < O ? s_xo + rr * (O * K) + e * K
                                    : s_xd + rr * (D * K) + (e - O) * K) +
                          4 * c;
    uint4 v;
    v.x = bf16x2::leaky(src[0]);
    v.y = bf16x2::leaky(src[1]);
    v.z = bf16x2::leaky(src[2]);
    v.w = c < 3 ? bf16x2::leaky(src[3]) : 0u;    // k 30, 31: padding
    reinterpret_cast<uint4*>(lr)[re * (LR_PAIRS / 4) + c] = v;
  }
  consumers_sync<true>();
  if (r >= rows) return;
  const uint4* a0 =
      reinterpret_cast<const uint4*>(lr) + (r * LR_ROWS + 2 * p) * 5;
  const uint4* a1 = a0 + 5;
  const uint4* ad =
      reinterpret_cast<const uint4*>(lr) + (r * LR_ROWS + O + d) * 5;
  float y[2][F] = {{0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
                   {0.0f, 0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint4 A = a0[c], B = a1[c], X = ad[c];
    const uint32_t av[4] = {A.x, A.y, A.z, A.w};
    const uint32_t bv[4] = {B.x, B.y, B.z, B.w};
    const uint32_t xv[4] = {X.x, X.y, X.z, X.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 8 * c + 2 * q;
      if (k < K) {
        // LR(gp) of both cells at k and k + 1, each rounded once
        const uint32_t g0 = bf16x2::leaky(bf16x2::add(av[q], xv[q]));
        const uint32_t g1 = bf16x2::leaky(bf16x2::add(bv[q], xv[q]));
        MST_TERM(y[0], k, bf16x2::lo(g0));
        MST_TERM(y[1], k, bf16x2::lo(g1));
        MST_TERM(y[0], k + 1, bf16x2::hi(g0));
        MST_TERM(y[1], k + 1, bf16x2::hi(g1));
      }
    }
  }
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(s_rest) + r * OUT;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      out[((2 * p + c) * D + d) * F + f] = __float2bfloat16_rn(
          sigmoid_scaled(y[c][f] + rest[c][f], scale.v[f]));
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
__global__ void __launch_bounds__(Shape<BF16>::THREADS,
                                  Shape<BF16>::MIN_BLOCKS)
grid_tail_kernel(const Elem<BF16>* __restrict__ xo,
                 const Elem<BF16>* __restrict__ xd,
                 const float* __restrict__ rest, Elem<BF16>* __restrict__ out,
                 int64_t n, int64_t rest_rep, int64_t rest_inner,
                 Scale scale) {
  using L = Layout<BF16>;
  using E = Elem<BF16>;
  constexpr int CONSUMERS = Shape<BF16>::CONSUMERS;
  constexpr int THREADS = Shape<BF16>::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * L::STAGE_BYTES +
                                               L::LR_BYTES);
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

  // ---- consumers: thread (r, o, d) (fp32) or (r, octave pair, d) ----
  constexpr int PER_ROW = CONSUMERS / ROWS;
  const int r = tid / PER_ROW;
  const int mm = tid % PER_ROW;
  const int o = mm / D;       // the octave (fp32) or octave pair (bf16)
  const int d = mm % D;
  uint32_t* lr = reinterpret_cast<uint32_t*>(smem + STAGES * L::STAGE_BYTES);
  int i = 0;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
    const int s = i % STAGES;
    unsigned char* st = smem + s * L::STAGE_BYTES;
    E* s_xo = reinterpret_cast<E*>(st);
    E* s_xd = reinterpret_cast<E*>(st + L::XO_BYTES);
    float* s_rest =
        reinterpret_cast<float*>(st + L::XO_BYTES + L::XD_BYTES);
    const int64_t r0 = t * ROWS;
    const int rows = static_cast<int>(n - r0 < ROWS ? n - r0 : ROWS);
    mbar_wait(&full[s], (i / STAGES) & 1);
    if (MODE != COPY_ONLY) {
      if constexpr (BF16) {
        compute_tile_bf16(s_xo, s_xd, s_rest, lr, rows, tid, r, o, d, scale);
      } else {
        compute_tile(s_xo, s_xd, s_rest, rows, tid, r, mm, o, d, scale);
      }
    }
    fence_async_smem();
    consumers_sync<BF16>();

    if (tid == 0) {
      if (MODE != COMPUTE_ONLY) {
        // the outputs overwrote rest (in copy-only mode, rest itself)
        bulk_store(out + r0 * OUT, s_rest,
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
// of K2's launch in the fp32 form (bf16 0) or the bf16 form (bf16 1) on
// the current card. The first call for a form on a card sets its kernels'
// shared-memory limit there: the attribute belongs to that card's context.
template <bool BF16>
int launch_info(int* info) {
  static int per_sm_of[MAX_DEVICES] = {};   // by card ordinal; 0: not set
  constexpr int smem = Layout<BF16>::SMEM_BYTES;
  constexpr int threads = Shape<BF16>::THREADS;
  int device = 0;
  cudaError_t err = current_device(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int& per_sm = per_sm_of[device];
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
      if (BF16 && err == cudaSuccess) {
        // three blocks of the bf16 form need the whole carve-out
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
      }
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, grid_tail_kernel<FULL, BF16>, threads, smem);
    }
  }
  info[0] = smem;
  info[1] = threads;
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
  kernel<<<static_cast<unsigned int>(blocks), info[1], info[0], st>>>(
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
