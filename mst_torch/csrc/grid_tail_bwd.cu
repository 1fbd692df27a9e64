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
// --fmad=false, so each multiply and add of ct_y, ct_G and the two sums
// rounds on its own, in the order of the plain torch version
// (grid_kernel.grid_tail_bwd_plain), and ct_y, ct_xo and ct_xd agree with
// it bit for bit. ct_w, a sum over every row in another order, uses
// explicit fused multiply-adds (__fmaf_rn).
//
// What bounds it on the H100: bytes. Per row it reads xo, xd, out and ct
// (240 + 210 + 280 + 280 floats) and writes ct_xo, ct_xd and ct_y (240 +
// 210 + 280): 6,960 B. At the 327,680-row budget shape (8 x 8 x 128 x 4 x
// 10) that is 2.28 GB, 0.68 ms at 3.35 TB/s. Each (row, o, d, k) of the
// grid takes ~24 issued instructions (two shared loads, the add of gp, the
// 9 rounded operations of ct_G, the sign select, the two sums, 5 FFMA of
// ct_w; 340 for the pass loop's 14 terms, tools/sass_opcodes.py --loops).
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py) the launch takes
// 0.61 ms computing alone, 0.80 ms moving its bytes alone (85% of the HBM
// rate) and 0.84 ms doing both: the arithmetic hides behind the copies.
//
// Design: a persistent grid (as many blocks as the card holds, at most one
// per tile) walks tiles of ROWS = 8 rows, tile blockIdx.x + i * gridDim.x
// at step i. In each block one producer warp keeps tiles in flight in a
// ring of STAGES stages: 1-D TMA bulk copies (cp.async.bulk with an
// mbarrier, tile_ring.cuh) of the tile's contiguous xo, xd, out and ct
// spans (32,320 B). One consumer warp owns each row of the tile:
//   1. ct_y first, in place: lane l forms the 5 ct_y of (o, d) = l and
//      l + 32 over the tile's ct slot (for the store) and into a padded
//      copy, 8 floats per (o, d), so the pass reads them with one 16-byte
//      and one 4-byte broadcast load.
//   2. One pass over the row's grid: lane k < 30 owns (row, k). It holds
//      LR(xd)[row, 0..6, k], w[k, 0..4], the 7 ct_xd sums and 5 ct_w sums
//      in registers and walks the 56 (o, d) in order, o outer and d inner,
//      forming each gp and ct_G once. The sums start at -0.0, which adds
//      like starting from the first term. ct_xo and ct_xd overwrite the
//      tile's xo and xd in place: a lane owns those addresses alone.
// The consumers fence (fence.proxy.async) and meet on a named barrier, and
// one thread stores ct_xo, ct_xd and ct_y back with bulk stores, as one
// bulk group. Halfway through the next tile's pass it waits until that
// group has read its stage (wait_group.read) and hands the stage back to
// the producer. A ragged last tile (fewer than 8 rows; a row of xd is
// 840 B, not a multiple of 16) moves by plain loads and stores. ct_w: each
// lane adds its tile partial (56 FFMA per feature, from -0.0) to a running
// sum per (row slot, k, f) over its block's tiles; at the end the 8 row
// slots are summed in ascending order into the block's (30, 5) partial.
// The TPU kernel's transposed rows-on-lanes layout is a TPU artefact; rows
// stay in their natural layout.
//
// The bf16 form (BF16 = true; the bf16 storage policy) reads xo, xd, out
// (the bf16 output K2's bf16 form saved) and ct as bf16, and writes ct_xo
// and ct_xd as bf16 and ct_y and the ct_w partials as fp32: JAX's dtypes
// under autodiff of its jnp tail on bf16 inputs. It rounds where that
// gradient's jaxpr rounds (grid_kernel.grid_tail_bwd_plain lists the
// points): gp and LR(gp) as in the forward; ct_G, an fp32 sum over f,
// rounds to bf16; dLR(gp) * ct_G and dLR(x) * sum are bf16 (the slope
// bf16(0.01)); the sums over d and over o accumulate in fp32 and round
// once. s comes from the saved bf16 output, so s * (1 - s) carries the
// output's rounding (JAX recomputes the fp32 output; the plain version's
// docstring says why and the CPU tests measure the cost). Per row it reads
// 480 + 420 + 560 + 560 B and writes 480 + 420 + 1,120 B: 4,040 B, 1.32 GB
// at 327,680 rows, a bound of 0.40 ms. Half the bytes of the fp32 form
// leave this form bound by issue, so its pass spends as few instructions
// on the bf16 roundings as the bits allow (bf16_pass): a lane takes two
// octaves a step, o and o + 1 in the halves of one bf16 pair, and every
// rounding is one packed instruction for both (bf16x2.cuh): gp is one
// add.rn.bf16x2 of LR(xo) for the two octaves and LR(xd[d]) in both
// halves; the two fp32 sums of ct_G round with one cvt.rn.bf16x2.f32;
// dLR(gp) is a pair of 1.0 or bf16(0.01) from one set.ge.u32.bf16x2 (so -0
// counts as >= 0) and a select, and dLR(gp) * ct_G and LR(gp) are one
// mul.rn.bf16x2 each. What remains of a term is its fp32 work: 9 operations
// of ct_G, the two sums and 5 FFMA of ct_w, with one unpack (a shift or a
// mask) per bf16 value: ~26 SASS instructions a term (scalar roundings
// took ~33). What bounds it now: still issue, not bytes. On an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py) it takes 0.74 ms at
// 327,680 rows, 0.69 ms computing alone and 0.46 ms moving its bytes
// alone. The 5 FFMA of ct_w are the part that need not stay on the FP32
// pipe (ct_w is held to a tolerance, not to bits). Its tile keeps ct_y in a
// slot of its own (8,960 B), so a stage is 25,120 B.

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
constexpr int K = 30;   // grid depth
constexpr int F = 5;    // output features
constexpr int M = O * D;
constexpr int OUT = M * F;              // 280 floats per row
constexpr int KF = K * F;
constexpr int ROWS = 8;                 // rows per tile
constexpr int CONSUMERS = ROWS * 32;    // one warp per row
constexpr int THREADS = CONSUMERS + 32; // + one producer warp
constexpr int STAGES = 3;
constexpr int CTY_PAD = 8;                   // floats per (o, d), padded
constexpr int CTY_BYTES = ROWS * M * CTY_PAD * 4;                 // 14,336
static_assert(ROWS * KF * 4 <= CTY_BYTES, "ct_w scratch reuses the cty copy");

// The element type of xo, xd, out, ct, ct_xo and ct_xd, by form.
template <bool BF16>
using Elem = typename std::conditional<BF16, __nv_bfloat16, float>::type;

// The tile's layout in one stage of the ring, by form: xo, xd, out, ct
// and, for bf16, ct_y (the fp32 form writes ct_y over ct).
template <bool BF16>
struct Layout {
  static constexpr int E = sizeof(Elem<BF16>);
  static constexpr int XO_BYTES = ROWS * O * K * E;    // 7,680 / 3,840
  static constexpr int XD_BYTES = ROWS * D * K * E;    // 6,720 / 3,360
  static constexpr int OUT_BYTES = ROWS * OUT * E;     // 8,960 / 4,480
  static constexpr int CTY_F32_BYTES = ROWS * OUT * 4; // 8,960
  static constexpr int LOAD_BYTES = XO_BYTES + XD_BYTES + 2 * OUT_BYTES;
  static constexpr int STAGE_BYTES =
      LOAD_BYTES + (BF16 ? CTY_F32_BYTES : 0);         // 32,320 / 25,120
  static constexpr int SMEM_BYTES =
      STAGES * STAGE_BYTES + CTY_BYTES + 2 * STAGES * 8;
  static_assert(STAGE_BYTES % 16 == 0, "stages start on 16 bytes");
};

struct Scale {
  float v[F];
};

// torch's leaky_relu: x > 0 ? x : x * 0.01
__device__ __forceinline__ float leaky(float x) {
  return x > 0.0f ? x : 0.01f * x;
}

// dLR(x) * c, without forming the derivative
__device__ __forceinline__ float dleaky_mul(float x, float c) {
  return x >= 0.0f ? c : 0.01f * c;
}

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void consumers_sync() {
  named_sync<CONSUMERS>();
}

template <bool BF16>
struct Stage {
  Elem<BF16>* xo;   // xo in, ct_xo out
  Elem<BF16>* xd;   // xd in, ct_xd out
  Elem<BF16>* out;
  Elem<BF16>* ct;   // ct in
  float* cty;       // ct_y out: over ct in the fp32 form
};

template <bool BF16>
__device__ __forceinline__ Stage<BF16> stage(unsigned char* smem, int s) {
  using L = Layout<BF16>;
  using E = Elem<BF16>;
  unsigned char* p = smem + s * L::STAGE_BYTES;
  unsigned char* ct = p + L::XO_BYTES + L::XD_BYTES + L::OUT_BYTES;
  return {reinterpret_cast<E*>(p), reinterpret_cast<E*>(p + L::XO_BYTES),
          reinterpret_cast<E*>(p + L::XO_BYTES + L::XD_BYTES),
          reinterpret_cast<E*>(ct),
          reinterpret_cast<float*>(BF16 ? ct + L::OUT_BYTES : ct)};
}

// The bf16 form's pass over row r of a tile for lane k < K: two octaves a
// step, o and o + 1 in the halves of one pair, packed arithmetic for every
// bf16 rounding (bf16x2.cuh). ct_G of both octaves is two fp32 sums over f
// in ascending order, rounded by one pack; dLR(gp) * ct_G and LR(gp) are
// each one mul by dLR(gp) as a pair (1.0 or bf16(0.01)). acc_o of the two
// octaves stay apart and acc_d[d] adds o, then o + 1, so every sum keeps
// the plain version's ascending order. ct_xo and ct_xd overwrite xo and xd
// in place; the ct_w terms of the row go into `run`. `release` runs once,
// after the first half of the octaves.
template <typename Release>
__device__ __forceinline__ void bf16_pass(__nv_bfloat16* s_xo,
                                          __nv_bfloat16* s_xd,
                                          const float* cy, int r, int k,
                                          const float (&wk)[F],
                                          float (&run)[F], Release release) {
  unsigned short* px =
      reinterpret_cast<unsigned short*>(s_xo) + r * (O * K) + k;
  unsigned short* pd =
      reinterpret_cast<unsigned short*>(s_xd) + r * (D * K) + k;
  uint32_t xd_[D], ad[D];
  float acc_d[D], part[F];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    xd_[d] = pd[d * K];
    ad[d] = bf16x2::leaky(xd_[d] | (xd_[d] << 16));   // LR(xd) in both
    acc_d[d] = -0.0f;
  }
#pragma unroll
  for (int f = 0; f < F; ++f) part[f] = -0.0f;
#pragma unroll 1
  for (int op = 0; op < O / 2; ++op) {
    const int o = 2 * op;
    const uint32_t x = px[o * K] | (static_cast<uint32_t>(px[(o + 1) * K])
                                    << 16);
    const uint32_t ao = bf16x2::leaky(x);
    float acc0 = -0.0f, acc1 = -0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float* ca = cy + (o * D + d) * CTY_PAD;
      const float* cb = ca + D * CTY_PAD;              // (o + 1, d)
      const float4 a4 = *reinterpret_cast<const float4*>(ca);
      const float a5 = ca[4];
      const float4 b4 = *reinterpret_cast<const float4*>(cb);
      const float b5 = cb[4];
      const uint32_t gp = bf16x2::add(ao, ad[d]);
      float ga = a4.x * wk[0];
      ga = ga + a4.y * wk[1];
      ga = ga + a4.z * wk[2];
      ga = ga + a4.w * wk[3];
      ga = ga + a5 * wk[4];
      float gb = b4.x * wk[0];
      gb = gb + b4.y * wk[1];
      gb = gb + b4.z * wk[2];
      gb = gb + b4.w * wk[3];
      gb = gb + b5 * wk[4];
      const uint32_t dl = bf16x2::dleaky(gp);
      const uint32_t cg = bf16x2::mul(bf16x2::pack(ga, gb), dl);
      const uint32_t lr = bf16x2::mul(gp, dl);
      const float cga = bf16x2::lo(cg), cgb = bf16x2::hi(cg);
      acc0 = acc0 + cga;
      acc1 = acc1 + cgb;
      acc_d[d] = acc_d[d] + cga;
      acc_d[d] = acc_d[d] + cgb;
      const float la = bf16x2::lo(lr), lb = bf16x2::hi(lr);
      part[0] = __fmaf_rn(la, a4.x, part[0]);
      part[1] = __fmaf_rn(la, a4.y, part[1]);
      part[2] = __fmaf_rn(la, a4.z, part[2]);
      part[3] = __fmaf_rn(la, a4.w, part[3]);
      part[4] = __fmaf_rn(la, a5, part[4]);
      part[0] = __fmaf_rn(lb, b4.x, part[0]);
      part[1] = __fmaf_rn(lb, b4.y, part[1]);
      part[2] = __fmaf_rn(lb, b4.z, part[2]);
      part[3] = __fmaf_rn(lb, b4.w, part[3]);
      part[4] = __fmaf_rn(lb, b5, part[4]);
    }
    const uint32_t g = bf16x2::mul(bf16x2::pack(acc0, acc1),
                                   bf16x2::dleaky(x));
    px[o * K] = static_cast<unsigned short>(g);
    px[(o + 1) * K] = static_cast<unsigned short>(g >> 16);
    if (op == O / 4 - 1) release();
  }
#pragma unroll
  for (int d = 0; d < D; d += 2) {
    const int d1 = d + 1 < D ? d + 1 : d;
    const uint32_t g = bf16x2::mul(bf16x2::pack(acc_d[d], acc_d[d1]),
                                   bf16x2::dleaky(xd_[d] | (xd_[d1] << 16)));
    pd[d * K] = static_cast<unsigned short>(g);
    if (d1 != d) pd[d1 * K] = static_cast<unsigned short>(g >> 16);
  }
#pragma unroll
  for (int f = 0; f < F; ++f) run[f] = run[f] + part[f];
}

// What a launch does. FULL is K3. The other two exist to measure it
// (chip_smoke.py times them): COPY_ONLY moves the same bytes through the
// ring (the tile's xo, xd and ct spans go back out as ct_xo, ct_xd and
// ct_y) and computes nothing; COMPUTE_ONLY runs the consumers on a zeroed
// ring and neither reads nor writes the row tensors.
enum Mode { FULL = 0, COPY_ONLY = 1, COMPUTE_ONLY = 2 };

template <int MODE, bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
grid_tail_bwd_kernel(const Elem<BF16>* __restrict__ xo,
                     const Elem<BF16>* __restrict__ xd,
                     const Elem<BF16>* __restrict__ out,
                     const Elem<BF16>* __restrict__ ct,
                     const float* __restrict__ w, Scale scale,
                     Elem<BF16>* __restrict__ ct_xo,
                     Elem<BF16>* __restrict__ ct_xd,
                     float* __restrict__ ct_y, float* __restrict__ ct_w_parts,
                     int64_t n) {
  using L = Layout<BF16>;
  using E = Elem<BF16>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_cty = reinterpret_cast<float*>(smem + STAGES * L::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * L::STAGE_BYTES +
                                               CTY_BYTES);
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
      const Stage<BF16> st = stage<BF16>(smem, s);
      const int64_t r0 = t * ROWS;
      const int rows = static_cast<int>(n - r0 < ROWS ? n - r0 : ROWS);
      if (MODE == COMPUTE_ONLY) {
        if (lane == 0) mbar_arrive(&full[s]);
      } else if (rows == ROWS) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], L::LOAD_BYTES);
          bulk_load(st.xo, xo + r0 * (O * K), L::XO_BYTES, &full[s]);
          bulk_load(st.xd, xd + r0 * (D * K), L::XD_BYTES, &full[s]);
          bulk_load(st.out, out + r0 * OUT, L::OUT_BYTES, &full[s]);
          bulk_load(st.ct, ct + r0 * OUT, L::OUT_BYTES, &full[s]);
        }
      } else {
        // the ragged last tile: plain loads by the whole warp
        for (int j = lane; j < rows * O * K; j += 32) {
          st.xo[j] = xo[r0 * (O * K) + j];
        }
        for (int j = lane; j < rows * D * K; j += 32) {
          st.xd[j] = xd[r0 * (D * K) + j];
        }
        for (int j = lane; j < rows * OUT; j += 32) {
          st.out[j] = out[r0 * OUT + j];
          st.ct[j] = ct[r0 * OUT + j];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumers: warp r owns row r of each tile, lane k < K owns k ----
  const int r = tid / 32;
  const int lane = tid % 32;
  float wk[F], sc[F], inv[F], run[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    wk[f] = lane < K ? w[lane * F + f] : 0.0f;
    sc[f] = scale.v[f];
    inv[f] = 1.0f / sc[f];
    run[f] = 0.0f;
  }
  int i = 0;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
    const int s = i % STAGES;
    const Stage<BF16> st = stage<BF16>(smem, s);
    const int64_t r0 = t * ROWS;
    const int rows = static_cast<int>(n - r0 < ROWS ? n - r0 : ROWS);
    // hand the previous tile's stage back once its bulk store has read it
    auto release_previous = [&]() {
      if (i > 0) {
        bulk_wait_read<0>();
        mbar_arrive(&empty[(i - 1) % STAGES]);
      }
    };
    mbar_wait(&full[s], (i / STAGES) & 1);
    if (MODE == COPY_ONLY) {
      if (tid == 0) release_previous();
    } else if (r < rows) {
      // 1. ct_y into its slot (over ct in the fp32 form), and its padded
      // copy
      const E* so = st.out + r * OUT;
      const E* sct = st.ct + r * OUT;
      float* sy = st.cty + r * OUT;
      float* cy = s_cty + r * (M * CTY_PAD);
      for (int m = lane; m < M; m += 32) {
        float v[F];
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float s_ = ld(so[m * F + f]) * inv[f];
          v[f] = ld(sct[m * F + f]) * (sc[f] * s_ * (1.0f - s_));
          sy[m * F + f] = v[f];
        }
        *reinterpret_cast<float4*>(cy + m * CTY_PAD) =
            make_float4(v[0], v[1], v[2], v[3]);
        cy[m * CTY_PAD + 4] = v[4];
      }
      __syncwarp();
      // 2. the pass over the row's (o, d) for this lane's k
      if constexpr (BF16) {
        if (lane < K) {
          bf16_pass(st.xo, st.xd, cy, r, lane, wk, run,
                    [&]() { if (tid == 0) release_previous(); });
        }
      } else if (lane < K) {
        float* px = st.xo + r * (O * K) + lane;
        float* pd = st.xd + r * (D * K) + lane;
        float ad[D], acc_d[D], part[F];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          ad[d] = leaky(pd[d * K]);
          acc_d[d] = -0.0f;
        }
#pragma unroll
        for (int f = 0; f < F; ++f) part[f] = -0.0f;
#pragma unroll 2
        for (int o = 0; o < O; ++o) {
          const float x = px[o * K];
          const float ao = leaky(x);
          float acc_o = -0.0f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float* c = cy + (o * D + d) * CTY_PAD;
            const float4 c4 = *reinterpret_cast<const float4*>(c);
            const float c5 = c[4];
            const float gp = ao + ad[d];
            float g = c4.x * wk[0];
            g = g + c4.y * wk[1];
            g = g + c4.z * wk[2];
            g = g + c4.w * wk[3];
            g = g + c5 * wk[4];
            const bool pos = gp >= 0.0f;
            // dLR(gp) * ct_G and LR(gp)
            const float cg = pos ? g : 0.01f * g;
            const float lr = pos ? gp : 0.01f * gp;
            acc_o = acc_o + cg;
            acc_d[d] = acc_d[d] + cg;
            part[0] = __fmaf_rn(lr, c4.x, part[0]);
            part[1] = __fmaf_rn(lr, c4.y, part[1]);
            part[2] = __fmaf_rn(lr, c4.z, part[2]);
            part[3] = __fmaf_rn(lr, c4.w, part[3]);
            part[4] = __fmaf_rn(lr, c5, part[4]);
          }
          px[o * K] = dleaky_mul(x, acc_o);
          if (o == O / 2 - 1 && tid == 0) release_previous();
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
          pd[d * K] = dleaky_mul(pd[d * K], acc_d[d]);
        }
#pragma unroll
        for (int f = 0; f < F; ++f) run[f] = run[f] + part[f];
      }
    }
    fence_async_smem();
    consumers_sync();

    if (MODE == COMPUTE_ONLY) continue;
    if (rows == ROWS) {
      if (tid == 0) {
        bulk_store(ct_xo + r0 * (O * K), st.xo, L::XO_BYTES);
        bulk_store(ct_xd + r0 * (D * K), st.xd, L::XD_BYTES);
        bulk_store(ct_y + r0 * OUT, st.cty, L::CTY_F32_BYTES);
        bulk_commit();
      }
    } else {
      // the ragged last tile: plain stores by all consumers
      for (int j = tid; j < rows * O * K; j += CONSUMERS) {
        ct_xo[r0 * (O * K) + j] = st.xo[j];
      }
      for (int j = tid; j < rows * D * K; j += CONSUMERS) {
        ct_xd[r0 * (D * K) + j] = st.xd[j];
      }
      for (int j = tid; j < rows * OUT; j += CONSUMERS) {
        ct_y[r0 * OUT + j] = st.cty[j];
      }
    }
  }

// the block's ct_w partial: the row slots' running sums in ascending
  // order, through the cty copy (every pass is over)
  if (lane < K) {
#pragma unroll
    for (int f = 0; f < F; ++f) s_cty[(r * K + lane) * F + f] = run[f];
  }
  consumers_sync();
  if (tid < KF) {
    float acc = s_cty[tid];
    for (int rr = 1; rr < ROWS; ++rr) acc = acc + s_cty[rr * KF + tid];
    ct_w_parts[static_cast<int64_t>(blockIdx.x) * KF + tid] = acc;
  }
  if (tid == 0) bulk_wait_all();
}


// (dynamic shared memory bytes, threads per block, resident blocks per SM,
// rows per tile) of K3's launch in one form on the current card. The first
// call for a form on a card sets its kernels' shared-memory limit there.
template <bool BF16>
int launch_info(int* info) {
  static int per_sm_of[MAX_DEVICES] = {};   // by card ordinal; 0: not set
  constexpr int smem = Layout<BF16>::SMEM_BYTES;
  int device = 0;
  cudaError_t err = current_device(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int& per_sm = per_sm_of[device];
  if (per_sm == 0) {
    const void* kernels[] = {
        reinterpret_cast<const void*>(grid_tail_bwd_kernel<FULL, BF16>),
        reinterpret_cast<const void*>(grid_tail_bwd_kernel<COPY_ONLY, BF16>),
        reinterpret_cast<const void*>(
            grid_tail_bwd_kernel<COMPUTE_ONLY, BF16>)};
    for (const void* kernel : kernels) {
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      }
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, grid_tail_bwd_kernel<FULL, BF16>, THREADS, smem);
    }
  }
  info[0] = smem;
  info[1] = THREADS;
  info[2] = per_sm;
  info[3] = ROWS;
  return static_cast<int>(err);
}

template <bool BF16>
int launch(int mode, const void* xo, const void* xd, const void* out,
           const void* ct, const void* w, Scale scale, void* ct_xo,
           void* ct_xd, void* ct_y, void* ct_w_parts, int64_t n,
           int64_t blocks, void* stream) {
  if (n <= 0) return 0;
  int info[4];
  const cudaError_t err = static_cast<cudaError_t>(launch_info<BF16>(info));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info[2] < 1 || blocks < 1 || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  auto kernel = mode == COPY_ONLY ? grid_tail_bwd_kernel<COPY_ONLY, BF16>
                : mode == COMPUTE_ONLY
                    ? grid_tail_bwd_kernel<COMPUTE_ONLY, BF16>
                    : grid_tail_bwd_kernel<FULL, BF16>;
  using E = Elem<BF16>;
  kernel<<<static_cast<unsigned int>(blocks), THREADS, info[0],
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(xo), static_cast<const E*>(xd),
      static_cast<const E*>(out), static_cast<const E*>(ct),
      static_cast<const float*>(w), scale, static_cast<E*>(ct_xo),
      static_cast<E*>(ct_xd), static_cast<float*>(ct_y),
      static_cast<float*>(ct_w_parts), n);
  return static_cast<int>(cudaGetLastError());
}

int launch_form(int bf16, int mode, const void* xo, const void* xd,
                const void* out, const void* ct, const void* w, Scale scale,
                void* ct_xo, void* ct_xd, void* ct_y, void* ct_w_parts,
                int64_t n, int64_t blocks, void* stream) {
  return bf16 ? launch<true>(mode, xo, xd, out, ct, w, scale, ct_xo, ct_xd,
                             ct_y, ct_w_parts, n, blocks, stream)
              : launch<false>(mode, xo, xd, out, ct, w, scale, ct_xo, ct_xd,
                              ct_y, ct_w_parts, n, blocks, stream);
}

}  // namespace

// The launch info of the fp32 form (bf16 0) or the bf16 form (bf16 1) on
// the current card. The wrapper sizes the ct_w partials by the grid it passes: min(blocks
// per SM x SMs, tiles).
extern "C" int mst_grid_tail_bwd_info(int bf16, int* info) {
  return bf16 ? launch_info<true>(info) : launch_info<false>(info);
}

// Launches K3 on `stream` with `blocks` blocks: xo (n, 8, 30), xd (n, 7,
// 30), out and ct (n, 56, 5), w (30, 5), the five scales by value; writes
// ct_xo (n, 8, 30), ct_xd (n, 7, 30), ct_y (n, 56, 5) and ct_w_parts
// (blocks, 30, 5). xo, xd, out, ct, ct_xo and ct_xd are fp32, or bf16 when
// `bf16` is not 0; w, ct_y and ct_w_parts are fp32. All contiguous and
// 16-byte aligned. Returns the first CUDA error, or 0.
extern "C" int mst_grid_tail_bwd(const void* xo, const void* xd,
                                 const void* out, const void* ct,
                                 const void* w, float s0, float s1, float s2,
                                 float s3, float s4, void* ct_xo, void* ct_xd,
                                 void* ct_y, void* ct_w_parts, int64_t n,
                                 int64_t blocks, int bf16, void* stream) {
  return launch_form(bf16, FULL, xo, xd, out, ct, w,
                     Scale{{s0, s1, s2, s3, s4}}, ct_xo, ct_xd, ct_y,
                     ct_w_parts, n, blocks, stream);
}

// The same launch in one of the measuring modes (1: copy only, 2: compute
// only), with unit scales; the outputs then hold no result.
extern "C" int mst_grid_tail_bwd_variant(int mode, int bf16, const void* xo,
                                         const void* xd, const void* out,
                                         const void* ct, const void* w,
                                         void* ct_xo, void* ct_xd, void* ct_y,
                                         void* ct_w_parts, int64_t n,
                                         int64_t blocks, void* stream) {
  return launch_form(bf16, mode, xo, xd, out, ct, w,
                     Scale{{1.0f, 1.0f, 1.0f, 1.0f, 1.0f}}, ct_xo, ct_xd,
                     ct_y, ct_w_parts, n, blocks, stream);
}
