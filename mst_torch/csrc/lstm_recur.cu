// K4: the LSTM recurrence, every step of it in one launch, for Hopper
// (sm_90a), and its backward over the gates the forward saved.
//
// Replaces no TPU kernel: the JAX package runs the recurrence as a
// lax.scan (mst_tpu/ops/lstm.py), which XLA compiles into one loop on the
// device. The port ran it as a Python loop, one bmm and about ten
// elementwise kernels a step (mst_torch.ops.lstm_kernel.recur_plain), so a
// 128-bar recurrence cost about 1,400 launches. K4 computes what that loop
// computes, for K independent directions over N rows and T steps:
//
//   gates = gates_x[k, n, t] + h @ w_hh_t[k]        (i, f, g, o), 4H wide
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h = sigmoid(o) * tanh(c)                         -> out[k, n, t]
//
// from zero carries, and writes every step's h. The input half of the
// gates (x @ W_ih^T + b for every step at once) is one large product that
// stays with torch.matmul.
//
// What bounds it on the H100. On the bar axis (N = 6-12 rows, T = 128 and
// up to 1,024 steps) each step depends on the last and does a few hundred
// thousand multiply-adds: the bound is the latency of one step, the chain
// of a depth-H dot product, the gate functions and one barrier. On the
// beat axis (N up to about 200k rows, T = 4) the steps are few and the
// rows many: the bound is the larger of the bytes of gates_x and of the
// outputs (20 H bytes a row and step) over 3.35 TB/s and the 8 H^2
// operations a row and step over 67 TFLOP/s in fp32, which at H = 64 is
// the operations.
//
// Design. A block owns a tile of rows of one direction and a slice of the
// hidden units, and walks all T steps; h and c never leave the chip. W_hh
// for its units (all four gates, every depth) stays in shared memory for
// the whole recurrence, as one 16-byte word (fp32) or 8-byte word (bf16) a
// (depth, unit), so a thread reads its unit's four gate weights at one
// depth with one load and no bank conflict. Where W_hh does not fit one
// block (H = 192: 576 KB in fp32), a thread-block cluster of 2-8 blocks
// splits the units, each block holding its units' four gates, so the cell
// update needs no exchange: each step every block writes its slice of the
// new h into the shared memory of every block of the cluster (distributed
// shared memory), and one cluster barrier follows. h is double-buffered,
// so one barrier a step suffices. S neighbouring lanes (S = 1, 2, 4 or 8)
// share one unit's dot products, each summing H / S depths, and add their
// parts with S - 1 shuffles; the chain a step waits on is then H / S
// multiply-adds long. Each lane owns R rows (R = 1, 2, 4 or 8, a template
// parameter): R rows of h are read with 16-byte broadcast loads and each
// weight read serves R rows. The lanes load their gates_x for step t + 1
// into registers before they compute step t, so that latency hides behind
// the dot product. The wrapper (mst_torch.ops.lstm_kernel.plan) picks the
// cluster size from H and the compute dtype, the row tile from N, K and
// the card's SMs (as many blocks as spread the rows over the SMs, then up
// to 8 rows a lane), and S from the threads a block has left.
//
// Numerics. The dot product runs in fp32 with fused multiply-adds in
// ascending depth (cuBLAS sums in another order: the fp32-reassociation
// rule holds between the two). The library is built with --fmad=false, so
// gates_x + product, the cell and h round each multiply and add apart,
// as the loop's separate kernels do, and the gate functions are torch's:
// 1 / (1 + expf(-x)) and tanhf, IEEE-accurate (no fast math). Under the
// bf16 compute policy (BF16 = true) W_hh and each step's h are rounded to
// bf16 before the product and the products accumulate in fp32, which is
// what precision.matmul does with torch.bmm(out_dtype=float32); the
// carries, gates_x and the outputs stay fp32 either way.
//
// Training. The training form of the forward (TRAIN = true) also writes,
// for every step, the four gate activations (i, f, g, o after their
// functions) and c; its outputs are the same bits as the form without it,
// which only leaves out those stores. The backward, lstm_recur_bwd_kernel,
// walks the steps in reverse over the same cluster layout. From the saved
// activations, the outputs' cotangent dout and the carried dh and dc it
// computes each step's gate cotangents:
//
//   dh = dout[t] + dh_carried      dc = dc_carried + dh o (1 - tanh(c)^2)
//   di = dc g i (1 - i)   df = dc c[t-1] f (1 - f)
//   dg = dc i (1 - g^2)   do = dh tanh(c) o (1 - o)
//   dc_carried = dc f     dh_carried = dgates w_hh_t^T  (for step t - 1)
//
// in the order of the factors that torch's autograd of the loop uses
// (sigmoid_backward: grad (1 - y) y; tanh_backward: grad (1 - y^2)). It
// writes dgates (K, N, T, 4H), the cotangent of gates_x, and nothing
// else: the wrapper takes the gradient of w_hh_t, sum_t h[t-1]^T
// dgates[t], as one batched product after the kernel. w_hh_t's rows of a
// block's units are held in shared memory, one word a (unit k of the
// product, own unit j): w_hh_t[j][q H + k] for the four gates q, so that
// a thread sums its unit's dh over the 4H gate cotangents with one word
// load a depth. Each
// step every block sends its units' four cotangents of every row (one
// 16-byte word a unit) to every block of the cluster through distributed
// shared memory, double-buffered, and one cluster barrier follows; the
// exchange carries 4H floats a row where the forward's carries H. The
// lanes load the saved values of step t - 1 before they compute step t.
// The product is summed in fp32 as the forward's is; under bf16 compute
// W_hh is rounded to bf16, the cotangents stay fp32 and dh_carried is
// rounded to bf16, as precision.matmul's backward rounds the cotangent of
// its bf16 operand h.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_ring.cuh"

namespace cg = cooperative_groups;

namespace {

using tile_ring::current_device;
using tile_ring::MAX_DEVICES;

constexpr int MAX_FEATURES = 256;   // H
constexpr int MAX_THREADS = 256;    // splits x units x row groups
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int MAX_SPLIT = 8;        // lanes that share one dot product

// The four gate weights of one (depth, unit): fp32, or bf16 packed as
// (i | f << 16, g | o << 16).
template <bool BF16>
using WWord = typename std::conditional<BF16, uint2, float4>::type;

struct Params {
  const float* gx;     // (K, N, T, 4H)
  const float* w;      // w_hh_t (K, H, 4H), strides w_stride
  float* out;          // (K, N, T, H)
  float* acts;         // TRAIN: (K, N, T, 4H), i, f, g, o after their
                       // functions
  float* cs;           // TRAIN: (K, N, T, H), c
  int64_t w_stride[3];
  int n, t, h;
  int units;           // hidden units of a block
  int groups;          // row groups of a block (rows = R x groups)
  int split;           // lanes a dot product is split over (1, 2, 4, 8)
  int ks;              // depths of one split, a multiple of 4
  int kp;              // split x ks >= H: the padded depth
  int seg;             // ks + 4: floats of one split's segment of h
  int hp;              // split x seg: floats of one row of h
};

struct BwdParams {
  const float* dout;   // (K, N, T, H), the outputs' cotangent
  const float* acts;   // (K, N, T, 4H), saved by the training forward
  const float* cs;     // (K, N, T, H), saved by the training forward
  const float* w;      // w_hh_t (K, H, 4H), strides w_stride
  float* dgates;       // (K, N, T, 4H)
  int64_t w_stride[3];
  int n, t, h;
  int units, groups, split, ks, kp;   // as Params'
  int seg;             // 4 ks + 4: floats of one split's segment of dgates
  int hp;              // split x seg: floats of one row of dgates
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

template <bool BF16>
__host__ __device__ constexpr size_t smem_bytes(int kp, int hp, int units,
                                                int rows) {
  return static_cast<size_t>(kp) * units * sizeof(WWord<BF16>) +
         2 * static_cast<size_t>(rows) * hp * sizeof(float);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

// The gate weights (i, f, g, o) of one word.
__device__ __forceinline__ void unpack(const float4& w, float* out) {
  out[0] = w.x;
  out[1] = w.y;
  out[2] = w.z;
  out[3] = w.w;
}

__device__ __forceinline__ void unpack(const uint2& w, float* out) {
  out[0] = __uint_as_float(w.x << 16);
  out[1] = __uint_as_float(w.x & 0xffff0000u);
  out[2] = __uint_as_float(w.y << 16);
  out[3] = __uint_as_float(w.y & 0xffff0000u);
}

__device__ __forceinline__ float4 pack(const float* g, float4*) {
  return make_float4(g[0], g[1], g[2], g[3]);
}

__device__ __forceinline__ uint2 pack(const float* g, uint2*) {
  return make_uint2(bf16_pair(g[0], g[1]), bf16_pair(g[2], g[3]));
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Where depth k of h lies in a row of the h buffer: split k / ks, padded
// to seg floats, so the splits' 16-byte loads fall in other banks.
__device__ __forceinline__ int h_pos(int k, int ks, int seg) {
  return k / ks * seg + k % ks;
}

// Grid: (cluster x row tiles, K); a cluster of `cluster` blocks along x
// shares one row tile of one direction, block rank r owning units
// [r * units, (r + 1) * units). Block: split x units x groups threads;
// thread (s, u, g) sums depths [s ks, (s + 1) ks) of unit u's dot
// products for rows g * R .. g * R + R - 1 of the tile. The split lanes of
// one (u, g) are neighbours in a warp and sum their parts with shuffles.
template <int R, bool BF16, bool TRAIN>
__global__ void __launch_bounds__(MAX_THREADS)
    lstm_recur_kernel(Params p) {
  using Word = WWord<BF16>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / n_blocks;
  const int dir = blockIdx.y;
  const int units = p.units;
  const int split = p.split;
  const int tid = threadIdx.x;
  const int s = tid % split;
  const int u = tid / split % units;
  const int g = tid / (split * units);
  const int unit = rank * units + u;
  const bool unit_ok = unit < p.h;
  const int rows = R * p.groups;
  const int four_h = 4 * p.h;

  // [ks][units][split]: lane s of unit u reads word (kk, u, s), depth
  // s ks + kk, so a warp's loads are consecutive words
  Word* ws = reinterpret_cast<Word*>(smem);
  float* hs = reinterpret_cast<float*>(
      smem + static_cast<size_t>(p.kp) * units * sizeof(Word));  // [2][rows][hp]

  // W_hh of this block's units into shared memory, zero past depth H and
  // past the last unit; both h buffers to zero (the initial carry, and
  // the padding that the dot product reads as 0)
  const float* w = p.w + dir * p.w_stride[0];
  for (int i = tid; i < p.kp * units; i += blockDim.x) {
    const int k = i % split * p.ks + i / (split * units);
    const int jj = rank * units + i / split % units;
    float gate[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (k < p.h && jj < p.h) {
      for (int q = 0; q < 4; ++q) {
        gate[q] = w[k * p.w_stride[1] + (q * p.h + jj) * p.w_stride[2]];
      }
    }
    ws[i] = pack(gate, static_cast<Word*>(nullptr));
  }
  for (int i = tid; i < 2 * rows * p.hp; i += blockDim.x) hs[i] = 0.0f;

  int64_t row_of[R];
  bool row_ok[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t n = static_cast<int64_t>(tile) * rows + g * R + r;
    row_ok[r] = unit_ok && n < p.n;
    row_of[r] = (static_cast<int64_t>(dir) * p.n + (row_ok[r] ? n : 0)) *
                p.t;   // (direction, row) -> its first step
  }

  // gates_x of step t, for this thread's unit and rows
  auto load_gx = [&](int t, float (&dst)[R][4]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* src = p.gx + (row_of[r] + t) * four_h + unit;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dst[r][q] = row_ok[r] ? __ldg(src + q * p.h) : 0.0f;
      }
    }
  };

  // the lanes of this warp (the last warp of a block may be partial; a
  // split never straddles two warps)
  const int warp_lanes = min(32, static_cast<int>(blockDim.x) - (tid & ~31));
  const unsigned lanes =
      warp_lanes == 32 ? 0xffffffffu : (1u << warp_lanes) - 1;

  float c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) c[r] = 0.0f;
  float next[R][4];
  load_gx(0, next);
  // every block of the cluster has started and zeroed its buffers before
  // any block writes into them
  cluster.sync();

  for (int t = 0; t < p.t; ++t) {
    float gx[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      for (int q = 0; q < 4; ++q) gx[r][q] = next[r][q];
    }
    if (t + 1 < p.t) load_gx(t + 1, next);

    const float* h_now =
        hs + (t & 1) * rows * p.hp + g * R * p.hp + s * p.seg;
    const Word* w_mine = ws + u * split + s;
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
    }
    for (int k = 0; k < p.ks; k += 4) {
      float4 hv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        hv[r] = *reinterpret_cast<const float4*>(h_now + r * p.hp + k);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float wq[4];
        unpack(w_mine[(k + kk) * units * split], wq);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hk = component(hv[r], kk);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[r][q] = __fmaf_rn(hk, wq[q], acc[r][q]);
          }
        }
      }
    }
    // the split lanes' parts, summed pairwise: every lane of the split
    // ends with the same bits (a + b == b + a)
    for (int off = 1; off < split; off <<= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][q] += __shfl_xor_sync(lanes, acc[r][q], off);
        }
      }
    }

    const bool last = t + 1 == p.t;
    float* h_next = hs + ((t + 1) & 1) * rows * p.hp + g * R * p.hp +
                    h_pos(unit, p.ks, p.seg);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float si = sigmoid(gx[r][0] + acc[r][0]);
      const float sf = sigmoid(gx[r][1] + acc[r][1]);
      const float tg = tanhf(gx[r][2] + acc[r][2]);
      const float so = sigmoid(gx[r][3] + acc[r][3]);
      c[r] = sf * c[r] + si * tg;
      const float h = so * tanhf(c[r]);
      // every lane of the split holds h; the first writes it
      if (s != 0) continue;
      if (row_ok[r]) {
        p.out[(row_of[r] + t) * p.h + unit] = h;
        if (TRAIN) {
          float* a = p.acts + (row_of[r] + t) * four_h + unit;
          a[0] = si;
          a[p.h] = sf;
          a[2 * p.h] = tg;
          a[3 * p.h] = so;
          p.cs[(row_of[r] + t) * p.h + unit] = c[r];
        }
      }
      if (unit_ok && !last) {
        const float hb = BF16 ? bf16_round(h) : h;
        float* dst = h_next + r * p.hp;
        if (n_blocks == 1) {
          *dst = hb;
        } else {
          for (int b = 0; b < n_blocks; ++b) {
            *cluster.map_shared_rank(dst, b) = hb;
          }
        }
      }
    }
    // the new h is in every block's buffer before any block reads it; no
    // block writes again before every block has read this step's h (the
    // next write goes to the other buffer). After the last step nothing
    // is written to another block, so no barrier is needed before exit.
    if (!last) {
      if (n_blocks == 1) {
        __syncthreads();
      } else {
        cluster.sync();
      }
    }
  }
}

// Where unit k's word of gate cotangents lies in a row of the backward's
// exchange buffer: split k / ks, padded to seg floats.
__device__ __forceinline__ int g_pos(int k, int ks, int seg) {
  return k / ks * seg + k % ks * 4;
}

// The backward. Grid, cluster and block as the forward's: block rank r of
// a cluster owns units [r * units, (r + 1) * units); thread (s, u, g) sums
// the products of gate cotangents [s ks, (s + 1) ks) (each a word of four
// gates) with the row of w_hh_t of unit u, for rows g * R .. g * R + R - 1.
template <int R, bool BF16>
__global__ void __launch_bounds__(MAX_THREADS)
    lstm_recur_bwd_kernel(BwdParams p) {
  using Word = WWord<BF16>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / n_blocks;
  const int dir = blockIdx.y;
  const int units = p.units;
  const int split = p.split;
  const int tid = threadIdx.x;
  const int s = tid % split;
  const int u = tid / split % units;
  const int g = tid / (split * units);
  const int unit = rank * units + u;
  const bool unit_ok = unit < p.h;
  const int rows = R * p.groups;
  const int four_h = 4 * p.h;

  // [ks][units][split] words, as the forward's; [2][rows][hp] cotangents
  Word* ws = reinterpret_cast<Word*>(smem);
  float* gs = reinterpret_cast<float*>(
      smem + static_cast<size_t>(p.kp) * units * sizeof(Word));

  // word (kk, u, s): w_hh_t[j][q H + k] for q = 0..3, j this block's unit
  // u, k = s ks + kk; zero past H. Both buffers to zero: the padding that
  // the product reads as 0
  const float* w = p.w + dir * p.w_stride[0];
  for (int i = tid; i < p.kp * units; i += blockDim.x) {
    const int k = i % split * p.ks + i / (split * units);
    const int jj = rank * units + i / split % units;
    float gate[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (k < p.h && jj < p.h) {
      for (int q = 0; q < 4; ++q) {
        gate[q] = w[jj * p.w_stride[1] + (q * p.h + k) * p.w_stride[2]];
      }
    }
    ws[i] = pack(gate, static_cast<Word*>(nullptr));
  }
  for (int i = tid; i < 2 * rows * p.hp; i += blockDim.x) gs[i] = 0.0f;

  int64_t row_of[R];
  bool row_ok[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t n = static_cast<int64_t>(tile) * rows + g * R + r;
    row_ok[r] = unit_ok && n < p.n;
    row_of[r] = (static_cast<int64_t>(dir) * p.n + (row_ok[r] ? n : 0)) *
                p.t;
  }

  // the saved values step t reads: its activations, dout and c[t - 1]
  auto load = [&](int t, float (&act)[R][4], float (&dout)[R],
                  float (&c_prev)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t at = row_of[r] + t;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        act[r][q] =
            row_ok[r] ? __ldg(p.acts + at * four_h + q * p.h + unit) : 0.0f;
      }
      dout[r] = row_ok[r] ? __ldg(p.dout + at * p.h + unit) : 0.0f;
      c_prev[r] =
          row_ok[r] && t > 0 ? __ldg(p.cs + (at - 1) * p.h + unit) : 0.0f;
    }
  };

  const int warp_lanes = min(32, static_cast<int>(blockDim.x) - (tid & ~31));
  const unsigned lanes =
      warp_lanes == 32 ? 0xffffffffu : (1u << warp_lanes) - 1;

  float c[R], dc[R];
  float next_act[R][4], next_dout[R], next_c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    c[r] = row_ok[r] ? __ldg(p.cs + (row_of[r] + p.t - 1) * p.h + unit)
                     : 0.0f;
    dc[r] = 0.0f;
  }
  load(p.t - 1, next_act, next_dout, next_c);
  cluster.sync();

  for (int i = 0; i < p.t; ++i) {
    const int t = p.t - 1 - i;
    float act[R][4], dout[R], c_prev[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      for (int q = 0; q < 4; ++q) act[r][q] = next_act[r][q];
      dout[r] = next_dout[r];
      c_prev[r] = next_c[r];
    }
    if (t > 0) load(t - 1, next_act, next_dout, next_c);

    // dh carried from step t + 1: its gate cotangents times w_hh_t^T
    float carry[R];
#pragma unroll
    for (int r = 0; r < R; ++r) carry[r] = 0.0f;
    if (i > 0) {
      const float* g_now =
          gs + (i & 1) * rows * p.hp + g * R * p.hp + s * p.seg;
      const Word* w_mine = ws + u * split + s;
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
      }
      for (int k = 0; k < p.ks; ++k) {
        float wq[4];
        unpack(w_mine[k * units * split], wq);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 gv =
              *reinterpret_cast<const float4*>(g_now + r * p.hp + 4 * k);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[r][q] = __fmaf_rn(component(gv, q), wq[q], acc[r][q]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        carry[r] = (acc[r][0] + acc[r][1]) + (acc[r][2] + acc[r][3]);
      }
      // the split lanes' parts, summed pairwise: every lane of the split
      // ends with the same bits
      for (int off = 1; off < split; off <<= 1) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          carry[r] += __shfl_xor_sync(lanes, carry[r], off);
        }
      }
      if (BF16) {
#pragma unroll
        for (int r = 0; r < R; ++r) carry[r] = bf16_round(carry[r]);
      }
    }

    float* g_next = gs + ((i + 1) & 1) * rows * p.hp + g * R * p.hp +
                    g_pos(unit, p.ks, p.seg);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float si = act[r][0], sf = act[r][1], tg = act[r][2],
                  so = act[r][3];
      const float dh = dout[r] + carry[r];
      const float tc = tanhf(c[r]);
      const float d_o = dh * tc * (1.0f - so) * so;
      const float dcr = dc[r] + dh * so * (1.0f - tc * tc);
      const float d_i = dcr * tg * (1.0f - si) * si;
      const float d_f = dcr * c_prev[r] * (1.0f - sf) * sf;
      const float d_g = dcr * si * (1.0f - tg * tg);
      dc[r] = dcr * sf;
      c[r] = c_prev[r];
      // every lane of the split holds the cotangents; the first writes
      if (s != 0) continue;
      if (row_ok[r]) {
        float* dst = p.dgates + (row_of[r] + t) * four_h + unit;
        dst[0] = d_i;
        dst[p.h] = d_f;
        dst[2 * p.h] = d_g;
        dst[3 * p.h] = d_o;
      }
      if (unit_ok && t > 0) {
        const float4 v = make_float4(d_i, d_f, d_g, d_o);
        float4* dst = reinterpret_cast<float4*>(g_next + r * p.hp);
        if (n_blocks == 1) {
          *dst = v;
        } else {
          for (int b = 0; b < n_blocks; ++b) {
            *cluster.map_shared_rank(dst, b) = v;
          }
        }
      }
    }
    // as the forward's barrier: one a step, none after the last
    if (t > 0) {
      if (n_blocks == 1) {
        __syncthreads();
      } else {
        cluster.sync();
      }
    }
  }
}

// Every instance of the forward by (bf16, train, log2 R) and of the
// backward by (bf16, log2 R).
template <bool BF16, bool TRAIN>
void (*fwd_kernel(int r_log2))(Params) {
  switch (r_log2) {
    case 0: return lstm_recur_kernel<1, BF16, TRAIN>;
    case 1: return lstm_recur_kernel<2, BF16, TRAIN>;
    case 2: return lstm_recur_kernel<4, BF16, TRAIN>;
    default: return lstm_recur_kernel<8, BF16, TRAIN>;
  }
}

template <bool BF16>
void (*bwd_kernel(int r_log2))(BwdParams) {
  switch (r_log2) {
    case 0: return lstm_recur_bwd_kernel<1, BF16>;
    case 1: return lstm_recur_bwd_kernel<2, BF16>;
    case 2: return lstm_recur_bwd_kernel<4, BF16>;
    default: return lstm_recur_bwd_kernel<8, BF16>;
  }
}

void (*fwd_of(int bf16, int train, int r_log2))(Params) {
  if (bf16) {
    return train ? fwd_kernel<true, true>(r_log2)
                 : fwd_kernel<true, false>(r_log2);
  }
  return train ? fwd_kernel<false, true>(r_log2)
               : fwd_kernel<false, false>(r_log2);
}

void (*bwd_of(int bf16, int r_log2))(BwdParams) {
  return bf16 ? bwd_kernel<true>(r_log2) : bwd_kernel<false>(r_log2);
}

int log2_rows(int rows_per_thread) {
  switch (rows_per_thread) {
    case 1: return 0;
    case 2: return 1;
    case 4: return 2;
    case 8: return 3;
    default: return -1;
  }
}

// The launch setup on the current card, once per card: every instance may
// use the card's opt-in shared memory per block. Returns that limit in
// `limit`. The attribute belongs to the card's context, so each card sets
// it itself.
int launch_setup(int* limit) {
  static int limit_of[MAX_DEVICES] = {};   // by card ordinal; 0: not set
  int device = 0;
  cudaError_t err = current_device(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int& lim = limit_of[device];
  if (lim == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    for (int bf16 = 0; bf16 < 2 && err == cudaSuccess; ++bf16) {
      for (int r = 0; r < 4 && err == cudaSuccess; ++r) {
        for (int train = 0; train < 2 && err == cudaSuccess; ++train) {
          err = cudaFuncSetAttribute(
              fwd_of(bf16, train, r),
              cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
        }
        if (err == cudaSuccess) {
          err = cudaFuncSetAttribute(
              bwd_of(bf16, r), cudaFuncAttributeMaxDynamicSharedMemorySize,
              optin);
        }
      }
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    lim = optin;
  }
  *limit = lim;
  return 0;
}

// One launch of `kernel` over (cluster x tiles, k) blocks of `threads`,
// `cluster` blocks a cluster.
template <typename P>
cudaError_t launch(void (*kernel)(P), const P& p, int k, int cluster,
                   int tiles, int threads, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(cluster * tiles),
                     static_cast<unsigned int>(k), 1);
  cfg.blockDim = dim3(static_cast<unsigned int>(threads), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// The checks both entry points make of a shape and a plan.
bool plan_ok(int64_t k, int64_t n, int64_t t, int64_t h, int cluster,
             int units, int split, int rows_per_thread, int groups) {
  return !(h <= 0 || h > MAX_FEATURES || k > 65535 || n > INT32_MAX ||
           t > INT32_MAX || cluster < 1 || cluster > MAX_CLUSTER ||
           units < 1 || split < 1 || split > MAX_SPLIT ||
           (split & (split - 1)) != 0 || groups < 1 ||
           split * units * groups > MAX_THREADS ||
           static_cast<int64_t>(cluster) * units < h ||
           static_cast<int64_t>(cluster - 1) * units >= h ||
           log2_rows(rows_per_thread) < 0);
}

}  // namespace

// Launches K4 on `stream`: gates_x (k, n, t, 4h) fp32 contiguous, w_hh_t
// (k, h, 4h) fp32 with element strides (ws0, ws1, ws2), out (k, n, t, h)
// fp32 contiguous. The plan: blocks of a cluster, hidden units of a block,
// lanes a dot product is split over (1, 2, 4 or 8), rows a thread (1, 2,
// 4 or 8) and row groups of a block. bf16: the bf16 compute form. train:
// the training form, which also writes acts (k, n, t, 4h) and cs (k, n,
// t, h), fp32 contiguous (null otherwise). Returns the first CUDA error,
// or 0; cudaErrorInvalidValue for a plan or a shape the kernel does not
// take.
extern "C" int mst_lstm_recur(const void* gates_x, const void* w_hh_t,
                              void* out, void* acts, void* cs, int64_t k,
                              int64_t n, int64_t t, int64_t h, int64_t ws0,
                              int64_t ws1, int64_t ws2, int cluster,
                              int units, int split, int rows_per_thread,
                              int groups, int bf16, int train,
                              void* stream) {
  if (k <= 0 || n <= 0 || t <= 0) return 0;
  if (!plan_ok(k, n, t, h, cluster, units, split, rows_per_thread, groups) ||
      (train && (acts == nullptr || cs == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int limit = 0;
  const int err = launch_setup(&limit);
  if (err != 0) return err;
  Params p;
  p.gx = static_cast<const float*>(gates_x);
  p.w = static_cast<const float*>(w_hh_t);
  p.out = static_cast<float*>(out);
  p.acts = static_cast<float*>(acts);
  p.cs = static_cast<float*>(cs);
  p.w_stride[0] = ws0;
  p.w_stride[1] = ws1;
  p.w_stride[2] = ws2;
  p.n = static_cast<int>(n);
  p.t = static_cast<int>(t);
  p.h = static_cast<int>(h);
  p.units = units;
  p.groups = groups;
  p.split = split;
  p.ks = round4((p.h + split - 1) / split);
  p.kp = split * p.ks;
  // a split's segment 16 bytes longer than its depths: neighbouring
  // splits' loads land in other banks
  p.seg = p.ks + 4;
  p.hp = split * p.seg;
  const int rows = rows_per_thread * groups;
  const size_t smem = bf16 ? smem_bytes<true>(p.kp, p.hp, units, rows)
                           : smem_bytes<false>(p.kp, p.hp, units, rows);
  if (smem > static_cast<size_t>(limit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (n + rows - 1) / rows;
  if (tiles * cluster > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t launched =
      launch(fwd_of(bf16, train, log2_rows(rows_per_thread)), p,
             static_cast<int>(k), cluster, static_cast<int>(tiles),
             split * units * groups, smem, static_cast<cudaStream_t>(stream));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

// Launches K4's backward on `stream`: dout (k, n, t, h), acts (k, n, t,
// 4h) and cs (k, n, t, h) of the training form, fp32 contiguous; w_hh_t
// (k, h, 4h) fp32 with element strides (ws0, ws1, ws2); dgates (k, n, t,
// 4h) fp32 contiguous, every value written. The plan as mst_lstm_recur's
// (mst_torch.ops.lstm_kernel.plan with bwd). Returns as mst_lstm_recur.
extern "C" int mst_lstm_recur_bwd(const void* dout, const void* acts,
                                  const void* cs, const void* w_hh_t,
                                  void* dgates, int64_t k, int64_t n,
                                  int64_t t, int64_t h, int64_t ws0,
                                  int64_t ws1, int64_t ws2, int cluster,
                                  int units, int split, int rows_per_thread,
                                  int groups, int bf16, void* stream) {
  if (k <= 0 || n <= 0 || t <= 0) return 0;
  if (!plan_ok(k, n, t, h, cluster, units, split, rows_per_thread, groups)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int limit = 0;
  const int err = launch_setup(&limit);
  if (err != 0) return err;
  BwdParams p;
  p.dout = static_cast<const float*>(dout);
  p.acts = static_cast<const float*>(acts);
  p.cs = static_cast<const float*>(cs);
  p.w = static_cast<const float*>(w_hh_t);
  p.dgates = static_cast<float*>(dgates);
  p.w_stride[0] = ws0;
  p.w_stride[1] = ws1;
  p.w_stride[2] = ws2;
  p.n = static_cast<int>(n);
  p.t = static_cast<int>(t);
  p.h = static_cast<int>(h);
  p.units = units;
  p.groups = groups;
  p.split = split;
  p.ks = round4((p.h + split - 1) / split);
  p.kp = split * p.ks;
  p.seg = 4 * p.ks + 4;
  p.hp = split * p.seg;
  const int rows = rows_per_thread * groups;
  const size_t smem = bf16 ? smem_bytes<true>(p.kp, p.hp, units, rows)
                           : smem_bytes<false>(p.kp, p.hp, units, rows);
  if (smem > static_cast<size_t>(limit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (n + rows - 1) / rows;
  if (tiles * cluster > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t launched =
      launch(bwd_of(bf16, log2_rows(rows_per_thread)), p,
             static_cast<int>(k), cluster, static_cast<int>(tiles),
             split * units * groups, smem, static_cast<cudaStream_t>(stream));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}
