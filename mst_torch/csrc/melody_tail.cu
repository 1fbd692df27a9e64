// K5: the melody encoder's note tail and its channel pooling, for Hopper
// (sm_90a), in two passes.
//
// Replaces no TPU kernel: the JAX package leaves this tail to XLA
// (mst_tpu/models/encoders.py, MelodyEncoder), and keeps it dense there
// because a fused form cost its checkpointed training program more than it
// saved. The port ran it as torch's composition
// (mst_torch.ops.melody_kernel.melody_tail_plain), which writes every
// intermediate of the (B, Cb, R, T, 10, 56, .) note grid to device memory:
// several GB a 12-job request, for a 55 MB result. K5 computes, for each
// song b, live channel c and note row (r, t, f, n) with n = 7 oct + deg,
//
//   z  = leaky(O[b, c, r, t, oct] + S[b, c, r, t, deg])            (M)
//   ch = leaky(Wc x[b, c, r, t, f, n] + bc)                         (CH)
//   y  = leaky(W [z; ch] + b)                                        (M)
//
// from the octave and scale-degree embeddings O (8 x M) and S (7 x M) of
// each (b, c, r, t), which the wrapper computes once (they do not depend
// on the beat fraction f), and the raster's 5 features x. It then pools
// the channels as ops.shapes.combine does over axis 1:
//
//   sq[b, c] = sum over (r, t, f, n, k) of y^2
//   norm     = sqrt(1 + sq) m           denom = sum_c norm (1 where 0)
//   out[b, r, t, f, n] = sum_c (y m) norm / denom
//
// with m the channel mask. No tensor of the note grid reaches device
// memory, and a masked channel (m = 0, whose terms are exactly 0 in the
// composition) costs no note-row work.
//
// What bounds it on the H100. Bytes: the live channels' raster (1,120 bytes
// a note row of 56 notes, read once by each pass) and the (B, R, T, 10, 56,
// M) result, over 3.35 TB/s. Its operations, about 170 a note row and
// channel as the composition counts them, are a tenth of that time at 67
// TFLOP/s; K5 does about 100 (below).
//
// Design. The channel norms need every note row of a channel before any
// output, so the work is two launches, and no float atomics: the sums are
// the same bits run to run. Pass 1 (melody_tail_norms_kernel) runs a block
// a (tile of ROWS (r, t) rows, channel, song); a block of a masked channel
// writes a zero partial and returns, so the grid stays the same whatever
// the mask, and a CUDA graph captures it. A block stages its tile's raster
// (ROWS x 2,800 floats) in shared memory with 16-byte loads, and its O and
// S rows and the small weights beside it. z does not depend on f, so the
// block first forms P = W[:, :M] z + b once a (r, t, n), ten times fewer
// than the note rows; a note row then costs Wc x + bc and W[:, M:] ch, 91
// multiply-adds, with the weights read by 16-byte broadcast loads. Each
// thread computes PER_THREAD note rows (consecutive threads, consecutive
// notes: the 5-float stride reads shared memory without bank conflicts)
// and sums their squares; the block reduces by shuffles, then its warps
// in order, and writes one partial. The wrapper sums the partials in torch (a fixed
// order), sums them over the seq ranks where a bar-sharding context is
// active, and runs pass 2 (melody_tail_pool_kernel): a block a (tile,
// song), each thread owning PER_THREAD outputs, walks the live channels in
// ascending order, stages each one's tile and recomputes its tail, adds y m
// norm into registers, and writes out = sum / denom with 16-byte stores.
//
// Numerics. Every value is fp32; the products are fused multiply-adds in
// ascending depth, cuBLAS sums them in its own order, and the squared norm
// is summed in another order than torch's reduction: the fp32-
// reassociation rule holds against the composition. leaky is torch's,
// x > 0 ? x : x * 0.01f; sqrtf and the division are IEEE (no fast math).
//
// Layouts (all contiguous): raster (B, Cb, R T, 10 x 56 x 5); O (B, Cb,
// R T, 8 M); S (B, Cb, R T, 7 M); mask (B, Cb) or null (every channel
// live); Wc (CH, 5); bc (CH); W (M, M + CH); b (M); partials (B, Cb,
// tiles); sq (B, Cb); out (B, R T, 10 x 56, M).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_OCT = 8;
constexpr int N_DEG = 7;
constexpr int N_NOTES = N_OCT * N_DEG;          // 56
constexpr int N_FEAT = 5;
constexpr int N_FRAC = 10;
constexpr int ITEMS = N_FRAC * N_NOTES;         // note rows of one (r, t)
constexpr int ROW_FLOATS = ITEMS * N_FEAT;      // raster floats of one (r, t)
constexpr int ROWS = 2;                         // (r, t) rows of a tile
constexpr int THREADS = 224;                    // 7 warps
constexpr int PER_THREAD = ROWS * ITEMS / THREADS;
static_assert(PER_THREAD * THREADS == ROWS * ITEMS, "a tile fills the block");
static_assert(ROW_FLOATS % 4 == 0, "an (r, t) row is whole 16-byte words");

__device__ __forceinline__ float leaky(float x) {
  return x > 0.f ? x : x * 0.01f;
}

// The (r, t) rows of the tile that starts at rt0: ROWS, or fewer at the end.
__device__ __forceinline__ int tile_rows(int64_t rt_len, int64_t rt0) {
  return rt_len - rt0 < ROWS ? static_cast<int>(rt_len - rt0) : ROWS;
}

// The weights sit in shared memory as rows of PAD floats, so that a thread
// reads a row with 16-byte broadcast loads: Wc's row j with bc[j] after
// it, and the channel part of W's row j (its last CH columns). The
// embedding part of W (its first M columns) and b serve once a (r, t, n):
// a tile's P = W[:, :M] z + b, for its rows' 56 notes, sits beside them.
constexpr int PAD = 8;

template <int M, int CH>
struct __align__(16) Tile {
  static_assert(N_FEAT + 1 <= PAD && CH <= PAD, "a weight row fits PAD");
  static_assert(M % 4 == 0, "a P row is whole 16-byte words");
  static constexpr int P_STRIDE = M + 4;   // no bank conflict between notes
  float raster[ROWS * ROW_FLOATS];
  float p[ROWS * N_NOTES * P_STRIDE];
  float o[ROWS * N_OCT * M];
  float s[ROWS * N_DEG * M];
  float wc[CH * PAD];                      // Wc[j, :], bc[j], 0...
  float wch[M * PAD];                      // W[j, M:], 0...
  float wz[M * M];                         // W[j, :M]
  float b[M];
};

template <int M, int CH>
__device__ __forceinline__ void load_weights(Tile<M, CH>& t,
                                             const float* __restrict__ wc,
                                             const float* __restrict__ bc,
                                             const float* __restrict__ w,
                                             const float* __restrict__ b) {
  for (int i = threadIdx.x; i < CH * PAD; i += THREADS) {
    const int j = i / PAD, f = i - j * PAD;
    t.wc[i] = f < N_FEAT ? wc[j * N_FEAT + f] : f == N_FEAT ? bc[j] : 0.f;
  }
  for (int i = threadIdx.x; i < M * PAD; i += THREADS) {
    const int j = i / PAD, c = i - j * PAD;
    t.wch[i] = c < CH ? w[j * (M + CH) + M + c] : 0.f;
  }
  for (int i = threadIdx.x; i < M * M; i += THREADS)
    t.wz[i] = w[(i / M) * (M + CH) + i % M];
  for (int i = threadIdx.x; i < M; i += THREADS) t.b[i] = b[i];
}

// N floats of shared memory (N a multiple of 4) into registers, 16 bytes
// a load.
template <int N>
__device__ __forceinline__ void load_row(const float* src, float (&dst)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    dst[4 * q] = v.x;
    dst[4 * q + 1] = v.y;
    dst[4 * q + 2] = v.z;
    dst[4 * q + 3] = v.w;
  }
}

// The raster, O and S of rows [rt0, rt0 + rows) of channel (b, c), then P
// of those rows. The weights are loaded; the caller syncs after.
template <int M, int CH>
__device__ __forceinline__ void stage(Tile<M, CH>& t,
                                      const float* __restrict__ raster,
                                      const float* __restrict__ o,
                                      const float* __restrict__ s,
                                      int64_t bc_row, int64_t rt0, int rows) {
  const int64_t row = bc_row + rt0;              // (b, c, r t) flat
  const float4* src =
      reinterpret_cast<const float4*>(raster + row * ROW_FLOATS);
  float4* dst = reinterpret_cast<float4*>(t.raster);
  const int n4 = rows * (ROW_FLOATS / 4);
  for (int i = threadIdx.x; i < n4; i += THREADS) dst[i] = src[i];
  const float* o_src = o + row * (N_OCT * M);
  for (int i = threadIdx.x; i < rows * N_OCT * M; i += THREADS)
    t.o[i] = o_src[i];
  const float* s_src = s + row * (N_DEG * M);
  for (int i = threadIdx.x; i < rows * N_DEG * M; i += THREADS)
    t.s[i] = s_src[i];
  __syncthreads();
  // P[rt, n, j] = sum_k W[j, k] leaky(O[rt, oct, k] + S[rt, deg, k]) + b[j]
  for (int i = threadIdx.x; i < rows * N_NOTES * M; i += THREADS) {
    const int rtn = i / M, j = i - rtn * M;
    const int rt = rtn / N_NOTES, n = rtn - rt * N_NOTES;
    const int oct = n / N_DEG, deg = n - oct * N_DEG;
    const float* oz = t.o + (rt * N_OCT + oct) * M;
    const float* sz = t.s + (rt * N_DEG + deg) * M;
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < M; ++k) a += t.wz[j * M + k] * leaky(oz[k] + sz[k]);
    t.p[rtn * Tile<M, CH>::P_STRIDE + j] = a + t.b[j];
  }
}

// y of note row ``item`` (row-major over (r t within the tile, f, n)):
// ch = leaky(Wc x + bc), then y = leaky(P[r t, n] + W[:, M:] ch).
template <int M, int CH>
__device__ __forceinline__ void note_tail(const Tile<M, CH>& t, int item,
                                          float (&y)[M]) {
  const int rt = item / ITEMS;
  const int fn = item - rt * ITEMS;
  const int n = fn % N_NOTES;
  const float* x = t.raster + rt * ROW_FLOATS + fn * N_FEAT;
  float v[N_FEAT];
#pragma unroll
  for (int f = 0; f < N_FEAT; ++f) v[f] = x[f];
  float ch[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    float row[PAD];
    load_row(t.wc + j * PAD, row);
    float a = 0.f;
#pragma unroll
    for (int f = 0; f < N_FEAT; ++f) a += v[f] * row[f];
    ch[j] = leaky(a + row[N_FEAT]);
  }
  load_row(t.p + (rt * N_NOTES + n) * Tile<M, CH>::P_STRIDE, y);
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float row[PAD];
    load_row(t.wch + j * PAD, row);
    float a = y[j];
#pragma unroll
    for (int c = 0; c < CH; ++c) a += ch[c] * row[c];
    y[j] = leaky(a);
  }
}

template <int M, int CH>
__global__ void __launch_bounds__(THREADS)
    melody_tail_norms_kernel(const float* __restrict__ raster,
                             const float* __restrict__ o,
                             const float* __restrict__ s,
                             const float* __restrict__ mask,
                             const float* __restrict__ wc,
                             const float* __restrict__ bc,
                             const float* __restrict__ w,
                             const float* __restrict__ b, float* partials,
                             int64_t n_chan, int64_t rt_len) {
  const int64_t tile = blockIdx.x, c = blockIdx.y, song = blockIdx.z;
  const int64_t slot = (song * n_chan + c) * gridDim.x + tile;
  if (mask != nullptr && mask[song * n_chan + c] == 0.f) {
    if (threadIdx.x == 0) partials[slot] = 0.f;
    return;
  }
  __shared__ Tile<M, CH> t;
  __shared__ float warp_sums[THREADS / 32];
  const int64_t rt0 = tile * ROWS;
  const int rows = tile_rows(rt_len, rt0);
  load_weights(t, wc, bc, w, b);
  stage(t, raster, o, s, (song * n_chan + c) * rt_len, rt0, rows);
  __syncthreads();
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int item = threadIdx.x + k * THREADS;
    if (item < rows * ITEMS) {
      float y[M];
      note_tail(t, item, y);
#pragma unroll
      for (int j = 0; j < M; ++j) acc += y[j] * y[j];
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(~0u, acc, d);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) total += warp_sums[i];
    partials[slot] = total;
  }
}

template <int M, int CH>
__global__ void __launch_bounds__(THREADS)
    melody_tail_pool_kernel(const float* __restrict__ raster,
                            const float* __restrict__ o,
                            const float* __restrict__ s,
                            const float* __restrict__ mask,
                            const float* __restrict__ sq,
                            const float* __restrict__ wc,
                            const float* __restrict__ bc,
                            const float* __restrict__ w,
                            const float* __restrict__ b, float* out,
                            int64_t n_chan, int64_t rt_len) {
  const int64_t tile = blockIdx.x, song = blockIdx.y;
  __shared__ Tile<M, CH> t;
  const int64_t rt0 = tile * ROWS;
  const int rows = tile_rows(rt_len, rt0);
  load_weights(t, wc, bc, w, b);
  const float* sq_b = sq + song * n_chan;
  const float* m_b = mask == nullptr ? nullptr : mask + song * n_chan;
  float denom = 0.f;
  for (int64_t c = 0; c < n_chan; ++c)
    denom += sqrtf(1.f + sq_b[c]) * (m_b == nullptr ? 1.f : m_b[c]);
  if (m_b != nullptr && !(denom > 0.f)) denom = 1.f;
  float acc[PER_THREAD][M];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k)
#pragma unroll
    for (int j = 0; j < M; ++j) acc[k][j] = 0.f;
  for (int64_t c = 0; c < n_chan; ++c) {
    const float m = m_b == nullptr ? 1.f : m_b[c];
    if (m == 0.f) continue;                  // the same for the whole block
    const float norm = sqrtf(1.f + sq_b[c]) * m;
    __syncthreads();                         // the last channel's reads
    stage(t, raster, o, s, (song * n_chan + c) * rt_len, rt0, rows);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int item = threadIdx.x + k * THREADS;
      if (item < rows * ITEMS) {
        float y[M];
        note_tail(t, item, y);
#pragma unroll
        for (int j = 0; j < M; ++j) acc[k][j] += (y[j] * m) * norm;
      }
    }
  }
  static_assert(M % 4 == 0, "an output row is whole 16-byte words");
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int item = threadIdx.x + k * THREADS;
    if (item < rows * ITEMS) {
      float4* dst = reinterpret_cast<float4*>(
          out + ((song * rt_len + rt0) * ITEMS + item) * M);
#pragma unroll
      for (int q = 0; q < M / 4; ++q)
        dst[q] = make_float4(acc[k][4 * q] / denom, acc[k][4 * q + 1] / denom,
                             acc[k][4 * q + 2] / denom,
                             acc[k][4 * q + 3] / denom);
    }
  }
}

template <int M, int CH>
int launch_norms(const float* raster, const float* o, const float* s,
                 const float* mask, const float* wc, const float* bc,
                 const float* w, const float* b, float* partials,
                 int64_t n_song, int64_t n_chan, int64_t rt_len,
                 cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rt_len + ROWS - 1) / ROWS),
                  static_cast<unsigned>(n_chan),
                  static_cast<unsigned>(n_song));
  melody_tail_norms_kernel<M, CH><<<grid, THREADS, 0, stream>>>(
      raster, o, s, mask, wc, bc, w, b, partials, n_chan, rt_len);
  return static_cast<int>(cudaGetLastError());
}

template <int M, int CH>
int launch_pool(const float* raster, const float* o, const float* s,
                const float* mask, const float* sq, const float* wc,
                const float* bc, const float* w, const float* b, float* out,
                int64_t n_song, int64_t n_chan, int64_t rt_len,
                cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rt_len + ROWS - 1) / ROWS),
                  static_cast<unsigned>(n_song));
  melody_tail_pool_kernel<M, CH><<<grid, THREADS, 0, stream>>>(
      raster, o, s, mask, sq, wc, bc, w, b, out, n_chan, rt_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The (r, t) rows of a tile: pass 1 writes one partial a tile.
extern "C" int mst_melody_tail_tile_rows() { return ROWS; }

// The widths K5 takes: M = 8 (the thesis's melody size) and CH = 7, its
// channels_linear width, ceil((5 + M) / 2). Others return
// cudaErrorInvalidValue without a launch.

extern "C" int mst_melody_tail_norms(const float* raster, const float* o,
                                     const float* s, const float* mask,
                                     const float* wc, const float* bc,
                                     const float* w, const float* b,
                                     float* partials, int64_t n_song,
                                     int64_t n_chan, int64_t rt_len, int m,
                                     int ch, void* stream) {
  if (m != 8 || ch != 7) return static_cast<int>(cudaErrorInvalidValue);
  return launch_norms<8, 7>(raster, o, s, mask, wc, bc, w, b, partials,
                            n_song, n_chan, rt_len,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int mst_melody_tail_pool(const float* raster, const float* o,
                                    const float* s, const float* mask,
                                    const float* sq, const float* wc,
                                    const float* bc, const float* w,
                                    const float* b, float* out,
                                    int64_t n_song, int64_t n_chan,
                                    int64_t rt_len, int m, int ch,
                                    void* stream) {
  if (m != 8 || ch != 7) return static_cast<int>(cudaErrorInvalidValue);
  return launch_pool<8, 7>(raster, o, s, mask, sq, wc, bc, w, b, out, n_song,
                           n_chan, rt_len, static_cast<cudaStream_t>(stream));
}
