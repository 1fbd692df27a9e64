// K6: the served request's packing and compaction, for Hopper (sm_90a), in
// two passes.
//
// Replaces no TPU kernel: the JAX package leaves both steps to XLA
// (mst_tpu/transfer.py, _pack_word :43-84 and _compact_song :158-241). The
// port ran them as torch's composition (mst_torch.transfer._pack_word and
// _compact_song): about fifteen full-size elementwise passes over the
// applier's (B, C, R, T, 10, N, F) output to form one int64 word a cell,
// then a 0/1 mask of the words, its 128-cell block prefixes as one fp16
// product, and a rank lookup that gathers (B x capacity, 128) prefix rows.
// Every one of them covers every cell of the (B, Cb, Rb, ...) grid, though
// a request's songs fill 2-3 of its 8 channels and 66-126 of its 128 bars,
// and notes about 0.15% of the cells.
//
// For job b and cell m of its flat (C, R, T, 10, N) grid, with features
// x[m, :F] (duration, velocity, then the flat, natural and sharp
// accidentals when F = 5), the word is
//
//   vel  = (int64)((v > 0.01f ? v : 0) * 127.0f)          (truncated)
//   dur  = clamp((int32)(d * tpb[b]), 0, 65535)
//   code = the first of flat (0), natural (1), sharp (2) that is a maximum
//          of the three and > 0.1f; 1 when none is; 0 when F = 2
//   word = vel > 0 ? dur << 16 | vel << 8 | code : 0
//
// each multiply one fp32 operation (built with --fmad=false), as torch's
// separate elementwise kernels round it. A cell is a note when it lies in a
// channel below n_chan[b] and a bar below n_bars[b] and its word is not 0.
// The outputs are _compact_song's, bit for bit: the notes per 128-cell
// block; the live (nonempty) blocks, of which only the first max_blocks
// are routed; count, the notes of the routed blocks; and records[b, q] =
// (cell, word) of the q-th note in cell order for q < min(count, capacity),
// (0, 0) past it.
//
// What bounds it on the H100: bytes. The valid cells' features are read
// once (velocity at a stride of F floats touches every sector of a row, so
// the whole of each valid (b, c, r) row comes in), the records written
// once. At the 12-job request's shape (12, 8, 128, 4, 10, 56, 5), with
// 2-3 channels and 66-126 bars a job, that is about 130 MB of the 550 MB
// applier output: ~0.04 ms at 3.35 TB/s.
//
// Design. A warp owns one 128-cell block; a block of threads, WARPS
// consecutive blocks of one job. Pass 1 (pack_compact_count_kernel) finds
// each lane's four cells' (b, c, r) row with one division a warp (a row
// holds at least 128 cells at every shape the port serves; a smaller row
// costs a division a cell), skips cells outside the valid rows without
// reading them, forms each valid cell's word, and writes the block's note
// count, a __ballot_sync and __popc a quarter of the block: (B, G) int32,
// no atomics, the same bits every run. Between the passes the wrapper
// (mst_torch.ops.compact_kernel) runs a few (B, G)-sized torch ops on the
// same stream: the live blocks' ranks, the routed blocks' counts and their
// inclusive prefix. Pass 2 (pack_compact_write_kernel) has the same grid;
// a warp whose block is not routed, or whose first rank is past the
// capacity, returns after one read, and the others form their words again
// and store each note's (cell, word) at start + in-block rank with one
// 16-byte store, into records the wrapper zeroed. Neither pass nor the
// glue waits for the host, so a CUDA graph captures them as they are.
//
// Layouts (all contiguous): x (B, M, F) fp32 with M = C x R x row cells a
// job and row = T x 10 x N; tpb (B) fp32; n_chan, n_bars (B) int64;
// counts, routed (B, G) int32 with G = ceil(M / 128); incl (B, G) int64;
// records (B, capacity, 2) int64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;                 // cells of a compaction block
constexpr int WARPS = 8;                   // blocks of a block of threads
constexpr int THREADS = WARPS * 32;
constexpr int QUARTERS = BLOCK / 32;       // cells of a lane

// A job's cells are indexed in 32 bits (the wrapper keeps M F below 2**31):
// a 32-bit division is a third of a 64-bit one, and pass 1 makes three a
// warp.
struct Grid {
  uint32_t cells;   // M: cells of a job
  uint32_t blocks;  // G: its 128-cell blocks
  uint32_t row;     // cells of a (c, r) row: T x 10 x N
  uint32_t bars;    // R
};

// Whether row q = c R + r of a job lies below its channel and bar counts.
__device__ __forceinline__ bool valid_row(uint32_t q, uint32_t bars,
                                         int64_t n_chan, int64_t n_bars) {
  const uint32_t c = q / bars;
  return c < n_chan && q - c * bars < n_bars;
}

// The packed word of the cell whose F features start at ``f``.
template <int F>
__device__ __forceinline__ uint64_t cell_word(const float* __restrict__ f,
                                              float tpb) {
  const float v = f[1];
  const long long vel = static_cast<long long>(
      __fmul_rn(v > 0.01f ? v : 0.f, 127.0f));
  if (vel <= 0) return 0;
  int dur = static_cast<int>(__fmul_rn(f[0], tpb));
  dur = dur < 0 ? 0 : (dur > 65535 ? 65535 : dur);
  uint64_t code = 0;
  if constexpr (F == 5) {
    // a == max of the three, as torch's amax and ==: a NaN among them
    // fails every comparison, and then none fires
    const float a0 = f[2], a1 = f[3], a2 = f[4];
    const bool flat = a0 >= a1 && a0 >= a2 && a0 > 0.1f;
    const bool natural = a1 >= a0 && a1 >= a2 && a1 > 0.1f;
    const bool sharp = a2 >= a0 && a2 >= a1 && a2 > 0.1f;
    code = flat ? 0 : (natural ? 1 : (sharp ? 2 : 1));
  }
  return (static_cast<uint64_t>(dur) << 16) |
         (static_cast<uint64_t>(vel) << 8) | code;
}

// The four cells of this lane in block g of job ``job``: whether each is a
// note, and its word. Cells outside the valid rows are not read.
template <int F>
__device__ __forceinline__ void block_words(
    const float* __restrict__ x, float tpb, int64_t n_chan, int64_t n_bars,
    const Grid& s, int64_t job, uint32_t g, int lane,
    uint64_t (&word)[QUARTERS]) {
  const uint32_t first = g * BLOCK;
  const uint32_t q0 = first / s.row;         // the block's first row
  const uint32_t next = (q0 + 1) * s.row;    // the first cell past it
  const bool ok0 = valid_row(q0, s.bars, n_chan, n_bars);
  const bool ok1 = valid_row(q0 + 1, s.bars, n_chan, n_bars);
  const float* job_x = x + job * static_cast<int64_t>(s.cells) * F;
#pragma unroll
  for (int k = 0; k < QUARTERS; ++k) {
    const uint32_t m = first + k * 32 + lane;
    bool ok;
    if (m < next) {
      ok = ok0;
    } else if (m - next < s.row) {
      ok = ok1;
    } else {                                 // a row of under 128 cells
      ok = valid_row(m / s.row, s.bars, n_chan, n_bars);
    }
    word[k] = ok && m < s.cells ? cell_word<F>(job_x + m * F, tpb) : 0;
  }
}

template <int F>
__global__ void __launch_bounds__(THREADS)
    pack_compact_count_kernel(const float* __restrict__ x,
                              const float* __restrict__ tpb,
                              const int64_t* __restrict__ n_chan,
                              const int64_t* __restrict__ n_bars,
                              int* __restrict__ counts, Grid s) {
  const int64_t job = blockIdx.y;
  const uint32_t g = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (g >= s.blocks) return;                 // the whole warp
  const int lane = threadIdx.x & 31;
  uint64_t word[QUARTERS];
  block_words<F>(x, tpb[job], n_chan[job], n_bars[job], s, job, g, lane,
                 word);
  int n = 0;
#pragma unroll
  for (int k = 0; k < QUARTERS; ++k)
    n += __popc(__ballot_sync(~0u, word[k] != 0));
  if (lane == 0) counts[job * s.blocks + g] = n;
}

template <int F>
__global__ void __launch_bounds__(THREADS)
    pack_compact_write_kernel(const float* __restrict__ x,
                              const float* __restrict__ tpb,
                              const int64_t* __restrict__ n_chan,
                              const int64_t* __restrict__ n_bars,
                              const int* __restrict__ routed,
                              const int64_t* __restrict__ incl,
                              int64_t* __restrict__ records,
                              int64_t capacity, Grid s) {
  const int64_t job = blockIdx.y;
  const uint32_t g = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (g >= s.blocks) return;
  const int64_t slot = job * s.blocks + g;
  const int n = routed[slot];
  if (n == 0) return;                        // not live, or not routed
  const int64_t start = incl[slot] - n;
  if (start >= capacity) return;
  const int lane = threadIdx.x & 31;
  uint64_t word[QUARTERS];
  block_words<F>(x, tpb[job], n_chan[job], n_bars[job], s, job, g, lane,
                 word);
  const unsigned below = (1u << lane) - 1u;
  int64_t rank = start;
  longlong2* out = reinterpret_cast<longlong2*>(records) + job * capacity;
#pragma unroll
  for (int k = 0; k < QUARTERS; ++k) {
    const unsigned notes = __ballot_sync(~0u, word[k] != 0);
    const int64_t q = rank + __popc(notes & below);
    if (word[k] != 0 && q < capacity)
      out[q] = make_longlong2(g * BLOCK + k * 32 + lane,
                              static_cast<long long>(word[k]));
    rank += __popc(notes);
  }
}

dim3 grid_of(const Grid& s, int64_t n_job) {
  return dim3((s.blocks + WARPS - 1) / WARPS, static_cast<unsigned>(n_job));
}

// The grid of a launch, or false for shapes K6 does not take.
bool grid_for(int64_t n_job, int64_t cells, int64_t n_feat, int64_t row,
              int64_t bars, Grid* s) {
  if (n_job < 1 || n_job > 65535 || cells < 1 || row < 1 || bars < 1 ||
      cells * n_feat >= (int64_t{1} << 31))
    return false;
  *s = Grid{static_cast<uint32_t>(cells),
            static_cast<uint32_t>((cells + BLOCK - 1) / BLOCK),
            static_cast<uint32_t>(row), static_cast<uint32_t>(bars)};
  return true;
}

}  // namespace

// The families K6 takes: F = 5 features a cell (pitched) or 2
// (unpitched). Another F, more than 65,535 jobs, an empty grid or one of
// 2**31 floats a job or more returns cudaErrorInvalidValue without a
// launch.

extern "C" int mst_pack_compact_count(const float* x, const float* tpb,
                                      const int64_t* n_chan,
                                      const int64_t* n_bars, int* counts,
                                      int64_t n_job, int64_t n_feat,
                                      int64_t cells, int64_t row,
                                      int64_t bars, void* stream) {
  Grid s;
  if (!grid_for(n_job, cells, n_feat, row, bars, &s))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_feat == 5)
    pack_compact_count_kernel<5><<<grid_of(s, n_job), THREADS, 0, st>>>(
        x, tpb, n_chan, n_bars, counts, s);
  else if (n_feat == 2)
    pack_compact_count_kernel<2><<<grid_of(s, n_job), THREADS, 0, st>>>(
        x, tpb, n_chan, n_bars, counts, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mst_pack_compact_write(const float* x, const float* tpb,
                                      const int64_t* n_chan,
                                      const int64_t* n_bars,
                                      const int* routed, const int64_t* incl,
                                      int64_t* records, int64_t capacity,
                                      int64_t n_job, int64_t n_feat,
                                      int64_t cells, int64_t row,
                                      int64_t bars, void* stream) {
  Grid s;
  if (capacity < 1 || !grid_for(n_job, cells, n_feat, row, bars, &s))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_feat == 5)
    pack_compact_write_kernel<5><<<grid_of(s, n_job), THREADS, 0, st>>>(
        x, tpb, n_chan, n_bars, routed, incl, records, capacity, s);
  else if (n_feat == 2)
    pack_compact_write_kernel<2><<<grid_of(s, n_job), THREADS, 0, st>>>(
        x, tpb, n_chan, n_bars, routed, incl, records, capacity, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
