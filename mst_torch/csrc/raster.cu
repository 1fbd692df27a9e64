// K1: scatter-max rasterization of note records, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mst_tpu/ops/pallas_raster.py:_kernel
// (launched by _pallas_call, :96-125) and computes what its jnp twin
// mst_tpu/ops/device_raster.py:segment_rasterize computes: onto a zero
// base of (n_rows, n_notes * n_feat) fp32 lanes, every valid note writes
//   lane note*F     <- duration
//   lane note*F + 1 <- velocity
//   lane note*F+2+acc <- 1.0          (pitched layout, F == 5, only)
// and collisions keep the maximum. Invalid notes, sentinel rows (2**30)
// and any row >= n_rows are skipped.
//
// What bounds it on the H100: bytes. The notes are a few hundred KB; the
// raster is hundreds of MB (6 songs x 8 channels x 128 bars x 4 beats x 10
// fractions x 280 lanes x 4 B = 275 MB at the main path's extraction
// shape) and is almost all zeros. Its one write is the bound: 0.082 ms at
// 3.35 TB/s.
//
// Design: one cooperative launch that writes the whole raster. Its grid is
// no larger than the blocks the card holds at once. Every thread first
// zero-fills a grid-stride share of the raster with 16-byte stores; after
// a grid-wide barrier (cooperative_groups::this_grid().sync()) one thread
// per note applies its 2-3 values with a global atomicMax on the int bit
// pattern. So the raster is written once, by this kernel, and the records
// may come in any order. The wrapper allocates the output with
// torch.empty and never waits for the device. On an NVIDIA H100 80GB HBM3
// at 700 W (chip_smoke.py) the launch takes 0.094 ms at the extraction
// shape, torch.zeros of the same raster alone 0.086 ms.
//
// The int-bit max is exact for every fp32 value. Before the atomic a NaN
// of either sign becomes the canonical positive quiet NaN (0x7FC00000),
// whose int pattern beats +inf's. Negative values, -0.0 and -inf have
// negative int patterns and lose to the zero base; for values >= +0.0 the
// int order is the float order. That is what torch's scatter_reduce_
// "amax" and JAX's .at[].max give on a zero base: negatives and -0.0 leave
// +0.0, +inf wins, NaN wins (only its sign and payload may differ).
//
// The TPU kernel's 512-row VMEM chunk (573 KB) does not fit a block's
// 227 KB of shared memory and buys nothing here, so it is not carried
// over, nor is its note-count cap (MAX_PALLAS_NOTES, a VMEM limit).
// Offsets are int64: row * lanes passes 2**31 at large batches.
//
// The bf16 form (the raster of the bf16 storage policy, _pallas_call's
// out_dtype) writes the bf16 cast of the fp32 raster, once and directly.
// Rounding to nearest is monotone, so the cast commutes with the max: each
// value is rounded first (__float2bfloat16_rn), and the same int-bit max
// runs on the signed 16-bit pattern, where the order of the fp32 patterns
// carries over (a NaN becomes the canonical 0x7FC0, which beats +inf's
// 0x7F80; patterns <= 0 lose to the zero base). The PTX ISA has no 16-bit
// atom.max; it has a 16-bit atom.cas (sm_70 and later), which CUDA offers
// as atomicCAS on an unsigned short. So a lane is raised by a
// compare-and-swap loop on its own 16 bits: it starts from the zero base,
// and each failed swap returns the lane's current pattern, so the loop
// ends once the lane holds a pattern >= the note's. The two lanes of one
// 32-bit word are never in each other's way. The zero-fill stores 16
// bytes (8 lanes) a thread, as in the fp32 form. Half the bytes: a bound
// of 0.041 ms at 3.35 TB/s at the extraction shape. On an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py) the launch takes 0.054 ms there,
// torch.zeros of the bf16 raster alone 0.045 ms.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int CANONICAL_NAN = 0x7FC00000;
constexpr short CANONICAL_NAN_BF16 = 0x7FC0;

// the fp32 form: one lane is one 32-bit int
__device__ __forceinline__ void max_into(int* base, int64_t lane,
                                         int64_t lanes, float value) {
  const int bits = value != value ? CANONICAL_NAN : __float_as_int(value);
  // a pattern <= 0 (+0.0, -0.0, any negative) cannot beat the zero base
  if (bits > 0 && lane >= 0 && lane < lanes) atomicMax(base + lane, bits);
}

// the bf16 form: one lane is one 16-bit pattern, raised by compare-and-swap
__device__ __forceinline__ void max_into(unsigned short* base, int64_t lane,
                                         int64_t lanes, float value) {
  const short bits =
      value != value
          ? CANONICAL_NAN_BF16
          : static_cast<short>(__bfloat16_as_ushort(__float2bfloat16_rn(value)));
  if (bits <= 0 || lane < 0 || lane >= lanes) return;
  unsigned short* cell = base + lane;
  unsigned short seen = 0;  // the zero base
  while (static_cast<short>(seen) < bits) {
    const unsigned short was =
        atomicCAS(cell, seen, static_cast<unsigned short>(bits));
    if (was == seen) break;
    seen = was;
  }
}

// T: float (the fp32 raster, lanes as int) or unsigned short (bf16 lanes)
template <typename T>
__global__ void __launch_bounds__(THREADS)
raster_kernel(const int32_t* __restrict__ row,
              const int32_t* __restrict__ note_idx,
              const int32_t* __restrict__ acc,
              const float* __restrict__ duration,
              const float* __restrict__ velocity,
              const uint8_t* __restrict__ valid, int64_t n, int64_t n_rows,
              int32_t n_notes, int32_t n_feat, T* __restrict__ out) {
  constexpr int PER16 = 16 / sizeof(T);   // lanes per 16-byte store
  const int64_t lanes = static_cast<int64_t>(n_notes) * n_feat;
  const int64_t total = n_rows * lanes;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  // zero-fill: 16-byte stores, then the < PER16 lanes of the tail
  int4* out16 = reinterpret_cast<int4*>(out);
  const int64_t n16 = total / PER16;
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int64_t i = tid; i < n16; i += stride) out16[i] = zero;
  for (int64_t i = n16 * PER16 + tid; i < total; i += stride) out[i] = T(0);

  cg::this_grid().sync();

  using Cell = typename std::conditional<sizeof(T) == 4, int, T>::type;
  Cell* cells = reinterpret_cast<Cell*>(out);
  for (int64_t i = tid; i < n; i += stride) {
    if (!valid[i]) continue;
    const int64_t r = row[i];
    if (r < 0 || r >= n_rows) continue;
    Cell* cell = cells + r * lanes;
    const int64_t lane0 = static_cast<int64_t>(note_idx[i]) * n_feat;
    max_into(cell, lane0, lanes, duration[i]);
    max_into(cell, lane0 + 1, lanes, velocity[i]);
    if (n_feat == 5) max_into(cell, lane0 + 2 + acc[i], lanes, 1.0f);
  }
}

template <typename T>
int launch(const void* row, const void* note_idx, const void* acc,
           const void* duration, const void* velocity, const void* valid,
           int64_t n, int64_t n_rows, int32_t n_notes, int32_t n_feat,
           void* out, void* stream) {
  const int64_t total = n_rows * n_notes * n_feat;
  if (total <= 0) return 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, raster_kernel<T>, THREADS, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // no more blocks than the card holds at once (the grid barrier needs
  // every block resident), and no more than the work needs
  const int64_t per16 = 16 / sizeof(T);
  const int64_t work = total / per16 > n ? total / per16 : n;
  int64_t blocks = (work + THREADS - 1) / THREADS;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  const int32_t* row_ = static_cast<const int32_t*>(row);
  const int32_t* note_ = static_cast<const int32_t*>(note_idx);
  const int32_t* acc_ = static_cast<const int32_t*>(acc);
  const float* dur_ = static_cast<const float*>(duration);
  const float* vel_ = static_cast<const float*>(velocity);
  const uint8_t* valid_ = static_cast<const uint8_t*>(valid);
  T* out_ = static_cast<T*>(out);
  void* args[] = {&row_, &note_, &acc_, &dur_, &vel_, &valid_, &n,
                  &n_rows, &n_notes, &n_feat, &out_};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(raster_kernel<T>),
      dim3(static_cast<unsigned int>(blocks)), dim3(THREADS), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K1 on `stream`: writes the whole (n_rows, n_notes * n_feat)
// raster `out`, fp32, or bf16 when `bf16` is not 0 (16-byte aligned; its
// prior contents are ignored). Returns the first CUDA error, or 0.
extern "C" int mst_raster(const void* row, const void* note_idx,
                          const void* acc, const void* duration,
                          const void* velocity, const void* valid,
                          int64_t n, int64_t n_rows, int32_t n_notes,
                          int32_t n_feat, int bf16, void* out,
                          void* stream) {
  return bf16 ? launch<unsigned short>(row, note_idx, acc, duration,
                                       velocity, valid, n, n_rows, n_notes,
                                       n_feat, out, stream)
              : launch<float>(row, note_idx, acc, duration, velocity, valid,
                              n, n_rows, n_notes, n_feat, out, stream);
}
