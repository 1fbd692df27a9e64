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
// shape) and is almost all zeros. Its one write is the bound, and the
// wrapper's torch.zeros pays it; this kernel then touches only the
// 2-3 cells of each note.
//
// Design: one thread per note and a global atomicMax on the int bit
// pattern of each value. For floats >= 0 the int order of the bit
// patterns is the float order, so the max is exact and independent of the
// order the atomics land in; the wrapper rejects a negative or NaN
// duration or velocity before the launch. The TPU kernel's 512-row VMEM
// chunk (512 x 280 x 4 B = 573 KB) does not fit a block's 227 KB of
// shared memory and buys nothing here, so it is not carried over, nor is
// its note-count cap (MAX_PALLAS_NOTES, a VMEM limit). Offsets are int64:
// row * lanes passes 2**31 at large batches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void max_into(int* base, int64_t lane,
                                         int64_t lanes, float value) {
  if (lane >= 0 && lane < lanes) {
    atomicMax(base + lane, __float_as_int(value));
  }
}

__global__ void raster_kernel(const int32_t* __restrict__ row,
                              const int32_t* __restrict__ note_idx,
                              const int32_t* __restrict__ acc,
                              const float* __restrict__ duration,
                              const float* __restrict__ velocity,
                              const uint8_t* __restrict__ valid,
                              int64_t n, int64_t n_rows, int32_t n_notes,
                              int32_t n_feat, int* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int64_t r = row[i];
  if (r < 0 || r >= n_rows) return;
  const int64_t lanes = static_cast<int64_t>(n_notes) * n_feat;
  int* cell = out + r * lanes;
  const int64_t lane0 = static_cast<int64_t>(note_idx[i]) * n_feat;
  max_into(cell, lane0, lanes, duration[i]);
  max_into(cell, lane0 + 1, lanes, velocity[i]);
  if (n_feat == 5) {
    max_into(cell, lane0 + 2 + acc[i], lanes, 1.0f);
  }
}

}  // namespace

// Launches K1 on `stream`. `out` is the zero-filled (n_rows, lanes) fp32
// raster, written through its int bit patterns. Returns cudaGetLastError().
extern "C" int mst_raster(const void* row, const void* note_idx,
                          const void* acc, const void* duration,
                          const void* velocity, const void* valid,
                          int64_t n, int64_t n_rows, int32_t n_notes,
                          int32_t n_feat, void* out, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int64_t blocks = (n + threads - 1) / threads;
    raster_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(row),
        static_cast<const int32_t*>(note_idx),
        static_cast<const int32_t*>(acc),
        static_cast<const float*>(duration),
        static_cast<const float*>(velocity),
        static_cast<const uint8_t*>(valid), n, n_rows, n_notes, n_feat,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
