// The shared-memory tile ring of the persistent kernels K2 (grid_tail.cu)
// and K3 (grid_tail_bwd.cu), for Hopper (sm_90a): mbarriers, 1-D TMA bulk
// copies between device and shared memory, and the proxy fence between
// them.
//
// In both kernels one producer warp fills the ring's stages with bulk loads
// that complete on the stage's `full` barrier; the consumers wait on it,
// compute in place, fence, and one thread stores the stage back with bulk
// stores and hands it to the producer on its `empty` barrier once the store
// has read it (bulk_wait_read).
//
// On the host side, the kernels' launch setup: a kernel's shared-memory
// limit is an attribute of the card's context, so each card that launches
// it sets it once (`current_device`, a table by ordinal in each kernel).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_ring {

// The most cards one process launches the kernels on: the size of their
// per-card launch tables.
constexpr int MAX_DEVICES = 64;

// The calling thread's current card, an index into a per-card table.
inline cudaError_t current_device(int* device) {
  cudaError_t err = cudaGetDevice(device);
  if (err == cudaSuccess && (*device < 0 || *device >= MAX_DEVICES)) {
    err = cudaErrorInvalidDevice;
  }
  return err;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// after the barriers are initialised, before any thread or copy uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait for the completion of the barrier's phase of the given parity; a
// wait of 2**34 cycles (~9 s) traps, so a fault fails the launch instead
// of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1LL << 34)) __trap();
  }
}

// device -> shared, completing `bytes` on `bar`; dst, src and bytes are
// multiples of 16
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> device, in the thread's open bulk group (closed by bulk_commit)
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// wait until at most N of the thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// wait until all of the thread's bulk groups are complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// generic-proxy writes to shared memory, made visible to the TMA engine
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// barrier 1 over the first THREADS threads of the block (the consumers)
template <int THREADS>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

}  // namespace tile_ring
