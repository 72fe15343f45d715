// The row scheduler of the persistent wavefront kernels (enc_inter.cu: K8,
// enc_decide.cu: K9, enc_intra.cu: K7, enc_intra_fixup.cu: K10,
// wavefront.cu: K1, K4, K5): one launch per call, in place of one launch
// per macroblock anti-diagonal.
//
// Each block takes a ticket from a counter in device memory (atomicAdd),
// row-major with the quantizer (K5: the frame) inner: ticket t is row t / Q
// at quantizer t % Q.  It then walks that row's columns left to right.  Before
// macroblock (r, c) thread 0 waits until row r - 1 of its quantizer has
// published min(c + lag, C) macroblocks: lag 2 where a macroblock reads its
// above-right neighbour (the diagonals d = 2r + c), lag 1 where it reads
// left, above and above-left only (d = r + c).  A block waits only on a row
// whose ticket was taken earlier, by a block that is already running, so
// the kernel cannot deadlock however many rows outnumber the blocks the
// card holds at once; neither the order of blockIdx nor a cooperative
// launch is relied on.
//
// Publishing macroblock (r, c): every output written, a barrier, then
// thread 0 stores c + 1 to the row's counter with release semantics (a
// release is cumulative: it orders the writes the barrier ordered before
// it, so no separate fence is needed); the waiter loads it with acquire
// semantics, and a barrier after the wait hands that on to the block's
// other threads.  Neighbour
// state written during the launch is read with plain or L2 (__ldcg) loads,
// never through the non-coherent path (__ldg, const __restrict__).
//
// A wait is bounded: __nanosleep back-off, so the spinning thread leaves
// issue slots to the co-resident block, and __trap() after
// ROW_WAIT_LIMIT_NS, so a scheduling fault fails the launch (the wrapper's
// next CUDA call raises) instead of hanging.
//
// The wait overlaps the next macroblock's source pixels, which depend on
// no neighbour: the block's other threads copy them into the second of two
// shared buffers with cp.async.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// A frame's whole launch takes milliseconds: a wait of two seconds is a
// scheduling fault.
#define ROW_WAIT_LIMIT_NS 2000000000ull

struct RowSched {
  int* ticket;    // the next (row, quantizer) ticket, zero at launch
  int* progress;  // (Q, R) macroblocks published in each row, zero at launch
  int lag;        // (r, c) waits for min(c + lag, C) of row r - 1
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Thread 0 only: wait until ``*counter`` reaches ``need``; the caller's
// next barrier hands the acquire on to its other threads.
__device__ __forceinline__ void row_wait(const int* counter, int need) {
  if (ld_acquire(counter) >= need) return;
  const unsigned long long t0 = global_ns();
  unsigned ns = 32;
  while (ld_acquire(counter) < need) {
    __nanosleep(ns);
    if (ns < 256) ns <<= 1;
    if (global_ns() - t0 > ROW_WAIT_LIMIT_NS) __trap();
  }
}

// Thread 0 only, after a barrier that follows every write of the
// macroblock (or after its own writes, where it made them all).
__device__ __forceinline__ void row_publish(int* counter, int value) {
  st_release(counter, value);
}

// ---- the source prefetch ---------------------------------------------

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s),
               "l"(gmem), "n"(N)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// This thread's copies but the newest ``N`` groups have landed.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Lane ``lane`` of the calling warp starts the copy of one row of
// macroblock (r, c)'s originals into ``dst`` (16x16 luma, then with
// ``chroma`` 8x8 U and 8x8 V): lanes 0-15 the luma rows (16 bytes each),
// lanes 16-31 the chroma rows (U 0-7, V 0-7, 8 bytes each).  The planes
// are (16R, 16C) and (8R, 8C); their bases are 16- and 8-byte aligned (the
// wrappers check), ``dst`` 16-byte aligned.  The caller commits.
__device__ __forceinline__ void stage_originals(uint8_t* dst,
                                                const uint8_t* oy,
                                                const uint8_t* ou,
                                                const uint8_t* ov, int r,
                                                int c, int C, int lane,
                                                bool chroma) {
  if (lane < 16) {
    cp_async<16>(dst + lane * 16,
                 oy + (size_t)(r * 16 + lane) * (C * 16) + c * 16);
  } else if (chroma) {
    const int k = lane - 16, pl = k >> 3, row = k & 7;
    cp_async<8>(dst + 256 + pl * 64 + row * 8,
                (pl ? ov : ou) + (size_t)(r * 8 + row) * (C * 8) + c * 8);
  }
}
