// poison: the card half of the port's memory-safety check
// (alfalfa_tpu_torch/tools/poison_check.py), and its positive controls.
//
// Replaces no TPU kernel and is linked into none: compute-sanitizer does not
// run on the machine with the card, so the check is made of what does.  A
// kernel case runs under two fills, 0x00 and 0xFF, and its outputs must not
// change with the fill.  This library fills the shared memory of every SM
// with a pattern just before a case (poison_shared): a kernel that reads
// shared memory it did not write then sees the pattern.  The check fills the
// caching allocator's free blocks (for what a wrapper allocates with
// torch.empty) and puts guards filled with the pattern around every tensor
// the caller passes (reads and writes past the ends) itself, in PyTorch.
//
// The three controls each make one of the faults the check looks for, so
// that a run shows the method sees it on this card: control_shared reads a
// shared word it never wrote, control_read_past reads one element past its
// input, control_write_past writes one element past its output.
//
// Bound: poison_shared stores 227 KB an SM, a few microseconds; the
// controls touch a few kilobytes.  Plain C interface, as every kernel of
// the port: each entry takes its arguments, the CUDA stream and an int*
// into which it writes the launches it issued, and returns the CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

// Every word of this block's dynamic shared memory set to ``pattern``.
// Volatile stores: the compiler would drop stores nothing reads.
__global__ void __launch_bounds__(1024) poison_shared_kernel(unsigned pattern,
                                                             int words) {
  extern __shared__ unsigned s_poison[];
  volatile unsigned* s = s_poison;
  for (int i = threadIdx.x; i < words; i += blockDim.x) s[i] = pattern;
}

// One block an SM, each with the most dynamic shared memory a block may
// have, so that no two fit on one SM and every SM's shared memory is
// covered.
extern "C" int poison_shared_launch(unsigned pattern, void* stream,
                                    int* n_launched) {
  int dev = 0, sms = 0, bytes = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(poison_shared_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (e != cudaSuccess) return (int)e;
  poison_shared_kernel<<<sms, 1024, bytes, (cudaStream_t)stream>>>(pattern,
                                                                   bytes / 4);
  *n_launched = 1;
  return (int)cudaGetLastError();
}

// The SMs and the shared memory poison_shared_launch fills each: what a
// run reports beside the controls.
extern "C" int poison_shared_geometry(int* sms, int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return (int)e;
}

// Control 1: out[b] = the shared word ``word`` of block b, never written.
__global__ void control_shared_kernel(int* out, int word) {
  extern __shared__ int s_never_written[];
  volatile int* s = s_never_written;
  if (threadIdx.x == 0) out[blockIdx.x] = s[word];
}

extern "C" int control_shared_launch(void* out, int blocks, int word,
                                     int bytes, void* stream,
                                     int* n_launched) {
  control_shared_kernel<<<blocks, 32, bytes, (cudaStream_t)stream>>>(
      (int*)out, word);
  *n_launched = 1;
  return (int)cudaGetLastError();
}

// Control 2: out[i] = in[i + 1] for every i < n, so the last thread reads
// in[n], one element past the input (its plain version writes 0 there).
__global__ void control_read_past_kernel(const int* in, int* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = in[i + 1];
}

extern "C" int control_read_past_launch(const void* in, void* out, int n,
                                        void* stream, int* n_launched) {
  control_read_past_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const int*)in, (int*)out, n);
  *n_launched = 1;
  return (int)cudaGetLastError();
}

// Control 3: out[i] = i for every i <= n: one element past the n the
// caller's buffer holds, which it fills in place.
__global__ void control_write_past_kernel(int* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i <= n) out[i] = i;
}

extern "C" int control_write_past_launch(void* out, int n, void* stream,
                                         int* n_launched) {
  control_write_past_kernel<<<(n + 256) / 256, 256, 0, (cudaStream_t)stream>>>(
      (int*)out, n);
  *n_launched = 1;
  return (int)cudaGetLastError();
}
