// K2: inclusive prefix sum of an int32 or int64 column, wrapping modulo
// 2^bits.
//
// Replaces the TPU kernel spark_rapids_tpu/ops/pallas_kernels.py
// cumsum_1d (kernel body _cumsum_kernel), which walks (8, 128) tiles in
// grid order and threads the running total through an SMEM scalar.  CUDA
// blocks run in no order, so that carry does not translate; this is a
// reduce-then-scan in three launches instead:
//   1. block_totals: each 1024-row block reduces to one total;
//   2. scan_totals: one block turns the totals into exclusive offsets,
//      looping over them 1024 at a time (n/1024 of them: 65,536 at 2^26);
//   3. scan_apply: each block scans its rows again and adds its offset.
// Bound on this card: bytes.  The function must read n and write n
// elements (16 bytes a row at int64); this design reads the input twice,
// 24 bytes a row, and keeps everything else in registers and shared
// memory.  Decoupled look-back would save the second read; that is a
// later change.
#include "scan_common.cuh"

template <typename T>
__global__ void block_totals(const T* __restrict__ x, T* __restrict__ totals,
                             long long n) {
  __shared__ T tail[32];
  const long long i = (long long)blockIdx.x * SCAN_BLOCK + threadIdx.x;
  T v = i < n ? x[i] : T(0);
  v = block_scan_sum(v, tail);
  if (threadIdx.x == SCAN_BLOCK - 1) totals[blockIdx.x] = v;
}

template <typename T>
__global__ void scan_totals(T* totals, long long nb) {
  __shared__ T tail[32];
  __shared__ T chunk_total;
  T carry = T(0);
  for (long long base = 0; base < nb; base += SCAN_BLOCK) {
    const long long i = base + threadIdx.x;
    const T v = i < nb ? totals[i] : T(0);
    const T inc = block_scan_sum(v, tail);
    // exclusive offset of block i: everything before it
    if (i < nb) totals[i] = add_wrap(carry, sub_wrap(inc, v));
    if (threadIdx.x == SCAN_BLOCK - 1) chunk_total = inc;
    __syncthreads();
    carry = add_wrap(carry, chunk_total);
    __syncthreads();
  }
}

template <typename T>
__global__ void scan_apply(const T* __restrict__ x, T* __restrict__ out,
                           const T* __restrict__ offsets, long long n) {
  __shared__ T tail[32];
  const long long i = (long long)blockIdx.x * SCAN_BLOCK + threadIdx.x;
  T v = i < n ? x[i] : T(0);
  v = block_scan_sum(v, tail);
  if (i < n) out[i] = add_wrap(offsets[blockIdx.x], v);
}

template <typename T>
static int launch(const void* x, void* out, void* scratch, long long n,
                  cudaStream_t s) {
  const long long nb = (n + SCAN_BLOCK - 1) / SCAN_BLOCK;
  T* totals = (T*)scratch;
  block_totals<T><<<(unsigned)nb, SCAN_BLOCK, 0, s>>>((const T*)x, totals, n);
  scan_totals<T><<<1, SCAN_BLOCK, 0, s>>>(totals, nb);
  scan_apply<T><<<(unsigned)nb, SCAN_BLOCK, 0, s>>>((const T*)x, (T*)out,
                                                   totals, n);
  return (int)cudaGetLastError();
}

// x, out: n elements of `elem_bytes` (4: int32, 8: int64); scratch: one
// element per SCAN_BLOCK-row block (srt_scan_block()).  Returns the CUDA
// error code (0 = launched).
extern "C" int srt_cumsum(const void* x, void* out, void* scratch,
                          long long n, int elem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (elem_bytes == 4) return launch<int>(x, out, scratch, n, s);
  if (elem_bytes == 8) return launch<long long>(x, out, scratch, n, s);
  return (int)cudaErrorInvalidValue;
}
