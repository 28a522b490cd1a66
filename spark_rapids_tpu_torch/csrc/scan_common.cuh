// Block-wide scans shared by the cumsum (K2) and segmented-scan (K1)
// kernels.  One element per thread, SCAN_BLOCK threads per block:
// warp shuffles scan each warp, a 32-entry shared array scans the warp
// tails, and every thread adds its warp's incoming tail.
#pragma once
#include <cuda_runtime.h>

#define SCAN_BLOCK 1024
#define FULL_MASK 0xffffffffu

// Rows per block, read once by the caller that sizes the per-block
// scratch, so the block size is set in this one place.
extern "C" int srt_scan_block(void) { return SCAN_BLOCK; }

// ---- element arithmetic --------------------------------------------------
// Integer sums are taken in the unsigned type of the same width: signed
// overflow is undefined in C++, and the result must wrap modulo 2^bits
// exactly as the plain PyTorch version does.

template <typename T> struct Unsigned { typedef T type; };
template <> struct Unsigned<int> { typedef unsigned int type; };
template <> struct Unsigned<long long> { typedef unsigned long long type; };

template <typename T>
__device__ __forceinline__ T add_wrap(T a, T b) {
  typedef typename Unsigned<T>::type U;
  return (T)((U)a + (U)b);
}
template <typename T>
__device__ __forceinline__ T sub_wrap(T a, T b) {
  typedef typename Unsigned<T>::type U;
  return (T)((U)a - (U)b);
}
template <> __device__ __forceinline__ float add_wrap(float a, float b) {
  return a + b;
}
template <> __device__ __forceinline__ double add_wrap(double a, double b) {
  return a + b;
}

// min/max propagate NaN like torch.minimum/torch.maximum (CUDA's fmin and
// fmax drop it, so they are not used).
template <typename T> __device__ __forceinline__ bool is_nan(T) {
  return false;
}
template <> __device__ __forceinline__ bool is_nan(float x) { return x != x; }
template <> __device__ __forceinline__ bool is_nan(double x) { return x != x; }

struct OpSum {
  template <typename T> __device__ __forceinline__ static T apply(T a, T b) {
    return add_wrap(a, b);
  }
};
struct OpMin {
  template <typename T> __device__ __forceinline__ static T apply(T a, T b) {
    if (is_nan(a)) return a;
    if (is_nan(b)) return b;
    return b < a ? b : a;
  }
};
struct OpMax {
  template <typename T> __device__ __forceinline__ static T apply(T a, T b) {
    if (is_nan(a)) return a;
    if (is_nan(b)) return b;
    return b > a ? b : a;
  }
};

// ---- plain inclusive scan --------------------------------------------------

template <typename T>
__device__ __forceinline__ T warp_scan_sum(T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T o = __shfl_up_sync(FULL_MASK, v, d);
    if (lane >= d) v = add_wrap(o, v);
  }
  return v;
}

// Inclusive block scan of one value per thread; `tail` holds 32 entries.
// Ends with a barrier, so `tail` may be reused at once.
template <typename T>
__device__ T block_scan_sum(T v, T* tail) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_scan_sum(v, lane);
  if (lane == 31) tail[warp] = v;
  __syncthreads();
  if (warp == 0) tail[lane] = warp_scan_sum(tail[lane], lane);
  __syncthreads();
  if (warp > 0) v = add_wrap(tail[warp - 1], v);
  __syncthreads();
  return v;
}

// ---- segmented inclusive scan ----------------------------------------------
// An element is (g, v).  combine(earlier, later) = later.v folded with
// earlier.v when both carry the same g, else later unchanged.  With equal
// g values contiguous (sorted ids) this is associative, so any scan tree
// gives each row the reduction of its segment's rows up to it.

template <typename Op, typename T>
__device__ __forceinline__ void warp_seg_scan(int g, T& v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int go = __shfl_up_sync(FULL_MASK, g, d);
    T vo = __shfl_up_sync(FULL_MASK, v, d);
    if (lane >= d && go == g) v = Op::apply(vo, v);
  }
}

template <typename Op, typename T>
__device__ T block_seg_scan(int g, T v, int* tail_g, T* tail_v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_seg_scan<Op>(g, v, lane);
  if (lane == 31) {
    tail_g[warp] = g;
    tail_v[warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
    int tg = tail_g[lane];
    T tv = tail_v[lane];
    warp_seg_scan<Op>(tg, tv, lane);
    tail_v[lane] = tv;
  }
  __syncthreads();
  if (warp > 0 && tail_g[warp - 1] == g) v = Op::apply(tail_v[warp - 1], v);
  __syncthreads();
  return v;
}
