// K3: ascending sort of n 64-bit words compared as unsigned, n a power of
// two.
//
// Replaces the TPU kernel spark_rapids_tpu/ops/pallas_kernels.py
// bitonic_sort_u64 (kernel bodies _make_bitonic_local_kernel,
// _make_bitonic_merge_kernel, helper _xor_permute): the same bitonic
// network, cut to this card.  A tile of up to 4096 words (32 KB of shared
// memory) is sorted in shared memory by one block; every stage whose
// compare distance reaches a tile runs one elementwise launch per such
// substage over device memory, then one shared-memory launch for the
// in-tile tail of that stage.  The direction of every compare-exchange
// comes from the global index, as on the TPU.
// Bound on this card: bytes.  A sort must read and write each word once
// (16 bytes a word); this network streams the whole array through device
// memory once per cross-tile substage and once per tail, 120 passes at
// n = 2^26, so it sits far from the bound.  Merging several substages per
// pass in registers is a later change.
#include <cuda_runtime.h>

#define TILE_LOG2 12
#define TILE (1 << TILE_LOG2)
#define TILE_THREADS 1024

typedef unsigned long long u64;

// Runs stages k_lo..k_hi of the network on one tile in shared memory,
// each from distance min(2^(k-1), tile/2) down to 1.  in may equal out.
__global__ void bitonic_tile(const u64* in, u64* out, int tile_log2, int k_lo,
                             int k_hi) {
  __shared__ u64 s[TILE];
  const int tile = 1 << tile_log2;
  const long long base = (long long)blockIdx.x << tile_log2;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) s[t] = in[base + t];
  __syncthreads();
  for (int k = k_lo; k <= k_hi; ++k) {
    int d = 1 << (k - 1);
    if (d > tile / 2) d = tile / 2;
    for (; d >= 1; d >>= 1) {
      for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
        const int i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
        const int j = i | d;
        const bool asc = (((base + i) >> k) & 1) == 0;
        const u64 a = s[i], b = s[j];
        if ((a > b) == asc) {
          s[i] = b;
          s[j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x) out[base + t] = s[t];
}

// One substage of stage k at distance d >= a tile: pair p is the index
// pair (i, i + d) with bit d of i clear.
__global__ void bitonic_global(u64* x, long long half, int k, long long d) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= half) return;
  const long long i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
  const long long j = i | d;
  const bool asc = ((i >> k) & 1) == 0;
  const u64 a = x[i], b = x[j];
  if ((a > b) == asc) {
    x[i] = b;
    x[j] = a;
  }
}

// in, out: n words, n a power of two; in is left untouched.  Returns the
// CUDA error code (0 = launched).
extern "C" int srt_bitonic_sort(const void* in, void* out, long long n,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  int log2n = 0;
  while ((1LL << log2n) < n) ++log2n;
  const int tile_log2 = log2n < TILE_LOG2 ? log2n : TILE_LOG2;
  const unsigned nblocks = (unsigned)(n >> tile_log2);
  int threads = (1 << tile_log2) / 2;
  if (threads < 1) threads = 1;
  if (threads > TILE_THREADS) threads = TILE_THREADS;
  bitonic_tile<<<nblocks, threads, 0, s>>>((const u64*)in, (u64*)out,
                                           tile_log2, 1, tile_log2);
  const long long half = n / 2;
  const unsigned gblocks = (unsigned)((half + 255) / 256);
  for (int k = tile_log2 + 1; k <= log2n; ++k) {
    for (long long d = 1LL << (k - 1); d >= (1LL << tile_log2); d >>= 1)
      bitonic_global<<<gblocks, 256, 0, s>>>((u64*)out, half, k, d);
    bitonic_tile<<<nblocks, threads, 0, s>>>((const u64*)out, (u64*)out,
                                             tile_log2, k, k);
  }
  return (int)cudaGetLastError();
}
