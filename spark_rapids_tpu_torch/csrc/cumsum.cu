// K2: inclusive prefix sum of an int32 or int64 column, wrapping modulo
// 2^bits.
//
// Replaces the TPU kernel spark_rapids_tpu/ops/pallas_kernels.py:63
// cumsum_1d (kernel body _cumsum_kernel), which walks (8, 128) tiles in
// grid order and threads the running total through an SMEM scalar.  CUDA
// blocks run in no order, so that carry does not translate; this is one
// launch with decoupled look-back instead (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016):
//   * a block claims its tile of 5120 rows from an atomic counter (blocks
//     start in no order; a look-back that waited on a tile no block holds
//     yet would deadlock), loads it with coalesced 16-byte loads marked
//     streaming (each byte is read once), transposes it through shared
//     memory and scans 20 rows a thread;
//   * it publishes its aggregate, then one warp looks back over the
//     preceding tiles 32 at a time, summing aggregates up to the nearest
//     inclusive prefix, and publishes its own inclusive prefix;
//   * a 64-bit value cannot share a word with its flag, so flag and value
//     live apart: the writer stores the value, then the flag (release);
//     the reader loads the flag (acquire), then the value.  Aggregate and
//     inclusive prefix have a slot each, so a reader never sees one
//     overwritten by the other.
// Sums are taken in the unsigned type of the same width, so they wrap
// exactly as torch.cumsum does.  Bound on this card: bytes.  The function
// must read n and write n elements (16 B a row at int64); this design
// reads the input once and writes the output once, plus 20 B of status a
// tile.  On the H100 it still trails torch.cumsum at int64 by a few
// percent (PERF.md); the tile's round trip through shared memory and the
// look-back's wait are what a later change can shorten.
#include <cuda_runtime.h>
#include <cuda/atomic>

#define CS_THREADS 256
#define CS_ITEMS 20
#define CS_TILE (CS_THREADS * CS_ITEMS)
#define CS_WARPS (CS_THREADS / 32)
static_assert(CS_ITEMS % 4 == 0, "whole 16-byte vectors a thread");
#define FULL_MASK 0xffffffffu
#define FLAG_AGG 1u
#define FLAG_INC 2u

typedef cuda::atomic_ref<unsigned, cuda::thread_scope_device> flag_ref;

template <typename U>
__device__ __forceinline__ U value_load(U* p) {
  return cuda::atomic_ref<U, cuda::thread_scope_device>(*p).load(
      cuda::memory_order_relaxed);
}

template <typename U>
__device__ __forceinline__ void publish(unsigned* flag, U* slot, U v,
                                        unsigned f) {
  cuda::atomic_ref<U, cuda::thread_scope_device>(*slot).store(
      v, cuda::memory_order_relaxed);
  flag_ref(*flag).store(f, cuda::memory_order_release);
}

// Position of row p of a tile in the padded blocked layout: thread t's 20
// rows sit at t * 21 + i, so each thread's walk over its own rows is free
// of bank conflicts.
__device__ __forceinline__ int padded(int p) {
  return (p / CS_ITEMS) * (CS_ITEMS + 1) + p % CS_ITEMS;
}

// U: unsigned int or unsigned long long.  flags: one zeroed word per
// tile; aggs, incs: one value per tile; counter: a zeroed tile counter.
template <typename U>
__global__ void __launch_bounds__(CS_THREADS)
    cumsum_onepass(const U* __restrict__ x, U* __restrict__ out, long long n,
                   unsigned* counter, unsigned* flags, U* aggs, U* incs) {
  __shared__ U s[CS_THREADS * (CS_ITEMS + 1)];
  __shared__ U s_warp[CS_WARPS];
  __shared__ U s_excl;
  __shared__ unsigned s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(counter, 1u);
  __syncthreads();
  const unsigned tile = s_tile;
  const long long base = (long long)tile * CS_TILE;

  // a whole, aligned tile moves as 16-byte vectors; the last tile (and a
  // column that starts off a 16-byte boundary) row by row
  constexpr int VEC = 16 / sizeof(U);
  const bool full = base + CS_TILE <= n &&
                    ((unsigned long long)(x + base) & 15) == 0 &&
                    ((unsigned long long)(out + base) & 15) == 0;
  if (full) {
    const uint4* xv = (const uint4*)(x + base);
#pragma unroll
    for (int i = 0; i < CS_ITEMS / VEC; ++i) {
      const int q = i * CS_THREADS + tid;
      const uint4 w = __ldcs(xv + q);
      const U* e = (const U*)&w;
#pragma unroll
      for (int k = 0; k < VEC; ++k) s[padded(q * VEC + k)] = e[k];
    }
  } else {
#pragma unroll
    for (int i = 0; i < CS_ITEMS; ++i) {
      const int p = i * CS_THREADS + tid;
      s[padded(p)] = base + p < n ? x[base + p] : U(0);
    }
  }
  __syncthreads();

  U* row = s + tid * (CS_ITEMS + 1);
  U run = 0;
#pragma unroll
  for (int i = 0; i < CS_ITEMS; ++i) run += row[i];
  // block scan of the thread totals
  U incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const U o = __shfl_up_sync(FULL_MASK, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  U before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < CS_WARPS; ++w) {
    const U t = s_warp[w];
    if (w < warp) before += t;
    total += t;
  }
  before += incl - run;

  if (warp == 0) {
    U excl = 0;
    if (tile == 0) {
      if (lane == 0) publish(&flags[0], &incs[0], total, FLAG_INC);
    } else {
      if (lane == 0) publish(&flags[tile], &aggs[tile], total, FLAG_AGG);
      long long j = (long long)tile - 1 - lane;
      for (;;) {
        unsigned f = FLAG_INC;  // lanes before tile 0 add nothing
        U val = 0;
        if (j >= 0) {
          do {
            f = flag_ref(flags[j]).load(cuda::memory_order_acquire);
          } while (f == 0);
          val = value_load(f == FLAG_INC ? &incs[j] : &aggs[j]);
        }
        const unsigned inc_lanes = __ballot_sync(FULL_MASK, f == FLAG_INC);
        // lane k holds tile (tile - 1 - k) of this window: sum up to the
        // nearest inclusive prefix
        const int stop = inc_lanes ? __ffs(inc_lanes) - 1 : 31;
        U part = lane <= stop ? val : U(0);
#pragma unroll
        for (int d = 16; d >= 1; d >>= 1)
          part += __shfl_xor_sync(FULL_MASK, part, d);
        excl += part;
        if (inc_lanes) break;
        j -= 32;
      }
      if (lane == 0) publish(&flags[tile], &incs[tile], excl + total,
                             FLAG_INC);
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();

  // each thread rescans its rows from shared memory with its prefix
  U acc = s_excl + before;
#pragma unroll
  for (int i = 0; i < CS_ITEMS; ++i) {
    acc += row[i];
    row[i] = acc;
  }
  __syncthreads();
  if (full) {
    uint4* ov = (uint4*)(out + base);
#pragma unroll
    for (int i = 0; i < CS_ITEMS / VEC; ++i) {
      const int q = i * CS_THREADS + tid;
      uint4 w;
      U* e = (U*)&w;
#pragma unroll
      for (int k = 0; k < VEC; ++k) e[k] = s[padded(q * VEC + k)];
      __stcs(ov + q, w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < CS_ITEMS; ++i) {
      const int p = i * CS_THREADS + tid;
      if (base + p < n) out[base + p] = s[padded(p)];
    }
  }
}

static long long align256(long long x) { return (x + 255) & ~255LL; }

// Scratch for n elements of `elem_bytes`: the tile counter, one flag per
// tile (both zeroed at each launch), then an aggregate and an inclusive
// prefix per tile.
extern "C" long long srt_cumsum_scratch_bytes(long long n, int elem_bytes) {
  const long long ntiles = (n + CS_TILE - 1) / CS_TILE;
  return align256(4) + align256(ntiles * 4) + 2 * ntiles * elem_bytes;
}

template <typename U>
static int launch(const void* x, void* out, void* scratch, long long n,
                  cudaStream_t s) {
  const long long ntiles = (n + CS_TILE - 1) / CS_TILE;
  char* p = (char*)scratch;
  unsigned* counter = (unsigned*)p;
  unsigned* flags = (unsigned*)(p + align256(4));
  U* aggs = (U*)(p + align256(4) + align256(ntiles * 4));
  U* incs = aggs + ntiles;
  const cudaError_t e =
      cudaMemsetAsync(p, 0, align256(4) + ntiles * 4, s);
  if (e != cudaSuccess) return (int)e;
  cumsum_onepass<U><<<(unsigned)ntiles, CS_THREADS, 0, s>>>(
      (const U*)x, (U*)out, n, counter, flags, aggs, incs);
  return (int)cudaGetLastError();
}

// x, out: n elements of `elem_bytes` (4: int32, 8: int64); scratch:
// srt_cumsum_scratch_bytes(n, elem_bytes) bytes.  Returns the CUDA error
// code (0 = launched).
extern "C" int srt_cumsum(const void* x, void* out, void* scratch,
                          long long n, int elem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (elem_bytes == 4) return launch<unsigned>(x, out, scratch, n, s);
  if (elem_bytes == 8)
    return launch<unsigned long long>(x, out, scratch, n, s);
  return (int)cudaErrorInvalidValue;
}
