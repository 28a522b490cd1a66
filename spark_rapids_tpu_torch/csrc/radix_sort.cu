// K3: ascending sort of n 64-bit words compared as unsigned, n a power of
// two, given the caller's promise about which bits need sorting.
//
// Replaces the TPU kernel spark_rapids_tpu/ops/pallas_kernels.py:262
// bitonic_sort_u64, a bitonic network.  On this card a network over 2^26
// words streams the whole array through device memory once per cross-tile
// substage, O(n log^2 n) bytes; this is an LSD radix sort instead, O(n)
// bytes a digit (Adinets & Merrill, "Onesweep", 2022).
//
// bits = [lo, hi) is the caller's promise: all words agree on bits >= hi,
// and words that agree on bits >= lo already come in ascending order of
// bits < lo.  A stable sort on bits [lo, hi) alone then gives the full
// sort.  The packed argsort builds every word as (key << r) | row id, so it
// sorts only its key bits [r, r + key width).
//
// Two routes:
//   * n <= 4096: one `bitonic_tile` launch sorts all 64 bits in shared
//     memory (launch-bound; the order-bys' 1024-word sorts take it);
//   * n > 4096: one `radix_histogram` launch reads the words once and
//     counts every 8-bit digit of [lo, hi) at once; then one `radix_pass`
//     launch a digit, ping-ponging between `out` and a scratch buffer.
//     A pass block claims its tile from an atomic counter (blocks start in
//     no order, and a look-back that waited on a block not yet resident
//     would deadlock), ranks its 4096 words stably by digit with warp
//     `__match_any_sync` and shared per-warp counters, publishes its 256
//     digit counts and finds the counts of all earlier tiles by decoupled
//     look-back over one 32-bit status word per (tile, digit): a 2-bit
//     flag (aggregate / inclusive) and a 30-bit count in one word, so one
//     relaxed store or load needs no fence.  It then scatters the tile
//     through shared memory, so each digit's run is written contiguously.
// Bound on this card: bytes.  The function must read and write each word
// once, 16 B a word; this design moves 8 B (histogram) + 16 B a digit,
// 88 B a word for five digits.  (K2's look-back keeps a 64-bit value apart
// from its flag, so the two kernels do not share a look-back.)
#include <cuda_runtime.h>
#include <cuda/atomic>

typedef unsigned long long u64;

#define FULL_MASK 0xffffffffu

// ---- tile route: bitonic network in shared memory ------------------------

#define TILE_LOG2 12
#define TILE (1 << TILE_LOG2)
#define TILE_THREADS 1024

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

// ---- radix route ----------------------------------------------------------

#define RADIX_BITS 8
#define RADIX (1 << RADIX_BITS)
#define RS_THREADS 256  // one thread per digit in the look-back
#define RS_WARPS (RS_THREADS / 32)
#define RS_ITEMS 16
#define RS_TILE (RS_THREADS * RS_ITEMS)  // 4096 words, 32 KB
#define MAX_PASSES 8
#define HIST_BLOCKS 1024
static_assert(RS_THREADS == RADIX, "one look-back thread per digit");
static_assert(RS_TILE == TILE, "the radix route starts above the tile");

// status word of one (tile, digit): flag in bits 31:30, count below
#define ST_AGG (1u << 30)
#define ST_INC (2u << 30)
#define ST_COUNT (ST_AGG - 1)

__device__ __forceinline__ unsigned digit_of(u64 k, int shift,
                                             unsigned mask) {
  return (unsigned)(k >> shift) & mask;
}

__device__ __forceinline__ unsigned status_load(unsigned* p) {
  return cuda::atomic_ref<unsigned, cuda::thread_scope_device>(*p).load(
      cuda::memory_order_relaxed);
}

__device__ __forceinline__ void status_store(unsigned* p, unsigned v) {
  cuda::atomic_ref<unsigned, cuda::thread_scope_device>(*p).store(
      v, cuda::memory_order_relaxed);
}

// Exclusive sum of one value per thread over the block; `tmp` holds
// RS_WARPS entries.  Ends with a barrier, so `tmp` may be reused at once.
__device__ unsigned block_exclusive_sum(unsigned v, unsigned* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned o = __shfl_up_sync(FULL_MASK, x, d);
    if (lane >= d) x += o;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  unsigned before = 0;
  for (int w = 0; w < warp; ++w) before += tmp[w];
  __syncthreads();
  return before + x - v;
}

// Counts of every digit of every pass: hist[p * RADIX + d], added to.
__global__ void __launch_bounds__(RS_THREADS)
    radix_histogram(const u64* __restrict__ in, long long n, int lo, int hi,
                    int passes, unsigned* __restrict__ hist) {
  __shared__ unsigned s[MAX_PASSES * RADIX];
  for (int i = threadIdx.x; i < passes * RADIX; i += blockDim.x) s[i] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const u64 k = in[i];
    for (int p = 0; p < passes; ++p) {
      const int shift = lo + p * RADIX_BITS;
      const int w = hi - shift < RADIX_BITS ? hi - shift : RADIX_BITS;
      atomicAdd(&s[p * RADIX + digit_of(k, shift, (1u << w) - 1)], 1u);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * RADIX; i += blockDim.x)
    if (s[i]) atomicAdd(&hist[i], s[i]);
}

// One stable pass on the digit (k >> shift) & mask, src -> dst; `hist` is
// this pass's 256 digit counts over all n words, `status` holds one zeroed
// word per (tile, digit), `tile_counter` a zeroed counter.
__global__ void __launch_bounds__(RS_THREADS)
    radix_pass(const u64* __restrict__ src, u64* __restrict__ dst,
               const unsigned* __restrict__ hist, unsigned* status,
               unsigned* tile_counter, int shift, unsigned mask) {
  __shared__ u64 s_keys[RS_TILE];
  __shared__ unsigned s_whist[RS_WARPS][RADIX];
  __shared__ unsigned s_dstart[RADIX];
  __shared__ long long s_gofs[RADIX];
  __shared__ unsigned s_tmp[RS_WARPS];
  __shared__ unsigned s_tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(tile_counter, 1u);
#pragma unroll
  for (int w = 0; w < RS_WARPS; ++w) s_whist[w][tid] = 0;
  __syncthreads();
  const unsigned tile = s_tile;

  // each warp takes 512 consecutive words, item i of lane l being word
  // i * 32 + l: coalesced loads, and (i, lane) order is input order
  const long long base =
      (long long)tile * RS_TILE + (long long)warp * (32 * RS_ITEMS);
  u64 keys[RS_ITEMS];
  unsigned rank[RS_ITEMS];
#pragma unroll
  for (int i = 0; i < RS_ITEMS; ++i) keys[i] = src[base + i * 32 + lane];

  // stable rank within the warp: earlier items, then lower lanes, first
#pragma unroll
  for (int i = 0; i < RS_ITEMS; ++i) {
    const unsigned d = digit_of(keys[i], shift, mask);
    const unsigned peers = __match_any_sync(FULL_MASK, d);
    const unsigned before = s_whist[warp][d];
    __syncwarp();
    if (lane == __ffs(peers) - 1) s_whist[warp][d] = before + __popc(peers);
    __syncwarp();
    rank[i] = before + __popc(peers & ((1u << lane) - 1));
  }
  __syncthreads();

  // thread tid owns digit tid: per-warp starts within the digit, and the
  // tile's count of it
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < RS_WARPS; ++w) {
    const unsigned c = s_whist[w][tid];
    s_whist[w][tid] = count;
    count += c;
  }
  unsigned* mine = status + (size_t)tile * RADIX + tid;
  status_store(mine, (tile == 0 ? ST_INC : ST_AGG) | count);

  const unsigned dstart = block_exclusive_sum(count, s_tmp);
  const unsigned hbase = block_exclusive_sum(hist[tid], s_tmp);
  s_dstart[tid] = dstart;

  // decoupled look-back: the digit's count in all earlier tiles
  unsigned excl = 0;
  if (tile > 0) {
    long long j = (long long)tile - 1;
    for (;;) {
      unsigned st;
      do {
        st = status_load(status + (size_t)j * RADIX + tid);
      } while (st == 0);
      excl += st & ST_COUNT;
      if (st & ST_INC) break;
      --j;
    }
    status_store(mine, ST_INC | (excl + count));
  }
  // word at position p of the digit-ordered tile goes to s_gofs[d] + p
  s_gofs[tid] = (long long)hbase + excl - dstart;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RS_ITEMS; ++i) {
    const unsigned d = digit_of(keys[i], shift, mask);
    s_keys[s_dstart[d] + s_whist[warp][d] + rank[i]] = keys[i];
  }
  __syncthreads();
  for (int p = tid; p < RS_TILE; p += RS_THREADS) {
    const u64 k = s_keys[p];
    dst[s_gofs[digit_of(k, shift, mask)] + p] = k;
  }
}

static long long align256(long long x) { return (x + 255) & ~255LL; }

static int digit_passes(int lo, int hi) {
  return (hi - lo + RADIX_BITS - 1) / RADIX_BITS;
}

// Scratch the radix route needs for n words sorted on bits [lo, hi):
// a ping-pong buffer of n words, the digit counts of every pass, one tile
// counter a pass, and one status word per (tile, digit).  0 for the tile
// route.
extern "C" long long srt_radix_scratch_bytes(long long n, int lo, int hi) {
  if (n <= TILE || hi <= lo) return 0;
  const int passes = digit_passes(lo, hi);
  const long long ntiles = (n + RS_TILE - 1) / RS_TILE;
  return align256(n * 8) + align256(passes * RADIX * 4) +
         align256(passes * 4) + ntiles * RADIX * 4;
}

// in, out: n words, n a power of two <= 2^29; in is left untouched;
// scratch: srt_radix_scratch_bytes(n, lo, hi) bytes.  Returns the CUDA
// error code (0 = launched).
extern "C" int srt_radix_sort(const void* in, void* out, void* scratch,
                              long long n, int lo, int hi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || (n & (n - 1)) || n > (1LL << 29) || lo < 0 || lo > hi ||
      hi > 64)
    return (int)cudaErrorInvalidValue;
  if (n <= TILE) {
    int log2n = 0;
    while ((1LL << log2n) < n) ++log2n;
    int threads = n / 2 < 1 ? 1 : (int)(n / 2);
    if (threads > TILE_THREADS) threads = TILE_THREADS;
    bitonic_tile<<<1, threads, 0, s>>>((const u64*)in, (u64*)out, log2n, 1,
                                       log2n);
    return (int)cudaGetLastError();
  }
  if (hi == lo)
    return (int)cudaMemcpyAsync(out, in, n * 8, cudaMemcpyDeviceToDevice, s);
  const int passes = digit_passes(lo, hi);
  const long long ntiles = n / RS_TILE;
  char* p = (char*)scratch;
  u64* tmp = (u64*)p;
  p += align256(n * 8);
  unsigned* hist = (unsigned*)p;
  p += align256(passes * RADIX * 4);
  unsigned* counters = (unsigned*)p;
  p += align256(passes * 4);
  unsigned* status = (unsigned*)p;

  cudaError_t e = cudaMemsetAsync(
      hist, 0, align256(passes * RADIX * 4) + passes * 4, s);
  if (e != cudaSuccess) return (int)e;
  radix_histogram<<<(unsigned)(ntiles < HIST_BLOCKS ? ntiles : HIST_BLOCKS),
                    RS_THREADS, 0, s>>>((const u64*)in, n, lo, hi, passes,
                                        hist);
  const u64* src = (const u64*)in;
  for (int pass = 0; pass < passes; ++pass) {
    // the last pass writes `out`
    u64* dst = ((passes - pass) & 1) ? (u64*)out : tmp;
    e = cudaMemsetAsync(status, 0, ntiles * RADIX * 4, s);
    if (e != cudaSuccess) return (int)e;
    const int shift = lo + pass * RADIX_BITS;
    const int w = hi - shift < RADIX_BITS ? hi - shift : RADIX_BITS;
    radix_pass<<<(unsigned)ntiles, RS_THREADS, 0, s>>>(
        src, dst, hist + pass * RADIX, status, counters + pass, shift,
        (1u << w) - 1);
    src = dst;
  }
  return (int)cudaGetLastError();
}
