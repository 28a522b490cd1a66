// K1: segmented inclusive running sum, min or max of up to SS_MAX_COLS
// value columns over one column of ascending group ids; the running value
// restarts wherever the id changes, so a segment's last row holds that
// segment's reduction.  Columns may mix int32, int64, float32 and float64
// and each names its own op.
//
// Replaces the TPU kernel spark_rapids_tpu/ops/pallas_kernels.py:151
// seg_agg_1d (kernel body _make_seg_agg_kernel), which walks (8, 128)
// tiles in grid order, reads gid once for all the columns of a request
// set, and carries (last gid, running value per column) in SMEM from one
// grid step to the next.  CUDA blocks run in no order, so that carry does
// not translate; this is one launch with segmented decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016), as csrc/cumsum.cu does for the plain prefix sum:
//   * a block claims its tile of 4096 rows from an atomic counter (blocks
//     start in no order; a look-back that waited on a tile no block holds
//     yet would deadlock), loads the tile's gid once with coalesced
//     16-byte streaming loads, transposes it through shared memory, and
//     keeps of each thread's 16 rows only the first and last gid and a
//     bit mask of where its runs start;
//   * then, one column at a time, it loads the column the same way,
//     scans 16 rows a thread sequentially and the 256 thread totals with
//     warp shuffles, and publishes the tile's aggregate: the running value
//     of its last run.  A tile whose last run begins inside it (first gid
//     != last gid) publishes that value at once as its inclusive prefix;
//   * warp 0 looks back over the preceding tiles 32 at a time and folds a
//     predecessor's value into the tile's leading run only while the
//     predecessor's last gid equals the tile's first gid; it stops at the
//     first inclusive prefix or the first other gid.  With a few rows a
//     group that is the first predecessor; a run that spans many tiles
//     walks their aggregates until an inclusive prefix is found, in the
//     same pass.  A tile that is one run then publishes its inclusive
//     prefix;
//   * the carry is folded into the leading run's rows in shared memory and
//     the column is stored with 16-byte streaming stores.
// Each column has its own status (flag, aggregate, inclusive prefix) per
// tile, and the tile's last gid is written once, before its first flag.
// A single flag for all columns would need every column's tile held on
// chip until the look-back ends (k * 32 KB at 8-byte values); per-column
// flags let each column be loaded, scanned and stored in turn from one
// 35 KB buffer.  Flag and value live apart (a 64-bit value cannot share a
// word with its flag): the writer stores the values, then the flag
// (release); the reader loads the flag (acquire), then the values.
// Aggregate and inclusive prefix have a slot each, so a reader never sees
// one overwritten by the other.
//
// Occupancy is what the phases of a tile (load, scan, look-back, store)
// need to overlap: 16 rows a thread keep every shared-memory address of a
// thread's loads and stores one base plus a constant (at 20 rows a thread
// the compiler held those addresses in registers, one block an SM), and
// the launch bounds ask for 3 blocks an SM.
//
// Integer sums are taken in the unsigned type of the same width, so they
// wrap modulo 2^bits exactly as the plain PyTorch version does; min and
// max propagate NaN like torch.minimum/torch.maximum (CUDA's fmin and fmax
// drop it, so they are not used); a float sum restarts at every boundary,
// so it sums only its segment's own rows.
//
// Bound on this card: bytes.  The function must read gid and each value
// column once and write each output once: n * (4 + sum of 2 * size_i)
// bytes (20 a row for one 8-byte column).  This design moves exactly
// that, plus 4 + 20 * k bytes of status a tile.  It reaches about 60% of
// that bound on the H100 (PERF.md).
#include <cuda_runtime.h>
#include <cuda/atomic>
#include <cuda/std/limits>
#include <cstring>

#define SS_THREADS 256
#define SS_ITEMS 16
#define SS_MIN_BLOCKS 3
#define SS_TILE (SS_THREADS * SS_ITEMS)
#define SS_WARPS (SS_THREADS / 32)
#define SS_MAX_COLS 8
static_assert(SS_THREADS % SS_ITEMS == 0, "row by row: whole rows a step");
#define FULL_MASK 0xffffffffu
#define FLAG_AGG 1u
#define FLAG_INC 2u

typedef unsigned long long u64;
typedef cuda::atomic_ref<unsigned, cuda::thread_scope_device> flag_ref;

// ---- element arithmetic ----------------------------------------------------

template <typename T> struct Unsigned { typedef T type; };
template <> struct Unsigned<int> { typedef unsigned int type; };
template <> struct Unsigned<long long> { typedef unsigned long long type; };

template <typename T> __device__ __forceinline__ bool is_nan(T) {
  return false;
}
template <> __device__ __forceinline__ bool is_nan(float x) { return x != x; }
template <> __device__ __forceinline__ bool is_nan(double x) { return x != x; }

template <typename T> using limits = cuda::std::numeric_limits<T>;

// apply(earlier, later); identity() folds into anything unchanged (-0.0
// for a float sum, so a segment of -0.0 keeps its sign)
struct OpSum {
  template <typename T> __device__ __forceinline__ static T apply(T a, T b) {
    typedef typename Unsigned<T>::type U;
    return (T)((U)a + (U)b);
  }
  template <typename T> __device__ __forceinline__ static T identity() {
    return (T)-0.0;
  }
};
struct OpMin {
  template <typename T> __device__ __forceinline__ static T apply(T a, T b) {
    if (is_nan(a)) return a;
    if (is_nan(b)) return b;
    return b < a ? b : a;
  }
  template <typename T> __device__ __forceinline__ static T identity() {
    return limits<T>::has_infinity ? limits<T>::infinity() : limits<T>::max();
  }
};
struct OpMax {
  template <typename T> __device__ __forceinline__ static T apply(T a, T b) {
    if (is_nan(a)) return a;
    if (is_nan(b)) return b;
    return b > a ? b : a;
  }
  template <typename T> __device__ __forceinline__ static T identity() {
    return limits<T>::has_infinity ? -limits<T>::infinity()
                                   : limits<T>::lowest();
  }
};

template <typename T> __device__ __forceinline__ u64 to_bits(T v) {
  u64 b = 0;
  memcpy(&b, &v, sizeof(T));
  return b;
}
template <typename T> __device__ __forceinline__ T from_bits(u64 b) {
  T v;
  memcpy(&v, &b, sizeof(T));
  return v;
}

// ---- status ----------------------------------------------------------------

template <typename U>
__device__ __forceinline__ U relaxed_load(const U* p) {
  return cuda::atomic_ref<U, cuda::thread_scope_device>(*const_cast<U*>(p))
      .load(cuda::memory_order_relaxed);
}

template <typename U>
__device__ __forceinline__ void relaxed_store(U* p, U v) {
  cuda::atomic_ref<U, cuda::thread_scope_device>(*p).store(
      v, cuda::memory_order_relaxed);
}

__device__ __forceinline__ void publish(unsigned* flag, u64* slot, u64 v,
                                        unsigned f) {
  relaxed_store(slot, v);
  flag_ref(*flag).store(f, cuda::memory_order_release);
}

// One column's status: a flag (zeroed at each launch), an aggregate and an
// inclusive prefix per tile.  last_gid, shared by every column, is written
// by the thread that then stores the tile's first flag.
struct Status {
  unsigned* flags;
  u64* aggs;
  u64* incs;
  const int* last_gid;
};

// ---- tiles -----------------------------------------------------------------

// Row p of a tile sits at p + p / SS_ITEMS in shared memory: thread t's
// 16 rows at t * 17 + i, so each thread's walk over its own rows is free
// of bank conflicts.  A vector step covers 512 (8-byte) or 1024 (4-byte)
// rows, whole thread rows, so every address of a thread's loads and
// stores is one base plus a constant.
template <typename T> struct Layout {
  static constexpr int VEC = 16 / sizeof(T);           // rows a vector
  static constexpr int STEP = SS_THREADS * VEC;         // rows a step
  static constexpr int PSTEP = STEP + STEP / SS_ITEMS;  // padded
  static_assert(STEP % SS_ITEMS == 0 && SS_ITEMS % VEC == 0,
                "a vector step is whole thread rows");
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((unsigned long long)p & 15) == 0;
}

// The tile's rows into shared memory: 16-byte vectors when `vec` (a whole
// tile, aligned), else row by row, rows past n repeating row n - 1 (they
// extend the last run and are never stored).
template <typename T>
__device__ __forceinline__ void load_tile(const T* x, long long base,
                                          long long n, bool vec, T* s) {
  typedef Layout<T> L;
  const int tid = threadIdx.x;
  if (vec) {
    const uint4* xv = (const uint4*)(x + base) + tid;
    T* d = s + tid * L::VEC + tid * L::VEC / SS_ITEMS;
#pragma unroll
    for (int i = 0; i < SS_ITEMS / L::VEC; ++i) {
      const uint4 w = __ldcs(xv + i * SS_THREADS);
      const T* e = (const T*)&w;
#pragma unroll
      for (int j = 0; j < L::VEC; ++j) d[i * L::PSTEP + j] = e[j];
    }
  } else {
    T* d = s + tid + tid / SS_ITEMS;
#pragma unroll
    for (int i = 0; i < SS_ITEMS; ++i) {
      const long long p = base + i * SS_THREADS + tid;
      d[i * (SS_THREADS + SS_THREADS / SS_ITEMS)] = x[p < n ? p : n - 1];
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(T* out, long long base,
                                           long long n, bool vec,
                                           const T* s) {
  typedef Layout<T> L;
  const int tid = threadIdx.x;
  if (vec) {
    uint4* ov = (uint4*)(out + base) + tid;
    const T* d = s + tid * L::VEC + tid * L::VEC / SS_ITEMS;
#pragma unroll
    for (int i = 0; i < SS_ITEMS / L::VEC; ++i) {
      uint4 w;
      T* e = (T*)&w;
#pragma unroll
      for (int j = 0; j < L::VEC; ++j) e[j] = d[i * L::PSTEP + j];
      __stcs(ov + i * SS_THREADS, w);
    }
  } else {
    const T* d = s + tid + tid / SS_ITEMS;
#pragma unroll
    for (int i = 0; i < SS_ITEMS; ++i) {
      const long long p = base + i * SS_THREADS + tid;
      if (p < n) out[p] = d[i * (SS_THREADS + SS_THREADS / SS_ITEMS)];
    }
  }
}

// ---- segmented scan --------------------------------------------------------
// An element is (g, v).  combine(earlier, later) = later.v folded with
// earlier.v when both carry the same g, else later unchanged.  With equal
// g values contiguous (sorted ids) this is associative, so any scan tree
// gives each row the reduction of its segment's rows up to it.

template <typename Op, typename T>
__device__ __forceinline__ void warp_seg_scan(int g, T& v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int go = __shfl_up_sync(FULL_MASK, g, d);
    const T vo = __shfl_up_sync(FULL_MASK, v, d);
    if (lane >= d && go == g) v = Op::apply(vo, v);
  }
}

struct Shared {
  u64 buf[SS_THREADS * (SS_ITEMS + 1)];  // one column's tile, or gid's
  u64 tail_v[SS_WARPS];
  int tail_g[SS_WARPS];
  u64 agg, carry;
  int have_carry;
  unsigned tile;
  int first, last;
};

// Warp 0: folds into `carry` (the identity on entry) the values that the
// tiles before this one carry into its leading run.  Returns whether any
// predecessor contributed.
template <typename Op, typename T>
__device__ __forceinline__ bool look_back(const Status& st, long long tile,
                                          int first, T& carry) {
  const int lane = threadIdx.x & 31;
  const T id = Op::template identity<T>();
  bool have = false;
  long long j = tile - 1 - lane;
  for (;;) {
    unsigned f = FLAG_INC;
    bool same = false;
    T val = id;
    if (j >= 0) {
      do {
        f = flag_ref(st.flags[j]).load(cuda::memory_order_acquire);
      } while (f == 0);
      same = relaxed_load(&st.last_gid[j]) == first;
      if (same)
        val = from_bits<T>(relaxed_load(f == FLAG_INC ? &st.incs[j]
                                                      : &st.aggs[j]));
    }
    // lane i holds tile (tile - 1 - i) of this window: fold up to the
    // first inclusive prefix or the first tile that ends on another gid
    const unsigned stops = __ballot_sync(FULL_MASK, !same || f == FLAG_INC);
    const int stop = stops ? __ffs(stops) - 1 : 31;
    if (lane > stop) val = id;
    have = have || __any_sync(FULL_MASK, same && lane <= stop);
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1)
      val = Op::apply(val, __shfl_xor_sync(FULL_MASK, val, d));
    carry = Op::apply(val, carry);  // val covers the earlier tiles
    if (stops) break;
    j -= 32;
  }
  return have;
}

// A thread's 16 rows as its scans need them: the gids of its first and
// last row, and bit i set where row i starts a new run (i >= 1).
struct Rows {
  int first, last;
  unsigned starts;
};

// One column of the block's tile: load, scan, publish, look back, fold the
// carry, store.
template <typename T, typename Op>
__device__ __forceinline__ void scan_column(const T* __restrict__ x,
                                            T* __restrict__ out,
                                            const Rows& r, const Status& st,
                                            long long base, long long n,
                                            bool full, Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tile = sh.tile;
  const int first = sh.first, last = sh.last;
  T* s = (T*)sh.buf;
  T* tail_v = (T*)sh.tail_v;
  const bool vec = full && aligned16(x + base) && aligned16(out + base);
  load_tile(x, base, n, vec, s);
  __syncthreads();

  // each thread's 16 rows in order
  T* row = s + tid * (SS_ITEMS + 1);
  T acc = row[0];
#pragma unroll
  for (int i = 1; i < SS_ITEMS; ++i) {
    const T xi = row[i];
    acc = (r.starts >> i) & 1 ? xi : Op::apply(acc, xi);
    row[i] = acc;
  }

  // the thread totals across the block: each thread's inclusive value,
  // and the exclusive one that its leading run continues
  int tg = r.last;
  T tv = acc;
  warp_seg_scan<Op>(tg, tv, lane);
  if (lane == 31) {
    sh.tail_g[warp] = tg;
    tail_v[warp] = tv;
  }
  __syncthreads();
  bool wp_have = false;
  int wpg = 0;
  T wpv = T(0);
#pragma unroll
  for (int w = 0; w < SS_WARPS - 1; ++w) {
    if (w < warp) {
      const int gw = sh.tail_g[w];
      const T vw = tail_v[w];
      wpv = wp_have && gw == wpg ? Op::apply(wpv, vw) : vw;
      wpg = gw;
      wp_have = true;
    }
  }
  if (wp_have && wpg == tg) tv = Op::apply(wpv, tv);
  int eg = __shfl_up_sync(FULL_MASK, tg, 1);
  T pre = __shfl_up_sync(FULL_MASK, tv, 1);
  bool pre_have = lane > 0;
  if (lane == 0) {
    eg = wpg;
    pre = wpv;
    pre_have = wp_have;
  }
  pre_have = pre_have && eg == r.first;
  if (tid == SS_THREADS - 1) sh.agg = to_bits(tv);
  __syncthreads();

  // publish, then look back (warp 0)
  if (warp == 0) {
    const T agg = from_bits<T>(sh.agg);
    const bool inc_now = tile == 0 || first != last;
    if (lane == 0)
      publish(&st.flags[tile], inc_now ? &st.incs[tile] : &st.aggs[tile],
              to_bits(agg), inc_now ? FLAG_INC : FLAG_AGG);
    T carry = Op::template identity<T>();
    bool have = false;
    if (tile > 0) have = look_back<Op>(st, tile, first, carry);
    if (lane == 0) {
      if (!inc_now)
        publish(&st.flags[tile], &st.incs[tile],
                to_bits(have ? Op::apply(carry, agg) : agg), FLAG_INC);
      sh.carry = to_bits(carry);
      sh.have_carry = have;
    }
  }
  __syncthreads();

  // fold the carries into each thread's leading run (its rows before the
  // first run start), then store
  if (sh.have_carry && r.first == first) {
    const T carry = from_bits<T>(sh.carry);
    pre = pre_have ? Op::apply(carry, pre) : carry;
    pre_have = true;
  }
  if (pre_have) {
    const int lead = r.starts ? __ffs(r.starts) - 1 : SS_ITEMS;
#pragma unroll
    for (int i = 0; i < SS_ITEMS; ++i)
      if (i < lead) row[i] = Op::apply(pre, row[i]);
  }
  __syncthreads();
  store_tile(out, base, n, vec, (const T*)s);
  __syncthreads();  // the buffer takes the next column
}

struct Column {
  const void* in;
  void* out;
  int dtype;  // 0 int32, 1 int64, 2 float32, 3 float64
  int op;     // 0 sum, 1 min, 2 max
};
struct Columns {
  Column c[SS_MAX_COLS];
};

template <typename T>
__device__ __forceinline__ void scan_typed(const Column& c, const Rows& r,
                                           const Status& st, long long base,
                                           long long n, bool full,
                                           Shared& sh) {
  const T* x = (const T*)c.in;
  T* out = (T*)c.out;
  switch (c.op) {
    case 0: scan_column<T, OpSum>(x, out, r, st, base, n, full, sh); break;
    case 1: scan_column<T, OpMin>(x, out, r, st, base, n, full, sh); break;
    default: scan_column<T, OpMax>(x, out, r, st, base, n, full, sh);
  }
}

// flags, aggs, incs: k rows of ntiles entries, one row per column.
__global__ void __launch_bounds__(SS_THREADS, SS_MIN_BLOCKS)
    seg_scan_onepass(const int* __restrict__ gid, Columns cols, int k,
                     long long n, long long ntiles, unsigned* counter,
                     unsigned* flags, int* last_gid, u64* aggs, u64* incs) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  if (tid == 0) sh.tile = atomicAdd(counter, 1u);
  __syncthreads();
  const long long tile = sh.tile;
  const long long base = tile * SS_TILE;
  const bool full = base + SS_TILE <= n;

  int* sg = (int*)sh.buf;
  load_tile(gid, base, n, full && aligned16(gid + base), sg);
  __syncthreads();
  Rows r;
  {
    const int* mine = sg + tid * (SS_ITEMS + 1);
    r.first = r.last = mine[0];
    r.starts = 0;
#pragma unroll
    for (int i = 1; i < SS_ITEMS; ++i) {
      const int gi = mine[i];
      r.starts |= (unsigned)(gi != r.last) << i;
      r.last = gi;
    }
  }
  if (tid == 0) {
    sh.first = sg[0];
    sh.last = sg[SS_TILE - 1 + (SS_TILE - 1) / SS_ITEMS];
    // before this thread's first flag (release) of any column
    relaxed_store(&last_gid[tile], sh.last);
  }
  __syncthreads();

  for (int c = 0; c < k; ++c) {
    const Status st = {flags + c * ntiles, aggs + c * ntiles,
                       incs + c * ntiles, last_gid};
    switch (cols.c[c].dtype) {
      case 0: scan_typed<int>(cols.c[c], r, st, base, n, full, sh); break;
      case 1:
        scan_typed<long long>(cols.c[c], r, st, base, n, full, sh);
        break;
      case 2: scan_typed<float>(cols.c[c], r, st, base, n, full, sh); break;
      default: scan_typed<double>(cols.c[c], r, st, base, n, full, sh);
    }
  }
}

static long long align256(long long x) { return (x + 255) & ~255LL; }

// Scratch for n rows and k columns: the tile counter and k flags a tile
// (both zeroed at each launch), the last gid of each tile, then k
// aggregates and k inclusive prefixes a tile.
extern "C" long long srt_seg_scan_scratch_bytes(long long n, int k) {
  const long long nt = (n + SS_TILE - 1) / SS_TILE;
  return align256(4) + align256(k * nt * 4) + align256(nt * 4) +
         2 * k * nt * 8;
}

// gid: n int32, ascending.  ins[c], outs[c]: n values of type dtypes[c]
// (0 int32, 1 int64, 2 float32, 3 float64) under ops[c] (0 sum, 1 min,
// 2 max), for c < k <= SS_MAX_COLS.  scratch:
// srt_seg_scan_scratch_bytes(n, k) bytes.  Returns the CUDA error code
// (0 = launched).
extern "C" int srt_seg_scan(const void* gid, const void* const* ins,
                            void* const* outs, const int* dtypes,
                            const int* ops, int k, void* scratch,
                            long long n, void* stream) {
  if (k < 1 || k > SS_MAX_COLS) return (int)cudaErrorInvalidValue;
  Columns cols = {};
  for (int c = 0; c < k; ++c) {
    if (dtypes[c] < 0 || dtypes[c] > 3 || ops[c] < 0 || ops[c] > 2)
      return (int)cudaErrorInvalidValue;
    cols.c[c] = {ins[c], outs[c], dtypes[c], ops[c]};
  }
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long nt = (n + SS_TILE - 1) / SS_TILE;
  char* p = (char*)scratch;
  unsigned* counter = (unsigned*)p;
  unsigned* flags = (unsigned*)(p + align256(4));
  int* last_gid = (int*)(p + align256(4) + align256(k * nt * 4));
  u64* aggs = (u64*)((char*)last_gid + align256(nt * 4));
  u64* incs = aggs + k * nt;
  const cudaError_t e =
      cudaMemsetAsync(p, 0, align256(4) + k * nt * 4, s);
  if (e != cudaSuccess) return (int)e;
  seg_scan_onepass<<<(unsigned)nt, SS_THREADS, 0, s>>>(
      (const int*)gid, cols, k, n, nt, counter, flags, last_gid, aggs, incs);
  return (int)cudaGetLastError();
}
