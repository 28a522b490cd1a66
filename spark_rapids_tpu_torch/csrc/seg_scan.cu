// K1: segmented inclusive running sum, min or max of one value column
// over ascending group ids; the running value restarts wherever the id
// changes, so a segment's last row holds that segment's reduction.
//
// Replaces the TPU kernel spark_rapids_tpu/ops/pallas_kernels.py
// seg_agg_1d (kernel body _make_seg_agg_kernel), which walks (8, 128)
// tiles in grid order with a (last gid, running value) carry in SMEM.
// CUDA blocks run in no order, so the carry becomes three launches:
//   1. seg_block_carry: each 1024-row block scans its rows and keeps
//      (gid of its last row, running value at its end);
//   2. seg_scan_carries: one block scans those carries in order, 1024 at a
//      time (n/1024 of them: 65,536 at 2^26), so carry b becomes the full
//      running value at the end of block b;
//   3. seg_block_apply: each block scans its rows again and folds the
//      incoming carry into its leading run of rows whose gid equals the
//      carry's gid.
// Each scan restarts at a boundary, so a float sum has none of the
// cancellation a difference of running prefixes would have.
// Bound on this card: bytes.  The function must read gid and the values
// and write the values (20 bytes a row at 8-byte values); this design
// reads gid and values twice, 32 bytes a row.  One launch per value
// column: the TPU kernel reads gid once for all columns of a request set,
// which a later change can copy by taking several columns per launch.
#include "scan_common.cuh"

template <typename Op, typename T>
__global__ void seg_block_carry(const int* __restrict__ gid,
                                const T* __restrict__ v,
                                int* __restrict__ carry_g,
                                T* __restrict__ carry_v, long long n) {
  __shared__ int tail_g[32];
  __shared__ T tail_v[32];
  const long long base = (long long)blockIdx.x * SCAN_BLOCK;
  const long long i = base + threadIdx.x;
  // rows past n take the last row's gid and never reach the carry
  const int g = gid[i < n ? i : n - 1];
  T x = i < n ? v[i] : v[n - 1];
  x = block_seg_scan<Op>(g, x, tail_g, tail_v);
  const long long last = (n - base < SCAN_BLOCK ? n - base : SCAN_BLOCK) - 1;
  if (threadIdx.x == last) {
    carry_g[blockIdx.x] = g;
    carry_v[blockIdx.x] = x;
  }
}

template <typename Op, typename T>
__global__ void seg_scan_carries(int* carry_g, T* carry_v, long long nb) {
  __shared__ int tail_g[32];
  __shared__ T tail_v[32];
  __shared__ int run_g;
  __shared__ T run_v;
  for (long long base = 0; base < nb; base += SCAN_BLOCK) {
    const long long i = base + threadIdx.x;
    const int g = carry_g[i < nb ? i : nb - 1];
    T x = carry_v[i < nb ? i : nb - 1];
    x = block_seg_scan<Op>(g, x, tail_g, tail_v);
    if (base > 0 && g == run_g) x = Op::apply(run_v, x);
    if (i < nb) carry_v[i] = x;
    __syncthreads();
    const long long last =
        (nb - base < SCAN_BLOCK ? nb - base : SCAN_BLOCK) - 1;
    if (threadIdx.x == last) {
      run_g = g;
      run_v = x;
    }
    __syncthreads();
  }
}

template <typename Op, typename T>
__global__ void seg_block_apply(const int* __restrict__ gid,
                                const T* __restrict__ v, T* __restrict__ out,
                                const int* __restrict__ carry_g,
                                const T* __restrict__ carry_v, long long n) {
  __shared__ int tail_g[32];
  __shared__ T tail_v[32];
  const long long i = (long long)blockIdx.x * SCAN_BLOCK + threadIdx.x;
  const int g = gid[i < n ? i : n - 1];
  T x = i < n ? v[i] : v[n - 1];
  x = block_seg_scan<Op>(g, x, tail_g, tail_v);
  if (blockIdx.x > 0 && carry_g[blockIdx.x - 1] == g)
    x = Op::apply(carry_v[blockIdx.x - 1], x);
  if (i < n) out[i] = x;
}

template <typename Op, typename T>
static int launch(const int* gid, const void* v, void* out, int* carry_g,
                  void* carry_v, long long n, cudaStream_t s) {
  const long long nb = (n + SCAN_BLOCK - 1) / SCAN_BLOCK;
  seg_block_carry<Op, T><<<(unsigned)nb, SCAN_BLOCK, 0, s>>>(
      gid, (const T*)v, carry_g, (T*)carry_v, n);
  seg_scan_carries<Op, T><<<1, SCAN_BLOCK, 0, s>>>(carry_g, (T*)carry_v, nb);
  seg_block_apply<Op, T><<<(unsigned)nb, SCAN_BLOCK, 0, s>>>(
      gid, (const T*)v, (T*)out, carry_g, (const T*)carry_v, n);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_op(int op, const int* gid, const void* v, void* out,
                       int* carry_g, void* carry_v, long long n,
                       cudaStream_t s) {
  if (op == 0) return launch<OpSum, T>(gid, v, out, carry_g, carry_v, n, s);
  if (op == 1) return launch<OpMin, T>(gid, v, out, carry_g, carry_v, n, s);
  if (op == 2) return launch<OpMax, T>(gid, v, out, carry_g, carry_v, n, s);
  return (int)cudaErrorInvalidValue;
}

// gid: n int32, ascending.  v, out: n values of type `dtype` (0: int32,
// 1: int64, 2: float32, 3: float64).  op: 0 sum, 1 min, 2 max.
// carry_g / carry_v: one entry per SCAN_BLOCK-row block (srt_scan_block()).
// Returns the CUDA error code (0 = launched).
extern "C" int srt_seg_scan(const void* gid, const void* v, void* out,
                            void* carry_g, void* carry_v, long long n,
                            int dtype, int op, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* g = (const int*)gid;
  int* cg = (int*)carry_g;
  if (n <= 0) return 0;
  switch (dtype) {
    case 0: return dispatch_op<int>(op, g, v, out, cg, carry_v, n, s);
    case 1: return dispatch_op<long long>(op, g, v, out, cg, carry_v, n, s);
    case 2: return dispatch_op<float>(op, g, v, out, cg, carry_v, n, s);
    case 3: return dispatch_op<double>(op, g, v, out, cg, carry_v, n, s);
  }
  return (int)cudaErrorInvalidValue;
}
