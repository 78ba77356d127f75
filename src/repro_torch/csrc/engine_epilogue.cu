// The streaming engine's step epilogue for Hopper (sm_90a): after the
// head, one launch accounts for the step (DeltaStreamEngine._one_step of
// src/repro_torch/serve/engine.py):
//   bad[n]  = any non-finite value in slot n's row of any new-state leaf
//   fx[n]   = mean over layers l of nonzero_x[l][n] / cols_x[l] (fh alike)
//   ufx     = mean over layers of union_x[l] / cols_x[l]       (ufh alike)
//   Eq. 7:  macs = Vx (1 - (1 - f_x)) + Vh (1 - (1 - f_h)),
//           lat = macs / rate, bytes = macs * bits / 8
// and every carry entry but theta_h updated in place: the per-slot sums
// (fired_x, fired_h, lat_s, w_bytes, poison_steps, bad_state), the
// lifetime aggregates (the slots' means, the union terms, the poison and
// bad-state totals) and last_x (the guarded frame).
//
// Replaces no Pallas kernel: the JAX engine runs this as XLA fusions of
// its jitted step (src/repro/serve/engine.py:315 _one_step, jitted at
// :468). Before this kernel the port ran it as ~90 small PyTorch kernels a
// 2-layer step (a non-finite scan of each leaf, the fractions, the terms).
//
// What bounds it on this card: the launch, and at the LM widths the
// non-finite scan's bytes (RWKV6 at 24 layers holds 12.6 MB of state a
// slot, 3.8 us at 3.35 TB/s). The design: phase 1 spreads the scan over the
// grid, one block a chunk of 4096 elements of one leaf row, the leaves
// taken from a table of pointers, row lengths and row strides passed by
// value (built once a capture: a captured graph keeps its kernel's
// arguments, and the engine's leaves are its graph's own fixed buffers);
// a row that holds a non-finite value sets its slot's flag with an atomic
// OR. The grid also copies the guarded frame into last_x. The last block
// to finish (a ticket counter) runs phase 2 for at most 1024 slots: its
// threads sum the Delta Unit's count rows (exact integers) of each layer,
// group and slot in parallel into a scratch of fractions, then one thread
// a slot adds its layers' fractions and updates the slot's sums, and
// thread 0 adds the aggregates in slot order. Every float operation is rounded on its own
// in the order the plain version's ops take (no fused multiply-add; the
// sums over layers and slots run in index order, where PyTorch's reduce
// may pair them otherwise: R5's 1e-6 relative bound covers the sums over
// more than two terms). The flags and the ticket live in a workspace of
// N + 1 ints that the launch finds zero and leaves zero, so nothing is
// cleared before it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;      // elements of a leaf row a block scans
constexpr int kMaxN = 1024;
constexpr int kPer = 6;           // per-slot carry entries
constexpr int kAgg = 10;          // aggregate carry entries

// The tables' capacity: a small instance whose argument block stays under
// the 4 KB that a launch carries at no extra cost (a 2- to 8-layer GRU /
// LSTM engine: 8 leaves and 2 count tensors a 2-layer step), and a large
// one for the LM cells (RWKV6: 240 leaves, 24 count tensors), ~25 KB of
// arguments, which CUDA 12.1 and later pass at a few us more a launch.
template <int kLeaves, int kCounts, int kLayers>
struct Args {
  static constexpr int max_leaves = kLeaves, max_counts = kCounts,
                       max_layers = kLayers;
  int N, I, L, n_leaves, items;
  const float* leaf[kLeaves];
  int row[kLeaves];
  int ld[kLeaves];
  int item0[kLeaves + 1];
  const int* cnt[kCounts];
  int cnt_rows[kCounts];
  int cnt_first[kLayers + 1];  // count tensors of layer l: [first[l], first[l+1])
  float inv_cols[kLayers][2];
  float inv_L, inv_N, xvol, hvol, inv_rate, wbits;
  const float* x;
  const bool* finite;
  float* last_x;
  float* per[kPer];  // fired_x, fired_h, lat_s, w_bytes, poison_steps, bad_state
  float* agg[kAgg];  // agg_fired_x, agg_fired_h, agg_lat_s, agg_w_bytes,
                     // agg_ufired_x, agg_ufired_h, agg_tile_lat_s,
                     // agg_tile_w_bytes, agg_poison_steps, agg_bad_state
  float* fh_mean;
  int* ws;           // [N] flags, [N] the ticket
  float* frac;       // [L, 2, N + 1] scratch: each layer's fractions
};
using SmallArgs = Args<48, 16, 16>;
using LargeArgs = Args<1024, 256, 128>;
static_assert(sizeof(SmallArgs) <= 4096, "the small instance's arguments");

// surviving MACs of Eq. 7 at firing fractions (fx, fh), as the plain version
// spells it: gamma = 1 - f, then 1 - gamma
template <class A>
__device__ __forceinline__ float surviving(const A& a, float fx, float fh) {
  const float gx = __fsub_rn(1.0f, fx), gh = __fsub_rn(1.0f, fh);
  return __fadd_rn(__fmul_rn(a.xvol, __fsub_rn(1.0f, gx)),
                   __fmul_rn(a.hvol, __fsub_rn(1.0f, gh)));
}

template <class A>
__device__ __forceinline__ float wbytes(const A& a, float surv) {
  return __fmul_rn(__fmul_rn(surv, a.wbits), 0.125f);
}

// each layer's firing fraction, count / cols, of every slot n (n == N: the
// union column) and group g, into frac[(l * 2 + g) * (N + 1) + n]: the
// block's threads take the (l, g, n) entries in turn, each summing its
// layer's count rows of group g (exact integers)
template <class A>
__device__ void layer_fractions(const A& a, float* frac) {
  const int N = a.N, w = N + 2, total = a.L * 2 * (N + 1);
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int n = i % (N + 1), g = (i / (N + 1)) & 1, l = i / (2 * (N + 1));
    int c = 0;
    for (int t = a.cnt_first[l]; t < a.cnt_first[l + 1]; ++t) {
      const int* rows = a.cnt[t];
      for (int r = 0; r < a.cnt_rows[t]; ++r) {
        const int* row = rows + (size_t)r * w;
        c += row[N + 1] == g ? row[n] : 0;
      }
    }
    frac[i] = __fmul_rn((float)c, a.inv_cols[l][g]);
  }
}

// the layer-mean firing fraction of slot n (n == N: the union column) of
// group g: sum over layers of count / cols, in layer order, times 1 / L
template <class A>
__device__ float layer_mean(const A& a, const float* frac, int n, int g) {
  float f = 0.0f;
  for (int l = 0; l < a.L; ++l) {
    const float fl = frac[(l * 2 + g) * (a.N + 1) + n];
    f = l == 0 ? fl : __fadd_rn(f, fl);
  }
  return __fmul_rn(f, a.inv_L);
}

template <class A>
__global__ void __launch_bounds__(kThreads)
    engine_epilogue_kernel(const __grid_constant__ A a) {
  __shared__ float s_fx[kMaxN], s_fh[kMaxN], s_lat[kMaxN], s_wb[kMaxN],
      s_poison[kMaxN], s_bad[kMaxN];
  __shared__ int is_last;
  const int N = a.N;

  // phase 1: last_x, and the non-finite flags over the leaves' rows
  const size_t nx = (size_t)N * a.I;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < nx;
       i += (size_t)gridDim.x * kThreads)
    a.last_x[i] = a.x[i];
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    int lo = 0, hi = a.n_leaves - 1;  // the last leaf whose items start <= item
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (a.item0[mid] <= item) lo = mid; else hi = mid - 1;
    }
    const int row = a.row[lo];
    const int chunks = (row + kChunk - 1) / kChunk;
    const int local = item - a.item0[lo];
    const int n = local / chunks, c = local % chunks;
    const float* p = a.leaf[lo] + (size_t)n * a.ld[lo] + (size_t)c * kChunk;
    const int len = min(kChunk, row - c * kChunk);
    int bad = 0;
    for (int e = threadIdx.x; e < len; e += kThreads) bad |= !isfinite(p[e]);
    if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(&a.ws[n], 1);
  }

  // the last block to arrive runs phase 2
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&a.ws[N], 1) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  layer_fractions(a, a.frac);
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float bad = atomicExch(&a.ws[n], 0) ? 1.0f : 0.0f;
    const float fx = layer_mean(a, a.frac, n, 0);
    const float fh = layer_mean(a, a.frac, n, 1);
    const float surv = surviving(a, fx, fh);
    const float lat = __fmul_rn(surv, a.inv_rate);
    const float wb = wbytes(a, surv);
    const float poison = __fsub_rn(1.0f, a.finite[n] ? 1.0f : 0.0f);
    a.per[0][n] = __fadd_rn(a.per[0][n], fx);
    a.per[1][n] = __fadd_rn(a.per[1][n], fh);
    a.per[2][n] = __fadd_rn(a.per[2][n], lat);
    a.per[3][n] = __fadd_rn(a.per[3][n], wb);
    a.per[4][n] = __fadd_rn(a.per[4][n], poison);
    a.per[5][n] = __fadd_rn(a.per[5][n], bad);
    s_fx[n] = fx, s_fh[n] = fh, s_lat[n] = lat, s_wb[n] = wb;
    s_poison[n] = poison, s_bad[n] = bad;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float sum[6] = {0, 0, 0, 0, 0, 0};
  for (int n = 0; n < N; ++n) {
    sum[0] = __fadd_rn(sum[0], s_fx[n]);
    sum[1] = __fadd_rn(sum[1], s_fh[n]);
    sum[2] = __fadd_rn(sum[2], s_lat[n]);
    sum[3] = __fadd_rn(sum[3], s_wb[n]);
    sum[4] = __fadd_rn(sum[4], s_poison[n]);
    sum[5] = __fadd_rn(sum[5], s_bad[n]);
  }
  const float ufx = layer_mean(a, a.frac, N, 0);
  const float ufh = layer_mean(a, a.frac, N, 1);
  const float usurv = surviving(a, ufx, ufh);
  const float add[kAgg] = {__fmul_rn(sum[0], a.inv_N),
                           __fmul_rn(sum[1], a.inv_N),
                           __fmul_rn(sum[2], a.inv_N),
                           __fmul_rn(sum[3], a.inv_N),
                           ufx,
                           ufh,
                           __fmul_rn(usurv, a.inv_rate),
                           wbytes(a, usurv),
                           sum[4],
                           sum[5]};
  for (int k = 0; k < kAgg; ++k) *a.agg[k] = __fadd_rn(*a.agg[k], add[k]);
  *a.fh_mean = add[1];
  a.ws[N] = 0;
}

template <class A>
cudaError_t fill_and_launch(
    A& a, int N, int I, int L, int n_leaves, const uint64_t* leaves,
    const int* rows, const int* lds, int n_counts, const uint64_t* counts,
    const int* count_rows, const int* cnt_first, const float* inv_cols,
    float inv_L, float inv_N, float xvol, float hvol, float inv_rate,
    float wbits, const uint64_t* io, int grid, cudaStream_t stream) {
  a.N = N, a.I = I, a.L = L, a.n_leaves = n_leaves;
  long long items = 0;
  for (int i = 0; i < n_leaves; ++i) {
    if (rows[i] < 0 || (rows[i] > 0 && lds[i] < rows[i]))
      return cudaErrorInvalidValue;
    a.leaf[i] = (const float*)leaves[i];
    a.row[i] = rows[i];
    a.ld[i] = lds[i];
    a.item0[i] = (int)items;
    items += (long long)N * ((rows[i] + kChunk - 1) / kChunk);
    if (items > (1LL << 30)) return cudaErrorInvalidValue;
  }
  a.item0[n_leaves] = (int)items;
  a.items = (int)items;
  for (int t = 0; t < n_counts; ++t) {
    if (count_rows[t] < 1) return cudaErrorInvalidValue;
    a.cnt[t] = (const int*)counts[t];
    a.cnt_rows[t] = count_rows[t];
  }
  if (cnt_first[0] != 0 || cnt_first[L] != n_counts)
    return cudaErrorInvalidValue;
  for (int l = 0; l <= L; ++l) {
    if (l > 0 && cnt_first[l] < cnt_first[l - 1])
      return cudaErrorInvalidValue;
    a.cnt_first[l] = cnt_first[l];
  }
  for (int l = 0; l < L; ++l) {
    a.inv_cols[l][0] = inv_cols[2 * l];
    a.inv_cols[l][1] = inv_cols[2 * l + 1];
  }
  a.inv_L = inv_L, a.inv_N = inv_N, a.xvol = xvol, a.hvol = hvol;
  a.inv_rate = inv_rate, a.wbits = wbits;
  int k = 0;
  a.x = (const float*)io[k++];
  a.finite = (const bool*)io[k++];
  a.last_x = (float*)io[k++];
  for (int j = 0; j < kPer; ++j) a.per[j] = (float*)io[k++];
  for (int j = 0; j < kAgg; ++j) a.agg[j] = (float*)io[k++];
  a.fh_mean = (float*)io[k++];
  a.ws = (int*)io[k++];
  a.frac = (float*)io[k++];
  engine_epilogue_kernel<A><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The step's tables (host arrays, copied into the launch's arguments):
// leaves[n_leaves] (fp32, slot-major: row `rows[i]` elements of slot n at
// leaves[i] + n * lds[i]); counts[n_counts] (int32 [count_rows[t], N + 2]
// count rows, in layer order, cnt_first[L + 1] the first of each layer);
// inv_cols[2 L] (1 / columns of each layer's input and hidden group, as
// fp32); the Eq. 7 constants; io[22]: x, finite (bool), last_x, the six
// per-slot entries, the ten aggregates, fh_mean, ws (int32 [N + 1], zero),
// frac (fp32 [L, 2, N + 1], scratch).
// Launches `grid` blocks on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for tables it cannot take.
extern "C" int engine_epilogue_f32(
    int N, int I, int L, int n_leaves, const uint64_t* leaves,
    const int* rows, const int* lds, int n_counts, const uint64_t* counts,
    const int* count_rows, const int* cnt_first, const float* inv_cols,
    float inv_L, float inv_N, float xvol, float hvol, float inv_rate,
    float wbits, const uint64_t* io, int grid, void* stream) {
  if (N < 1 || N > kMaxN || I < 0 || L < 1 || L > LargeArgs::max_layers ||
      n_leaves < 0 || n_leaves > LargeArgs::max_leaves || n_counts < 0 ||
      n_counts > LargeArgs::max_counts || grid < 1)
    return (int)cudaErrorInvalidValue;
  static SmallArgs small;
  static LargeArgs large;  // ~25 KB: kept off the host stack
  const bool fits = n_leaves <= SmallArgs::max_leaves &&
                    n_counts <= SmallArgs::max_counts &&
                    L <= SmallArgs::max_layers;
  const cudaError_t err =
      fits ? fill_and_launch(small, N, I, L, n_leaves, leaves, rows, lds,
                             n_counts, counts, count_rows, cnt_first,
                             inv_cols, inv_L, inv_N, xvol, hvol, inv_rate,
                             wbits, io, grid, (cudaStream_t)stream)
           : fill_and_launch(large, N, I, L, n_leaves, leaves, rows, lds,
                             n_counts, counts, count_rows, cnt_first,
                             inv_cols, inv_L, inv_N, xvol, hvol, inv_rate,
                             wbits, io, grid, (cudaStream_t)stream);
  return (int)err;
}
