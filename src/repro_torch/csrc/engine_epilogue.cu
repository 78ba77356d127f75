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
// bad-state totals) and last_x (the guarded frame, unless the Delta Unit
// wrote it).
//
// Replaces no Pallas kernel: the JAX engine runs this as XLA fusions of
// its jitted step (src/repro/serve/engine.py:315 _one_step, jitted at
// :468).
//
// What bounds it on this card: the launch, and at the LM widths the
// non-finite scan's bytes (RWKV6 at 24 layers holds 12.6 MB of state a
// slot, 3.8 us at 3.35 TB/s). The design takes the dependent round trips
// out of the launch's path:
// * The tables (each leaf's pointer, row length, row stride and first scan
//   item; each count tensor's pointer, rows, layer and first entry; each
//   layer's 1 / columns) lie in device memory, written once a capture, so
//   the arguments stay a few hundred bytes for any engine. Each block
//   reads the table it needs into shared memory while the kernel before
//   it drains, and looks a scan item's leaf up there.
// * Block 0 is the accountant; the other blocks scan. Before the scan is
//   done, block 0 loads finite, the per-slot sums and the aggregates into
//   registers. The scanners sum the Delta Unit's count rows (exact integer
//   atomics) into a workspace of N + 1 + 2 L (N + 1) ints (found zero,
//   left zero), set the flag of a slot whose row holds a non-finite value
//   there, and add one to its int N, the ticket, which block 0 waits for
//   (no scanner waits on anything, so every order of the blocks on the
//   card finishes); block 0 turns the sums into each slot's layer-mean
//   firing fractions in its shared memory.
// * Each scanner has kGroup scan items (chunks of 4096 elements of a leaf
//   row) in flight at a time; the grid has a scanner an item, up to two
//   blocks an SM.
// * The sums over slots are a fixed-order tree in shared memory (v[i] +=
//   v[i + s], s halving from the power of two below N), deterministic
//   from run to run (tree_sum_ref in kernels/engine_epilogue.py is its
//   plain twin).
// * A programmatic dependent launch: the shared memory's set-up runs
//   while the kernel before it drains; griddepcontrol.wait comes before
//   the first read of the operands.
// Every float operation is rounded on its own in the order the plain
// version's ops take (no fused multiply-add; the sums over layers run in
// layer order, where PyTorch's reduce may pair them otherwise: R5's 1e-6
// relative bound covers the sums over more than two terms).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 4096;      // elements of a leaf row a scan item
constexpr int kPerThread = kChunk / kThreads;  // of an item, a thread's
constexpr int kGroup = 4;         // scan items a scanner has in flight
constexpr int kMaxN = 1024;
constexpr int kSlots = kMaxN / kThreads;  // slots a thread of block 0
constexpr int kPer = 6;           // per-slot carry entries
constexpr int kAgg = 10;          // aggregate carry entries
constexpr int kLeafWords = 4;     // ptr, row, ld, item0 * 2 + vec
constexpr int kCountWords = 4;    // ptr, rows, layer, entry0
constexpr long long kSpinMax = 1LL << 26;

struct Args {
  int N, I, L, n_leaves, n_counts, items, entries;
  const long long* table;  // leaves, then counts, then layers' 1 / cols
  float inv_L, inv_N, xvol, hvol, inv_rate, wbits;
  const float* x;          // the guarded frame, or null: last_x holds it
  const bool* finite;
  float* last_x;
  float* per[kPer];  // fired_x, fired_h, lat_s, w_bytes, poison_steps, bad_state
  float* agg[kAgg];  // agg_fired_x, agg_fired_h, agg_lat_s, agg_w_bytes,
                     // agg_ufired_x, agg_ufired_h, agg_tile_lat_s,
                     // agg_tile_w_bytes, agg_poison_steps, agg_bad_state
  float* fh_mean;
  int* ws;           // [N] flags, [1] the ticket, [L, 2, N + 1] the count
                     // sums
};

// surviving MACs of Eq. 7 at firing fractions (fx, fh), as the plain version
// spells it: gamma = 1 - f, then 1 - gamma
__device__ __forceinline__ float surviving(const Args& a, float fx, float fh) {
  const float gx = __fsub_rn(1.0f, fx), gh = __fsub_rn(1.0f, fh);
  return __fadd_rn(__fmul_rn(a.xvol, __fsub_rn(1.0f, gx)),
                   __fmul_rn(a.hvol, __fsub_rn(1.0f, gh)));
}

__device__ __forceinline__ float wbytes(const Args& a, float surv) {
  return __fmul_rn(__fmul_rn(surv, a.wbits), 0.125f);
}

__device__ __forceinline__ int sums_words(int L, int N) {
  return max(L * 2 * (N + 1), kPer * N);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Scan the items (leaf rows in chunks of kChunk) of scanner `s` of `S`,
// the leaf table in shared memory, kGroup items at a time with their loads
// in flight together; the flag of a slot whose chunk holds a non-finite
// value is set in the workspace. Also copies the guarded frame into
// last_x.
__device__ void scan(const Args& a, const long long* leaves, int s, int S) {
  if (a.x != nullptr) {
    const size_t nx = (size_t)a.N * a.I;
    for (size_t i = (size_t)s * kThreads + threadIdx.x; i < nx;
         i += (size_t)S * kThreads)
      a.last_x[i] = a.x[i];
  }
  for (int base = s; base < a.items; base += kGroup * S) {
    float v[kGroup][kPerThread];
    int slot[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int item = base + g * S;
      slot[g] = -1;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) v[g][k] = 0.0f;
      if (item >= a.items) continue;
      int lo = 0, hi = a.n_leaves - 1;  // the last leaf whose items start
      while (lo < hi) {                 // at or before the item
        const int mid = (lo + hi + 1) >> 1;
        if ((int)(leaves[mid * kLeafWords + 3] >> 1) <= item) lo = mid;
        else hi = mid - 1;
      }
      const long long* lf = leaves + lo * kLeafWords;
      const int row = (int)lf[1];
      const int chunks = (row + kChunk - 1) / kChunk;
      const int local = item - (int)(lf[3] >> 1);
      const int n = local / chunks, c = local % chunks;
      const float* p = (const float*)lf[0] + (size_t)n * lf[2] +
                       (size_t)c * kChunk;
      const int len = min(kChunk, row - c * kChunk);
      slot[g] = n;
      if (lf[3] & 1) {  // 16-byte aligned rows: four floats a load
#pragma unroll
        for (int q = 0; q < kPerThread / 4; ++q) {
          const int e = 4 * (threadIdx.x + q * kThreads);
          if (e + 3 < len) {
            const float4 x = *(const float4*)(p + e);
            v[g][4 * q] = x.x, v[g][4 * q + 1] = x.y;
            v[g][4 * q + 2] = x.z, v[g][4 * q + 3] = x.w;
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (e + i < len) v[g][4 * q + i] = p[e + i];
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          const int e = threadIdx.x + k * kThreads;
          if (e < len) v[g][k] = p[e];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      bool bad = false;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) bad |= !isfinite(v[g][k]);
      if (bad) atomicOr(&a.ws[slot[g]], 1);
    }
  }
}

// The Delta Unit's count rows, entries first, first + stride, ... (an
// entry: one slot's count, or the union's, of one count row), each added
// into the workspace's sums[(l * 2 + g) * (N + 1) + n] (exact integers),
// kGroup entries' loads in flight at a time.
__device__ void count_entries(const Args& a, const long long* ctab,
                              int first, int stride) {
  int* sums = a.ws + a.N + 1;
  const int N = a.N, W = N + 1;
  for (int e0 = first; e0 < a.entries; e0 += kGroup * stride) {
    int v[kGroup], at[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int e = e0 + g * stride;
      v[g] = 0, at[g] = 0;
      if (e >= a.entries) continue;
      int lo = 0, hi = a.n_counts - 1;  // the last tensor whose entries <= e
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if ((int)ctab[mid * kCountWords + 3] <= e) lo = mid;
        else hi = mid - 1;
      }
      const long long* ct = ctab + lo * kCountWords;
      const int local = e - (int)ct[3];
      const int r = local / W, n = local % W;
      const int* row = (const int*)ct[0] + (size_t)r * (N + 2);
      v[g] = row[n];
      at[g] = ((int)ct[2] * 2 + row[N + 1]) * W + n;
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      if (v[g]) atomicAdd(&sums[at[g]], v[g]);
  }
}

// Each slot's layer-mean firing fraction of each group into
// frac[g * (N + 1) + n] (n == N: the union column), from the sums and each
// layer's (1 / input columns, 1 / hidden columns) in inv.
__device__ void fractions(const Args& a, const int* sums, const float2* inv,
                          float* frac) {
  const int W = a.N + 1;
  for (int i = threadIdx.x; i < 2 * W; i += kThreads) {
    const int g = i / W, n = i % W;
    float f = 0.0f;
    for (int l = 0; l < a.L; ++l) {
      const float2 ic = inv[l];
      const float fl =
          __fmul_rn((float)sums[(l * 2 + g) * W + n], g ? ic.y : ic.x);
      f = l == 0 ? fl : __fadd_rn(f, fl);
    }
    frac[i] = __fmul_rn(f, a.inv_L);
  }
}

// v[j * n] = the tree sum of v[j * n .. j * n + n), each j < kPer:
// v[i] += v[i + s] for s halving from the largest power of two below n
// (block-wide, a barrier a level)
__device__ void tree_sums(float* v, int n) {
  int s = 1;
  while (2 * s < n) s *= 2;
  for (; s >= 1; s >>= 1) {
    for (int t = threadIdx.x; t < kPer * s; t += kThreads) {
      const int j = t / s, i = t % s;
      if (i + s < n) v[j * n + i] = __fadd_rn(v[j * n + i], v[j * n + i + s]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    engine_epilogue_kernel(const __grid_constant__ Args a) {
  extern __shared__ long long smem[];
  const int N = a.N, W = N + 1;
  // shared memory: the leaf and count tables (the scanners'); block 0's
  // layers' 1 / columns, sums (then the tree's terms) and fractions
  long long* ltab = smem;
  long long* ctab = ltab + a.n_leaves * kLeafWords;
  float2* inv = (float2*)(ctab + a.n_counts * kCountWords);
  int* sums = (int*)(inv + a.L);
  float* red = (float*)sums;
  float* frac = (float*)(sums + sums_words(a.L, N));
  const int b = blockIdx.x;

  // the tables are no operand of the kernel before this one: they are
  // read while it drains
  if (b == 0) {
    const float2* layers = (const float2*)(a.table + a.n_leaves * kLeafWords +
                                           a.n_counts * kCountWords);
    for (int i = threadIdx.x; i < a.L; i += kThreads) inv[i] = layers[i];
  } else {
    const int words = a.n_leaves * kLeafWords + a.n_counts * kCountWords;
    for (int i = threadIdx.x; i < words; i += kThreads) ltab[i] = a.table[i];
  }
  __syncthreads();
  asm volatile("griddepcontrol.wait;" ::: "memory");

  if (b != 0) {
    const int S = (int)gridDim.x - 1;
    count_entries(a, ctab, (b - 1) * kThreads + threadIdx.x, S * kThreads);
    scan(a, ltab, b - 1, S);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(&a.ws[N], 1);
    return;
  }

  // block 0: what does not depend on the scan first, its loads issued
  // before the wait on the ticket
  float per[kSlots][kPer];
  bool fin[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int n = threadIdx.x + k * kThreads;
    fin[k] = true;
    if (n < N) {
      fin[k] = a.finite[n];
#pragma unroll
      for (int j = 0; j < kPer; ++j) per[k][j] = a.per[j][n];
    }
  }
  float agg[kAgg];
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < kAgg; ++k) agg[k] = *a.agg[k];

  if (threadIdx.x == 0) {
    long long spins = 0;
    while (load_acquire(&a.ws[N]) != (int)gridDim.x - 1) {
      __nanosleep(32);
      if (++spins > kSpinMax) __trap();
    }
  }
  __syncthreads();
  // the scanners' sums, taken and left zero
  for (int i = threadIdx.x; i < a.L * 2 * W; i += kThreads)
    sums[i] = atomicExch(&a.ws[N + 1 + i], 0);
  __syncthreads();
  fractions(a, sums, inv, frac);
  __syncthreads();   // the fractions' sums are read: red may take them

#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int n = threadIdx.x + k * kThreads;
    if (n >= N) continue;
    const int flag = atomicExch(&a.ws[n], 0);
    const float bad = flag ? 1.0f : 0.0f;
    const float fx = frac[n], fh = frac[W + n];
    const float surv = surviving(a, fx, fh);
    const float lat = __fmul_rn(surv, a.inv_rate);
    const float wb = wbytes(a, surv);
    const float poison = __fsub_rn(1.0f, fin[k] ? 1.0f : 0.0f);
    const float v[kPer] = {fx, fh, lat, wb, poison, bad};
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      a.per[j][n] = __fadd_rn(per[k][j], v[j]);
      red[j * N + n] = v[j];
    }
  }
  __syncthreads();
  tree_sums(red, N);
  if (threadIdx.x != 0) return;
  const float ufx = frac[N], ufh = frac[W + N];
  const float usurv = surviving(a, ufx, ufh);
  const float add[kAgg] = {__fmul_rn(red[0], a.inv_N),
                           __fmul_rn(red[N], a.inv_N),
                           __fmul_rn(red[2 * N], a.inv_N),
                           __fmul_rn(red[3 * N], a.inv_N),
                           ufx,
                           ufh,
                           __fmul_rn(usurv, a.inv_rate),
                           wbytes(a, usurv),
                           red[4 * N],
                           red[5 * N]};
#pragma unroll
  for (int k = 0; k < kAgg; ++k) *a.agg[k] = __fadd_rn(agg[k], add[k]);
  *a.fh_mean = add[1];
  a.ws[N] = 0;
}

// the dynamic shared memory of a launch
size_t smem_bytes(int L, int N, int n_leaves, int n_counts) {
  const size_t sums = (size_t)(L * 2 * (N + 1) > kPer * N ? L * 2 * (N + 1)
                                                          : kPer * N);
  return ((size_t)n_leaves * kLeafWords + (size_t)n_counts * kCountWords +
          (size_t)L) * 8 + 4 * sums + 4 * 2 * (N + 1);
}

cudaError_t launch(const Args& a, int grid, size_t smem,
                   cudaStream_t stream) {
  auto kernel = engine_epilogue_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

}  // namespace

// table (device int64 words): n_leaves rows of (pointer, row elements, row
// stride, first scan item * 2 + 1 where the rows are 16-byte aligned),
// then n_counts rows of (pointer to int32 [rows, N + 2] count rows, rows,
// layer, first entry: the rows * (N + 1) of the tensors before it), the
// tensors in layer order, then L words each of two fp32 (1 / input
// columns, 1 / hidden columns) of a layer. items: the leaves' scan items
// (N * ceil(row / 4096) a leaf); entries: the counts' rows * (N + 1).
// The Eq. 7 constants; io[21]: x (null: last_x already holds the guarded
// frame), finite (bool), last_x, the six per-slot entries, the ten
// aggregates, fh_mean, ws (int32 [N + 1 + 2 L (N + 1)], zero, left zero).
// Launches `grid` blocks (block 0 and grid - 1 scanners) on `stream` as a
// programmatic dependent launch; returns its error (0 on success), or
// cudaErrorInvalidValue for arguments it cannot take.
extern "C" int engine_epilogue_f32(
    int N, int I, int L, int n_leaves, int n_counts, int items, int entries,
    const void* table, float inv_L, float inv_N, float xvol, float hvol,
    float inv_rate, float wbits, const uint64_t* io, int grid,
    void* stream) {
  if (N < 1 || N > kMaxN || I < 0 || L < 1 || n_leaves < 0 ||
      n_counts < 1 || items < 0 || entries < 0 || grid < 2 ||
      (n_leaves == 0 && items != 0) || table == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(L, N, n_leaves, n_counts);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  Args a{};
  a.N = N, a.I = I, a.L = L, a.n_leaves = n_leaves, a.n_counts = n_counts;
  a.items = items, a.entries = entries;
  a.table = (const long long*)table;
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
  return (int)launch(a, grid, smem, (cudaStream_t)stream);
}
