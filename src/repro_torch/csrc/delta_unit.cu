// The Delta Unit (EdgeDRNN Eq. 2) of one layer step for Hopper (sm_90a):
// for every stream segment j of the step and every stream slot n,
//   raw = s - s_hat;  fired = |raw| >= theta_g
//   delta = fired ? raw : 0;  s_hat' = fired ? s : s_hat
// with g the segment's group (0: the layer's input streams, threshold
// theta_x; 1: its hidden streams, theta_h), and the counts the engine's
// accounting reads: per slot the nonzero deltas, and the columns some slot
// fired (the stream tile's union), per group.
//
// Replaces no Pallas kernel: the JAX package runs Eq. 2 as fused XLA ops
// inside its jitted step (src/repro/kernels/deltagru_seq.py:13-14, the
// engine's jax.jit at src/repro/serve/engine.py:468-469).
//
// What bounds it on this card: the launch. A 2L-768H layer step moves
// (40 + 768) x 16 bytes a stream (s and s_hat read, delta and s_hat'
// written): 13 KB, 0.004 us at 3.35 TB/s. The design:
// * One launch for both groups of a layer step. A block takes a tile of
//   one segment's columns for every slot: 256 threads as `rows` slot rows
//   of `tile` columns (tile * rows = 256, tile a multiple of 32, so a warp
//   holds one slot row), each thread `kUnroll` slots at a time (one where
//   N = 1), their loads issued together, and the next turn's slots' loads
//   issued before this turn's work (the slot rows past N skipped,
//   uniformly). A block holds every slot of its columns, so the union
//   of a column is a register OR and a shared-memory OR across the slot
//   rows, with no reduction across blocks. Per-slot counts: a warp ballot
//   and a popcount a slot, added into shared memory. Each block writes one
//   count row of its own ([N per-slot counts, union, group]); the reader
//   sums a group's rows. Nothing is zeroed before the launch and no atomic
//   leaves the block, so the launch is one graph node and its counts are
//   exact and deterministic.
// * The engine's frame guard (guard != 0, segment 0, the raw frame of
//   layer 0, at most 256 columns, so one block holds a slot's whole row):
//   finite[n] is "every column of slot n's frame is finite" (x - x == 0 in
//   every column: a warp vote, a bit a warp in shared memory, one barrier),
//   the frame becomes finite ? x : last_x, which is written back into
//   last_x in the same pass, before the rounding onto the grid.
// * A plain launch, not a programmatic dependent one: launched early, it
//   made the RG-LRU and RWKV6 steps slower, and the 2L-768H step no
//   faster.
//
// The quantized input (fused_q8 / fused_q4): the input group is first
// rounded onto the Q8.8 grid, rintf (half to even, as torch.round) of
// s * scale, divided by scale, clipped with NaN passed through, as
// torch.clamp does. Every operation is rounded on its own (no fused
// multiply-add), so delta, memory, counts, finite and last_x are bitwise
// the plain version's. The thresholds are read from device memory when
// given as a pointer. A group whose bit is set in fire_all fires every
// element, NaN included: the reference's jitted step folds |raw| >= 0 to
// true for a host threshold of 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a block: rows x tile
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 16;    // slots a thread has in flight (N > 1)
constexpr int kMaxSegs = 8;    // segments a launch
constexpr int kMaxN = 8192;    // stream slots a launch

struct Seg {
  const float* s;    // [N, len], row stride ld
  const float* mem;  // [N, len], contiguous
  float* delta;      // [N, len]
  float* mem_out;    // [N, len]
  int len, ld, group, first_block;
  int tile;          // columns a block: 32, 64, 128 or 256
};

struct Args {
  Seg seg[kMaxSegs];
  int nseg, N;
  const float* theta_ptr[2];
  float theta_val[2];
  int fire_all;              // bit g: group g fires every element
  float qscale, qmin, qmax;  // qscale > 0: round group 0 onto the grid
  int* counts;               // [blocks, N + 2]
  float* last_x;             // the guard (segment 0): [N, len], or null
  bool* finite;              // [N]
};

__device__ __forceinline__ float grid_round(float v, float scale, float lo,
                                            float hi) {
  float q = __fdiv_rn(rintf(__fmul_rn(v, scale)), scale);
  // torch.clamp: NaN stays NaN
  return q < lo ? lo : (q > hi ? hi : q);
}

// The operands of the thread's slots n0 + u * rows + r (u < U) into
// registers (0 past N or past the segment's columns).
template <int U>
__device__ __forceinline__ void load_slots(const Seg& sg, const float* last_x,
                                           bool guard, int n0, int rows,
                                           int r, int col, bool in, int N,
                                           float (&s)[U], float (&m)[U],
                                           float (&lx)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int n = n0 + u * rows + r;
    s[u] = m[u] = lx[u] = 0.0f;
    if (in && n < N) {
      s[u] = sg.s[(size_t)n * sg.ld + col];
      m[u] = sg.mem[(size_t)n * sg.len + col];
      if (guard) lx[u] = last_x[(size_t)n * sg.len + col];
    }
  }
}

// U: the slots a thread has in flight (1 for a single slot, kUnroll);
// kGuard: the launch guards the frame (segment 0). Each instance holds only
// the code its launches run: in a step of many kernels, a smaller kernel
// starts sooner.
template <int U, bool kGuard>
__global__ void __launch_bounds__(kThreads)
    delta_unit_kernel(const __grid_constant__ Args a) {
  extern __shared__ int cnt[];      // [N] per-slot nonzero counts
  __shared__ unsigned colbits[kWarps];   // the tile's fired columns
  // the guard: the warps that saw a non-finite value, a bit each, in
  // three buffers taken by turns, so one barrier a turn orders them: the
  // buffer a turn clears was last read two turns before
  __shared__ unsigned badbits[3][U];
  const int b = blockIdx.x;
  int j = 0;
  while (j + 1 < a.nseg && b >= a.seg[j + 1].first_block) ++j;
  const Seg sg = a.seg[j];
  const int N = a.N, tile = sg.tile, rows = kThreads / tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c_local = tid % tile, r = tid / tile;
  const int col = (b - sg.first_block) * tile + c_local;
  const bool in = col < sg.len;
  const int g = sg.group;
  const bool guard = kGuard && j == 0;
  const bool quant = g == 0 && a.qscale > 0.0f;
  const bool all = (a.fire_all >> g) & 1;
  const int row_warps = tile >> 5;  // the warps of one slot row
  const unsigned row_mask = ((1u << row_warps) - 1u) << (r * row_warps);
  for (int n = tid; n < N; n += kThreads) cnt[n] = 0;
  if (tid < kWarps) colbits[tid] = 0u;
  if (tid < 3 * U) badbits[tid / U][tid % U] = 0u;
  __syncthreads();

  const float theta =
      a.theta_ptr[g] != nullptr ? *a.theta_ptr[g] : a.theta_val[g];
  unsigned any = 0u;
  int turn = 0;
  float s[U], m[U], lx[U];
  load_slots<U>(sg, a.last_x, guard, 0, rows, r, col, in, N, s, m, lx);
  for (int n0 = 0; n0 < N; n0 += rows * U, turn = (turn + 1) % 3) {
    // u < live: the slot rows that hold a slot (uniform over the block)
    const int live = min(U, (N - n0 + rows - 1) / rows);
    // the next turn's loads are in flight during this turn's work
    const int next = n0 + rows * U;
    float ns[U], nm[U], nlx[U];
    if constexpr (U > 1) {
      if (next < N)
        load_slots<U>(sg, a.last_x, guard, next, rows, r, col, in, N, ns, nm,
                      nlx);
    }
    if (guard) {  // uniform over the block: its segment is the frame
      if (tid < U) badbits[(turn + 1) % 3][tid] = 0u;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= live) break;
        const bool ok = !in || __fsub_rn(s[u], s[u]) == 0.0f;
        if (!__all_sync(0xffffffffu, ok) && lane == 0)
          atomicOr(&badbits[turn][u], 1u << warp);
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= live) break;
        const int n = n0 + u * rows + r;
        const bool fin = (badbits[turn][u] & row_mask) == 0u;
        if (in && n < N) {
          s[u] = fin ? s[u] : lx[u];
          a.last_x[(size_t)n * sg.len + col] = s[u];
          if (c_local == 0) a.finite[n] = fin;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= live) break;
      const int n = n0 + u * rows + r;
      int nz = 0;
      if (in && n < N) {
        const float sv = quant ? grid_round(s[u], a.qscale, a.qmin, a.qmax)
                               : s[u];
        const size_t o = (size_t)n * sg.len + col;
        const float raw = __fsub_rn(sv, m[u]);
        const bool fired = all || fabsf(raw) >= theta;
        const float d = fired ? raw : 0.0f;
        sg.delta[o] = d;
        sg.mem_out[o] = fired ? sv : m[u];
        nz = d != 0.0f;
      }
      any |= (unsigned)nz;
      const unsigned bal = __ballot_sync(0xffffffffu, nz);
      if (lane == 0 && bal) atomicAdd(&cnt[n], __popc(bal));
    }
    if constexpr (U > 1) {
      if (next < N) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          s[u] = ns[u], m[u] = nm[u], lx[u] = nlx[u];
      }
    }
  }
  const unsigned ub = __ballot_sync(0xffffffffu, any);
  if (lane == 0 && ub) atomicOr(&colbits[c_local >> 5], ub);
  __syncthreads();
  int* row = a.counts + (size_t)b * (N + 2);
  for (int n = tid; n < N; n += kThreads) row[n] = cnt[n];
  if (tid == 0) {
    int uni = 0;
    for (int k = 0; k < row_warps; ++k) uni += __popc(colbits[k]);
    row[N] = uni;
    row[N + 1] = g;
  }
}

}  // namespace

// seg_table[nseg] (a Seg each): the segment's pointers (s may be
// row-strided, ld >= len; the others contiguous [N, len]), its group (0 or
// 1), its first block (the blocks of the segments before it,
// ceil(len / tile) each, in order) and its tile (32, 64, 128 or 256
// columns a block, a slot row a warp of 32 columns or more).
// theta_{x,h}_ptr: a device fp32 scalar, or null to take theta_{x,h};
// fire_all: bit g set fires every element of group g.
// qscale > 0 rounds group 0 onto the grid (scale, qmin, qmax) first.
// last_x / finite: the frame guard on segment 0 (a group-0 segment of
// len <= its tile, last_x contiguous [N, len], finite bool [N]), or null.
// counts: [blocks, N + 2] int32, one row a block. Launches on `stream` and
// returns its error (0 on success); arguments it cannot run return
// cudaErrorInvalidValue.
extern "C" int delta_unit_f32(const void* seg_table, int nseg, int N,
                              const void* theta_x_ptr, float theta_x,
                              const void* theta_h_ptr, float theta_h,
                              int fire_all, float qscale, float qmin,
                              float qmax, void* last_x, void* finite,
                              void* counts, int blocks, void* stream) {
  if (nseg < 1 || nseg > kMaxSegs || N < 1 || N > kMaxN || blocks < 0 ||
      (last_x == nullptr) != (finite == nullptr))
    return (int)cudaErrorInvalidValue;
  const Seg* segs = (const Seg*)seg_table;
  Args a{};
  int want = 0;
  for (int j = 0; j < nseg; ++j) {
    const Seg& s = segs[j];
    if (s.len < 0 || s.ld < s.len || (s.group != 0 && s.group != 1) ||
        s.first_block != want ||
        (s.tile != 32 && s.tile != 64 && s.tile != 128 && s.tile != 256))
      return (int)cudaErrorInvalidValue;
    if (s.len > 0 && (!s.s || !s.mem || !s.delta || !s.mem_out))
      return (int)cudaErrorInvalidValue;
    want += (s.len + s.tile - 1) / s.tile;
    a.seg[j] = s;
  }
  if (last_x != nullptr &&
      (segs[0].group != 0 || segs[0].len < 1 || segs[0].len > segs[0].tile))
    return (int)cudaErrorInvalidValue;
  if (want != blocks) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  a.nseg = nseg;
  a.N = N;
  a.theta_ptr[0] = (const float*)theta_x_ptr;
  a.theta_ptr[1] = (const float*)theta_h_ptr;
  a.theta_val[0] = theta_x;
  a.theta_val[1] = theta_h;
  a.fire_all = fire_all;
  a.qscale = qscale;
  a.qmin = qmin;
  a.qmax = qmax;
  a.counts = (int*)counts;
  a.last_x = (float*)last_x;
  a.finite = (bool*)finite;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)N * sizeof(int);  // <= 32 KB: no opt-in
  cfg.stream = (cudaStream_t)stream;
  const bool guard = last_x != nullptr;
  auto kernel = N == 1 ? (guard ? delta_unit_kernel<1, true>
                                : delta_unit_kernel<1, false>)
                       : (guard ? delta_unit_kernel<kUnroll, true>
                                : delta_unit_kernel<kUnroll, false>);
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}
