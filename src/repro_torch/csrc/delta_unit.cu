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
// engine's jax.jit at src/repro/serve/engine.py:468-469). Before this
// kernel the port ran it op by op, six small PyTorch kernels a stream pair
// (abs, compare, two where, the rounding of a quantized input).
//
// What bounds it on this card: the launch. A 2L-768H layer step moves
// (40 + 768) x 16 bytes a stream (s and s_hat read, delta and s_hat'
// written): 13 KB, 0.004 us at 3.35 TB/s. The design is one launch for
// both groups of a layer step, one column a thread, 256 columns a block,
// the slots in a loop inside the thread: a thread holds one column of
// every slot, so the union of its column is a register OR and needs no
// reduction across blocks. Per-slot counts: a warp ballot and a popcount
// a slot, added into shared memory. Each block writes one count row of its
// own ([N per-slot counts, union, group]); the reader sums a group's rows.
// Nothing is zeroed before the launch and no atomic leaves the block, so
// the launch is one graph node and its counts are exact and deterministic.
//
// The quantized input (fused_q8 / fused_q4): the input group is first
// rounded onto the Q8.8 grid, rintf (half to even, as torch.round) of
// s * scale, divided by scale, clipped with NaN passed through, as
// torch.clamp does. Every operation is rounded on its own (no fused
// multiply-add), so delta, memory and counts are bitwise the plain
// version's. The thresholds are read from device memory when given as a
// pointer (the engine's theta_h, which the dynamic controller moves
// between the replays of a captured graph).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;    // columns a block, one a thread
constexpr int kMaxSegs = 8;   // segments a launch
constexpr int kMaxN = 8192;   // stream slots a launch

struct Seg {
  const float* s;    // [N, len], row stride ld
  const float* mem;  // [N, len], contiguous
  float* delta;      // [N, len]
  float* mem_out;    // [N, len]
  int len, ld, group, first_block;
};

struct Args {
  Seg seg[kMaxSegs];
  int nseg, N;
  const float* theta_ptr[2];
  float theta_val[2];
  float qscale, qmin, qmax;  // qscale > 0: round group 0 onto the grid
  int* counts;               // [blocks, N + 2]
};

__device__ __forceinline__ float grid_round(float v, float scale, float lo,
                                            float hi) {
  float q = __fdiv_rn(rintf(__fmul_rn(v, scale)), scale);
  // torch.clamp: NaN stays NaN
  return q < lo ? lo : (q > hi ? hi : q);
}

__global__ void __launch_bounds__(kTile)
    delta_unit_kernel(const __grid_constant__ Args a) {
  extern __shared__ int cnt[];  // [N] per-slot nonzero counts of the block
  __shared__ int uni;
  const int b = blockIdx.x;
  int j = 0;
  while (j + 1 < a.nseg && b >= a.seg[j + 1].first_block) ++j;
  const Seg sg = a.seg[j];
  const int N = a.N;
  for (int n = threadIdx.x; n < N; n += kTile) cnt[n] = 0;
  if (threadIdx.x == 0) uni = 0;
  __syncthreads();

  const int col = (b - sg.first_block) * kTile + threadIdx.x;
  const bool in = col < sg.len;
  const int g = sg.group;
  const float theta =
      a.theta_ptr[g] != nullptr ? *a.theta_ptr[g] : a.theta_val[g];
  const bool quant = g == 0 && a.qscale > 0.0f;
  const int lane = threadIdx.x & 31;
  int any = 0;
  for (int n = 0; n < N; ++n) {
    int nz = 0;
    if (in) {
      float s = sg.s[(size_t)n * sg.ld + col];
      if (quant) s = grid_round(s, a.qscale, a.qmin, a.qmax);
      const size_t o = (size_t)n * sg.len + col;
      const float m = sg.mem[o];
      const float raw = __fsub_rn(s, m);
      const bool fired = fabsf(raw) >= theta;
      const float d = fired ? raw : 0.0f;
      sg.delta[o] = d;
      sg.mem_out[o] = fired ? s : m;
      nz = d != 0.0f;
    }
    any |= nz;
    const unsigned bal = __ballot_sync(0xffffffffu, nz);
    if (lane == 0 && bal) atomicAdd(&cnt[n], __popc(bal));
  }
  const unsigned ub = __ballot_sync(0xffffffffu, any);
  if (lane == 0 && ub) atomicAdd(&uni, __popc(ub));
  __syncthreads();
  int* row = a.counts + (size_t)b * (N + 2);
  for (int n = threadIdx.x; n < N; n += kTile) row[n] = cnt[n];
  if (threadIdx.x == 0) {
    row[N] = uni;
    row[N + 1] = g;
  }
}

}  // namespace

// seg_table[nseg] (a Seg each): the segment's pointers (s may be
// row-strided, ld >= len; the others contiguous [N, len]), its group (0 or
// 1) and its first block (the blocks of the segments before it,
// ceil(len / 256) each, in order).
// theta_{x,h}_ptr: a device fp32 scalar, or null to take theta_{x,h}.
// qscale > 0 rounds group 0 onto the grid (scale, qmin, qmax) first.
// counts: [blocks, N + 2] int32, one row a block. Launches on `stream`
// and returns cudaGetLastError() (0 on success); arguments it cannot run
// return cudaErrorInvalidValue.
extern "C" int delta_unit_f32(const void* seg_table, int nseg, int N,
                              const void* theta_x_ptr, float theta_x,
                              const void* theta_h_ptr, float theta_h,
                              float qscale, float qmin, float qmax,
                              void* counts, int blocks, void* stream) {
  if (nseg < 1 || nseg > kMaxSegs || N < 1 || N > kMaxN || blocks < 0)
    return (int)cudaErrorInvalidValue;
  const Seg* segs = (const Seg*)seg_table;
  Args a{};
  int want = 0;
  for (int j = 0; j < nseg; ++j) {
    const Seg& s = segs[j];
    if (s.len < 0 || s.ld < s.len || (s.group != 0 && s.group != 1) ||
        s.first_block != want)
      return (int)cudaErrorInvalidValue;
    if (s.len > 0 && (!s.s || !s.mem || !s.delta || !s.mem_out))
      return (int)cudaErrorInvalidValue;
    want += (s.len + kTile - 1) / kTile;
    a.seg[j] = s;
  }
  if (want != blocks) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  a.nseg = nseg;
  a.N = N;
  a.theta_ptr[0] = (const float*)theta_x_ptr;
  a.theta_ptr[1] = (const float*)theta_h_ptr;
  a.theta_val[0] = theta_x;
  a.theta_val[1] = theta_h;
  a.qscale = qscale;
  a.qmin = qmin;
  a.qmax = qmax;
  a.counts = (int*)counts;
  const size_t smem = (size_t)N * sizeof(int);  // <= 32 KB: no opt-in
  delta_unit_kernel<<<blocks, kTile, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
