// int8 / int4 fused delta-RNN layer steps for Hopper (sm_90a): the GRU and the
// LSTM cell, each in a plain and a buffered form.
//
// Replaces: the Pallas TPU kernels of src/repro/kernels/delta_q8.py at
// weight_bits 8 and 4:
//   _q8_gru_kernel       (public entry deltagru_q8_step),
//   _q8_gru_kernel_dbuf  (deltagru_q8_step(buffered=True)),
//   _q8_lstm_kernel      (deltalstm_q8_step),
//   _q8_lstm_kernel_dbuf (deltalstm_q8_step(buffered=True)).
// They compute the same function: walk only the fired block_k column blocks of
// the packed [G, Hp, K] volume of int8 codes (or [G, Hp, K/2] nibble-packed
// int4 codes), G = 3 gate rows for the GRU and 4 for the LSTM, and accumulate
// the unscaled code-domain products delta * code in fp32 (the PE's integer
// accumulator: every product and partial sum of Q8.8 deltas and small integer
// codes is exact, so any summation order gives the same bits). The GRU routes
// its candidate gate on the x/h seam into M_xc / M_hc; each LSTM gate takes
// both streams. Then dequantize b4 + s * M and run the activation stage on the
// Q8.8-input / Q1.4-output LUT grids:
//   GRU:  r, u = lut(sigmoid(q88(.))), c = lut(tanh(q88(xc + r * hc))),
//         h = q88((1 - u) * c + u * h_prev);
//   LSTM: i, f, o = lut(sigmoid(q88(.))), g = lut(tanh(q88(.))),
//         c = q88(f * c_prev + i * g)  (saturates at the Q8.8 rails, never
//         wraps), h = q88(o * lut(tanh(c))).
// The LSTM kernels take no h_prev: h = o * tanh(c) reads only the cell state.
//
// int4 layout (pack_nibbles): inside each block_k column block, byte j holds
// column j in its low nibble and column j + block_k/2 in its high nibble; a
// nibble n decodes as ((n & 15) ^ 8) - 8.
//
// What bounds it on this card: the fired weight bytes, G * Hp * block_k bytes
// per fired block at int8 (half that at int4), over memory bandwidth. At
// 2L-768H with every block fired a GRU step streams 5.6 MB (int8) or 2.8 MB
// (int4), an LSTM step 7.5 MB or 3.7 MB: 1.7 / 0.84 us and 2.2 / 1.1 us at
// 3.35 TB/s. The operations (2 per code per stream) are far below any compute
// rate at batch 1. Those bytes take less time than the fixed cost of a
// launch, so at batch 1 what sets the time is latency: the chain of dependent
// round trips between a launch's first load and its last store.
//
// What the design does about it (one warp per output row, kRows rows per
// thread block, so the 2L-768H grid is one wave of 96 blocks; every block
// compacts the fired blocks itself; no host sync):
// - Prologue of one round trip (delta_walk.cuh, stage_deltas and
//   warp_fired_blocks): each thread issues its 16-byte loads of
//   [dx | 0 | dh | 0] before it stores any; fired flags are warp votes, one
//   word per 32 slots; after the one barrier each warp compacts the fired
//   block ids itself by ballot and popcount, so no thread loops over the
//   blocks and no second barrier is needed.
// - A walk with many bytes in flight: the 8 lanes of a gate row read
//   16 bytes each, so one warp load covers a whole 128-column block of all
//   four LSTM gates (int8) or two fired blocks (int4, 64 bytes a gate row);
//   the walk issues kUnroll such loads per lane before the first product, so
//   the 12 fired blocks of a 1536-column layer cost 3 round trips, not 12.
//   The partial sums reduce over the 8 lanes of a gate (3 shuffles), and
//   the GRU's candidate row still routes by the block's side of the seam.
// - Accumulators sized to the streams: a one-stream instance (NB = 1: one
//   accumulator per lane, two for the GRU candidate) beside the tile
//   instance (NB = kMaxB streams a pass); the host picks by B. The operands
//   of the activation stage are loaded before the walk, so the tail adds no
//   round trip, and each gate's activation runs on its own lanes (lane
//   8 g + bb: gate g of stream bb), the blend on one of them, so the four
//   gates' sigmoid / tanh chains do not run one after another.
// - The buffered form is a pipeline: one producer lane fills a ring of
//   stages in shared memory, each stage one fired block's codes for every
//   row and gate of the thread block ([G][kRows][wbk]), with one tensor copy
//   (TMA) a block over w_q viewed as [G][Hp][row / box][box] bytes, which
//   completes on the stage's mbarrier (expect-tx bytes); the consumer warps
//   run the same walk on shared memory, wait on each stage's parity and
//   release it through a second mbarrier. The ring holds two unrolled groups
//   of the walk, so the copies of the next group fly while the warps sum the
//   current one. Nothing is copied when nothing fired. On the H100 with the
//   weights in L2 the tensor copies arrive later than the plain walk's
//   loads, at low and at full firing (PERF.md); the form is kept for parity
//   with the JAX package's buffered kernels.
// - Layouts whose block row is not a multiple of 16 bytes (int8 block_k 8 or
//   4, int4 block_k below 32 or not a multiple of 32) run a narrow-load
//   instance of the same template: 4 bytes (int8) or 2 bytes (int4) a lane.
//   Their buffered form cannot use tensor copies (16-byte rows); the whole
//   producer warp fills the same ring with cp.async copies of the widest of
//   8 or 4 bytes that divides the block row and the row stride, each lane's
//   copies completing on the stage's mbarrier (cp.async.mbarrier.arrive.
//   noinc), or, where a block row is 2 bytes wide (int4 block_k 4), with
//   plain loads and shared stores before a plain arrive. The consumers run
//   the narrow walk on the ring.
// Codes decode to floats exactly without a conversion instruction: a byte u
// (biased to unsigned) placed under the exponent bits 0x4B00 is 2^23 + u, and
// one add takes the bias off. The stage after the sum keeps the JAX package's
// op order and rounding exactly: no FMA contraction on the dequant, the
// candidate sum or the blends (__fmul_rn / __fadd_rn), IEEE expf / tanhf /
// division (no fast math), and rintf (half to even) for every grid rounding.
// Launch plans (instance, streams a pass, ring stages, shared memory) come
// from the host (repro_torch/kernels/delta_q8.py, q8_launch_plan); the entry
// points check them against what the kernel lays out, so a plan whose
// shared memory is not exactly smem_layout's total is refused.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "delta_walk.cuh"

namespace {

using delta_walk::dpos;
using delta_walk::kMaxB;

constexpr int kRows = 8;            // output rows (consumer warps) a block
constexpr int kUnroll = 4;          // walk steps a lane has in flight
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
// exact decode biases: 2^23 plus the code's offset to unsigned
constexpr float kBias8 = 8388736.0f;  // 2^23 + 128
constexpr float kBias4 = 8388616.0f;  // 2^23 + 8

enum Instance { kOneStream = 0, kTile = 1, kNarrow = 2 };
// how the producer of the buffered form fills a ring stage
enum Fill { kFillTensor = 0, kFillAsync = 1, kFillCopy = 2 };

struct Grid {  // a Qm.n grid: round(v * scale) / scale, clipped to [lo, hi]
  float scale, lo, hi;
};

__device__ __forceinline__ float grid_round(float v, Grid g) {
  const float q = __fdiv_rn(rintf(__fmul_rn(v, g.scale)), g.scale);
  return fminf(fmaxf(q, g.lo), g.hi);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// The activation stage shared by the kernels and the exhaustive grid check.
__device__ __forceinline__ float lut_sigmoid(float x, Grid act, Grid lut) {
  return grid_round(sigmoid_f(grid_round(x, act)), lut);
}

__device__ __forceinline__ float lut_tanh(float x, Grid act, Grid lut) {
  return grid_round(tanhf(grid_round(x, act)), lut);
}

// The operands of one layer step. s_prev is h_prev (GRU) or c_prev (LSTM);
// c_out is written by the LSTM only. chunk and stages come from the plan.
struct StepArgs {
  const int8_t* w_q;
  const float *scales, *b4, *m_prev, *s_prev, *dx, *dh;
  float *m_out, *h_out, *c_out;
  int B, I, H, Hp, K, ip, block_k, chunk, stages;
  int box;         // bytes of a tensor copy's box row (kFillTensor)
  int fill;        // Fill of the buffered form
  int copy_bytes;  // bytes of one copy (kFillAsync: 8 or 4; kFillCopy: 2)
  Grid act, lut;
};

// Bytes of one ring stage: a fired block's [G][kRows][wbk] codes, rounded up
// to the 128-byte alignment of a tensor copy's destination.
__host__ __device__ inline int stage_bytes(int G, int wbk) {
  return (G * kRows * wbk + 127) / 128 * 128;
}

// Where the dynamic shared memory of a launch goes, in bytes from its start:
// the ring of stages (buffered only), the full and empty mbarriers of each
// stage, the staged deltas [chunk][kpad(K)], the vote words and each warp's
// list of fired block ids. Mirrored by q8_smem_bytes in
// repro_torch/kernels/delta_q8.py; dispatch holds the two equal.
struct SmemLayout {
  size_t bars, deltas, mask, ids, total;
};

__host__ __device__ inline SmemLayout smem_layout(int G, int wbk, int K,
                                                  int block_k, int chunk,
                                                  int stages, int warps) {
  SmemLayout s;
  size_t off = (size_t)stages * stage_bytes(G, wbk);
  s.bars = off;
  off += (size_t)stages * 16;
  s.deltas = off;
  off += (size_t)chunk * delta_walk::kpad(K) * sizeof(float);
  s.mask = off;
  off += (size_t)((chunk * (K / 4) + 31) / 32) * sizeof(unsigned);
  s.ids = off;
  off += (size_t)warps * (K / block_k) * sizeof(int);
  s.total = off;
  return s;
}

// Fired blocks one unrolled group of the buffered walk may hold at once
// (8 * kUnroll vectors of a gate row, L vectors a block): the ring needs at
// least that many stages, or the producer would wait on a block the
// consumers cannot release yet.
__host__ __device__ inline int blocks_per_group(int L) {
  return (8 * kUnroll + L - 1) / L + ((8 * kUnroll) % L != 0);
}

// -- shared-memory barriers and tensor copies -------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One 8- or 4-byte copy from global to shared memory, asynchronous.
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes) {
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
}

// Arrive on mbarrier bar once this thread's earlier cp.async copies have
// landed (the arrival is one of the barrier's expected count).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// One tensor copy of the box at coordinates (x0, x1, x2, x3) of the
// tensor map into shared memory at dst, completing on mbarrier bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int x0,
                                            int x1, int x2, int x3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(x1), "r"(x2),
      "r"(x3), "r"(bar)
      : "memory");
}

// -- the walk -----------------------------------------------------------------

// Words a lane's vector of VW code bytes takes (VW = 16, 4 or 2).
template <int VW>
struct Vec {
  static constexpr int words = VW >= 4 ? VW / 4 : 1;
};

template <int VW, bool SMEM>
__device__ __forceinline__ void load_vec(const int8_t* p,
                                         uint32_t (&r)[Vec<VW>::words]) {
  if constexpr (VW == 16) {
    const uint4 v = SMEM ? *reinterpret_cast<const uint4*>(p)
                         : __ldg(reinterpret_cast<const uint4*>(p));
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else if constexpr (VW == 4) {
    r[0] = SMEM ? *reinterpret_cast<const unsigned int*>(p)
                : __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    r[0] = SMEM ? *reinterpret_cast<const unsigned short*>(p)
                : __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// Byte t of w, an unsigned code u, as the float 2^23 + u - bias (exact).
__device__ __forceinline__ float byte_f(uint32_t w, int t, float bias) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | t)) - bias;
}

// The codes of one vector as floats: int8, column i at wf[i]; int4, byte i's
// low nibble at wf[i] and its high nibble at wf[VW + i].
template <int BITS, int VW>
__device__ __forceinline__ void decode(const uint32_t (&r)[Vec<VW>::words],
                                       float (&wf)[BITS == 8 ? VW : 2 * VW]) {
  constexpr int per = VW >= 4 ? 4 : VW;  // code bytes a word holds
#pragma unroll
  for (int q = 0; q < Vec<VW>::words; ++q) {
    if constexpr (BITS == 8) {
      const uint32_t u = r[q] ^ 0x80808080u;
#pragma unroll
      for (int t = 0; t < per; ++t) wf[4 * q + t] = byte_f(u, t, kBias8);
    } else {
      const uint32_t lo = (r[q] & 0x0F0F0F0Fu) ^ 0x08080808u;
      const uint32_t hi = ((r[q] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
      for (int t = 0; t < per; ++t) {
        wf[4 * q + t] = byte_f(lo, t, kBias4);
        wf[VW + 4 * q + t] = byte_f(hi, t, kBias4);
      }
    }
  }
}

// Sum over one vector's columns of delta * code for one stream's staged
// deltas d: the columns from p_lo (and, at int4, the high nibbles' columns
// from p_hi), both dpos positions.
template <int BITS, int VW>
__device__ __forceinline__ float vec_dot(const float (&wf)[BITS == 8 ? VW
                                                                     : 2 * VW],
                                         const float* d, int p_lo, int p_hi) {
  float s = 0.0f;
  if constexpr (VW >= 4) {
#pragma unroll
    for (int q = 0; q < VW / 4; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(d + p_lo + 4 * q);
      s = fmaf(x.x, wf[4 * q], s);
      s = fmaf(x.y, wf[4 * q + 1], s);
      s = fmaf(x.z, wf[4 * q + 2], s);
      s = fmaf(x.w, wf[4 * q + 3], s);
    }
    if constexpr (BITS == 4) {
#pragma unroll
      for (int q = 0; q < VW / 4; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(d + p_hi + 4 * q);
        s = fmaf(x.x, wf[VW + 4 * q], s);
        s = fmaf(x.y, wf[VW + 4 * q + 1], s);
        s = fmaf(x.z, wf[VW + 4 * q + 2], s);
        s = fmaf(x.w, wf[VW + 4 * q + 3], s);
      }
    }
  } else {  // int4, 2 bytes: columns p_lo, p_lo + 1 and p_hi, p_hi + 1
    const float2 x = *reinterpret_cast<const float2*>(d + p_lo);
    const float2 y = *reinterpret_cast<const float2*>(d + p_hi);
    s = fmaf(x.x, wf[0], s);
    s = fmaf(x.y, wf[1], s);
    s = fmaf(y.x, wf[2], s);
    s = fmaf(y.y, wf[3], s);
  }
  return s;
}

// The ring of the buffered form, as the consumers and the producer see it.
struct Ring {
  const int8_t* base;  // stage 0; stage s at base + s * stage_bytes
  int stage_bytes, stages, qbase;  // qbase: blocks through the ring so far
  uint32_t full, empty;            // mbarrier of stage 0; stage s at + 8 s
};

// Add this warp's fired blocks to its output row o: lane l walks gate
// g = l / 8 (lanes past G * 8 idle), the 8 lanes of a gate stepping over the
// (fired block, vector) pairs of the gate row 8 vectors at a time, kUnroll
// steps a group: all loads of a group are issued before its first product.
// acc[bb] is this lane's gate memory for stream bb; acc_h[bb] takes the GRU
// candidate row's blocks right of the x/h seam (M_hc). BUF reads the ring
// (a stage holds [G][kRows][wbk]): each group waits for the stages of the
// blocks it touches and releases those it has finished.
template <int G, int BITS, int VW, int NB, bool BUF>
__device__ __forceinline__ void walk(const StepArgs& a, const Ring& ring,
                                     int warp, const int* ids, int n,
                                     const float* d_s, int stride, int bc,
                                     int o, int lane, float (&acc)[NB],
                                     float (&acc_h)[NB]) {
  constexpr int kCols = BITS == 8 ? VW : 2 * VW;
  const int g = lane >> 3, sub = lane & 7;
  const bool active = g < G;
  const int wbk = BITS == 8 ? a.block_k : a.block_k >> 1;
  const int L = wbk / VW;  // vectors a gate row has in a block
  const int lsh = (L & (L - 1)) == 0 ? __ffs(L) - 1 : -1;
  const int half = a.block_k >> 1;
  const int nbk_x = a.ip / a.block_k;
  const size_t row = BITS == 8 ? (size_t)a.K : (size_t)a.K / 2;
  const int8_t* src =
      BUF ? ring.base + (g * kRows + warp) * wbk
          : a.w_q + ((size_t)(active ? g : 0) * a.Hp + o) * row;
  const int total = n * L;
  int waited = 0, released = 0;
  for (int u0 = 0; u0 < total; u0 += 8 * kUnroll) {
    if constexpr (BUF) {
      const int last = min(n, (u0 + 8 * kUnroll + L - 1) / L);
      for (; waited < last; ++waited) {
        const int q = ring.qbase + waited;
        mbar_wait(ring.full + 8 * (q % ring.stages), (q / ring.stages) & 1);
      }
    }
    uint32_t raw[kUnroll][Vec<VW>::words];
    int kbs[kUnroll], vs[kUnroll];
    bool on[kUnroll];
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int u = u0 + 8 * t + sub;
      on[t] = active && u < total;
      kbs[t] = 0;
      vs[t] = 0;
      if (on[t]) {
        const int j = lsh >= 0 ? u >> lsh : u / L;
        const int v = u - j * L;
        const int kb = ids[j];
        const int8_t* p =
            BUF ? src + (size_t)((ring.qbase + j) % ring.stages) *
                            ring.stage_bytes + v * VW
                : src + (size_t)kb * wbk + v * VW;
        load_vec<VW, BUF>(p, raw[t]);
        kbs[t] = kb;
        vs[t] = v;
      }
    }
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      if (on[t]) {
        float wf[kCols];
        decode<BITS, VW>(raw[t], wf);
        const int c = kbs[t] * a.block_k + vs[t] * VW;
        const int p_lo = dpos(c), p_hi = dpos(c + half);
        const bool to_h = G == 3 && g == 2 && kbs[t] >= nbk_x;
#pragma unroll
        for (int bb = 0; bb < NB; ++bb) {
          if (bb < bc) {
            const float s =
                vec_dot<BITS, VW>(wf, d_s + bb * stride, p_lo, p_hi);
            if (to_h) acc_h[bb] += s;
            else acc[bb] += s;
          }
        }
      }
    }
    if constexpr (BUF) {
      const int done = min(n, (u0 + 8 * kUnroll) / L);
      __syncwarp();
      if (lane == 0)
        for (int j = released; j < done; ++j)
          mbar_arrive(ring.empty + 8 * ((ring.qbase + j) % ring.stages));
      released = done;
    }
  }
  if constexpr (BUF) {
    __syncwarp();
    if (lane == 0)
      for (int j = released; j < n; ++j)
        mbar_arrive(ring.empty + 8 * ((ring.qbase + j) % ring.stages));
  }
}

// The producer of the buffered form (lane 0 of the last warp): for each
// fired block in order, wait until its stage is free, announce the stage's
// bytes on its full barrier and copy the block's [G][kRows][wbk] codes with
// one tensor copy (rows past Hp arrive as zeros and are never read).
template <int G, int BITS>
__device__ __forceinline__ void produce(const StepArgs& a,
                                        const CUtensorMap* map,
                                        const Ring& ring, const int* ids,
                                        int n, int o0) {
  const int wbk = BITS == 8 ? a.block_k : a.block_k >> 1;
  const int parts = wbk / a.box;  // box-wide parts of a block row
  const uint32_t base = smem_u32(ring.base);
  for (int j = 0; j < n; ++j) {
    const int q = ring.qbase + j, s = q % ring.stages;
    if (q >= ring.stages)
      mbar_wait(ring.empty + 8 * s, ((q / ring.stages) - 1) & 1);
    mbar_arrive_expect_tx(ring.full + 8 * s, G * kRows * wbk);
    tma_load_4d(base + s * ring.stage_bytes, map, 0, ids[j] * parts, o0, 0,
                ring.full + 8 * s);
  }
}

// The producer of a narrow buffered layout (the whole last warp): for each
// fired block in order, wait until its stage is free, copy the block's
// [G][kRows][wbk] codes in copy_bytes pieces spread over the lanes (cp.async,
// or loads and shared stores at 2 bytes), and arrive on the stage's full
// barrier, whose count is the warp's 32 lanes (rows past Hp are not read).
template <int G, int BITS>
__device__ __forceinline__ void produce_copies(const StepArgs& a,
                                               const Ring& ring,
                                               const int* ids, int n, int o0,
                                               int lane) {
  const int wbk = BITS == 8 ? a.block_k : a.block_k >> 1;
  const size_t row = BITS == 8 ? (size_t)a.K : (size_t)a.K / 2;
  const int cw = a.copy_bytes;
  const int parts = wbk / cw;  // copies a block row takes
  const int total = G * kRows * parts;
  int8_t* ring_base = const_cast<int8_t*>(ring.base);
  for (int j = 0; j < n; ++j) {
    const int q = ring.qbase + j, s = q % ring.stages;
    if (q >= ring.stages)
      mbar_wait(ring.empty + 8 * s, ((q / ring.stages) - 1) & 1);
    const int8_t* blk = a.w_q + (size_t)ids[j] * wbk;
    int8_t* stage = ring_base + (size_t)s * ring.stage_bytes;
    for (int e = lane; e < total; e += 32) {
      const int r = e / parts, part = e - r * parts;  // r = g * kRows + row
      const int g = r / kRows, o = o0 + (r - g * kRows);
      if (o >= a.Hp) continue;
      const int8_t* src = blk + ((size_t)g * a.Hp + o) * row + part * cw;
      int8_t* dst = stage + r * wbk + part * cw;
      if (a.fill == kFillAsync)
        cp_async(smem_u32(dst), src, cw);
      else
        *reinterpret_cast<unsigned short*>(dst) =
            __ldg(reinterpret_cast<const unsigned short*>(src));
    }
    if (a.fill == kFillAsync) cp_async_arrive(ring.full + 8 * s);
    else mbar_arrive(ring.full + 8 * s);
  }
}

template <int G, int BITS, int VW, int NB, bool BUF>
__global__ void __launch_bounds__((kRows + BUF) * 32)
    delta_q8_kernel(const StepArgs a, const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = a.K, H = a.H, Hp = a.Hp;
  const int wbk = BITS == 8 ? a.block_k : a.block_k / 2;
  const int nbk = K / a.block_k;
  const int stride = delta_walk::kpad(K);
  const SmemLayout ly = smem_layout(G, wbk, K, a.block_k, a.chunk,
                                    BUF ? a.stages : 0, kRows + BUF);
  float* d_s = reinterpret_cast<float*>(smem + ly.deltas);
  unsigned* vmask = reinterpret_cast<unsigned*>(smem + ly.mask);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 3, sub = lane & 7;
  int* ids = reinterpret_cast<int*>(smem + ly.ids) + warp * nbk;
  const int o0 = blockIdx.x * kRows;
  const int o = o0 + warp;
  const int n_rows = min(kRows, H - o0);
  const bool consumer = warp < n_rows;  // a warp of an output row < H

  Ring ring{};
  if constexpr (BUF) {
    ring.base = reinterpret_cast<const int8_t*>(smem);
    ring.stage_bytes = stage_bytes(G, wbk);
    ring.stages = a.stages;
    ring.full = smem_u32(smem + ly.bars);
    ring.empty = ring.full + 8 * a.stages;
    if (threadIdx.x == 0) {
      for (int s = 0; s < a.stages; ++s) {
        mbar_init(ring.full + 8 * s, a.fill == kFillTensor ? 1 : 32);
        mbar_init(ring.empty + 8 * s, n_rows);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // the tensor map's fetch overlaps the prologue
    if (a.fill == kFillTensor && warp == kRows && lane == 0)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map))
                   : "memory");
    // the prologue's barrier publishes the barriers
  }

  for (int b0 = 0; b0 < a.B; b0 += a.chunk) {
    const int bc = min(a.chunk, a.B - b0);
    // Lane 8 g + bb finishes gate g of stream b0 + bb; its operands of the
    // activation stage are loaded before anything waits on them. The GRU's
    // candidate lanes also take M_hc; the lanes that blend (LSTM: gate 0,
    // GRU: the candidate) read the previous state.
    const bool gate_lane = consumer && g < G && sub < bc;
    const bool blender = gate_lane && g == (G == 3 ? 2 : 0);
    const size_t mb = (size_t)(b0 + sub) * 4 * H;
    const size_t hb = (size_t)(b0 + sub) * H + o;
    float mp = 0.0f, mp_h = 0.0f, sv = 0.0f, bv = 0.0f, bv_h = 0.0f;
    float sp = 0.0f;
    if (gate_lane) {
      mp = __ldg(a.m_prev + mb + g * H + o);
      sv = __ldg(a.scales + g * Hp + o);  // M_hc too takes the candidate's
      bv = __ldg(a.b4 + g * Hp + o);
      if (G == 3 && g == 2) {
        mp_h = __ldg(a.m_prev + mb + 3 * H + o);
        bv_h = __ldg(a.b4 + 3 * Hp + o);
      }
    }
    if (blender) sp = __ldg(a.s_prev + hb);

    delta_walk::stage_deltas<4>(a.dx, a.dh, d_s, vmask, b0, bc, a.I, H, K,
                                a.ip);
    __syncthreads();  // d_s, vmask (and the ring's barriers) visible to all
    const int n =
        delta_walk::warp_fired_blocks(vmask, ids, bc, K, a.block_k, lane);

    float acc[NB], acc_h[NB];
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) acc[bb] = acc_h[bb] = 0.0f;
    if constexpr (BUF) {
      if (warp == kRows) {
        if (a.fill != kFillTensor)
          produce_copies<G, BITS>(a, ring, ids, n, o0, lane);
        else if (lane == 0)
          produce<G, BITS>(a, &map, ring, ids, n, o0);
      } else if (consumer) {
        walk<G, BITS, VW, NB, true>(a, ring, warp, ids, n, d_s, stride, bc,
                                    o, lane, acc, acc_h);
      }
      ring.qbase += n;
    } else if (consumer) {
      walk<G, BITS, VW, NB, false>(a, ring, warp, ids, n, d_s, stride, bc, o,
                                   lane, acc, acc_h);
    }

    if (consumer) {
      // each gate's memory over its 8 lanes; lane 8 g + bb keeps stream bb's
      float mine = 0.0f, mine_h = 0.0f;
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        if (bb < bc) {
#pragma unroll
          for (int off = 4; off > 0; off >>= 1) {
            acc[bb] += __shfl_xor_sync(kFull, acc[bb], off);
            if (G == 3) acc_h[bb] += __shfl_xor_sync(kFull, acc_h[bb], off);
          }
          if (sub == bb) {
            mine = acc[bb];
            mine_h = acc_h[bb];
          }
        }
      }
      // activation, each gate on its own lanes: the same operations and
      // roundings on the same values as the JAX package's stage
      const float m = mp + mine;  // exact sums
      const float sc = __fadd_rn(bv, __fmul_rn(m, sv));
      if (gate_lane) a.m_out[mb + g * H + o] = m;
      if constexpr (G == 3) {
        // r and u on their lanes; the candidate lanes take M_hc (with the
        // candidate row's scale), then c and h
        const float m_h = mp_h + mine_h;  // exact sums
        const float sc_h = __fadd_rn(bv_h, __fmul_rn(m_h, sv));
        if (gate_lane && g == 2) a.m_out[mb + 3 * H + o] = m_h;
        const float ru = g < 2 ? lut_sigmoid(sc, a.act, a.lut) : 0.0f;
        const float r = __shfl_sync(kFull, ru, sub);
        const float u = __shfl_sync(kFull, ru, 8 + sub);
        if (blender) {
          const float c =
              lut_tanh(__fadd_rn(sc, __fmul_rn(r, sc_h)), a.act, a.lut);
          a.h_out[hb] = grid_round(
              __fadd_rn(__fmul_rn(__fsub_rn(1.0f, u), c), __fmul_rn(u, sp)),
              a.act);
        }
      } else {
        const float act = g == 2 ? lut_tanh(sc, a.act, a.lut)
                                 : lut_sigmoid(sc, a.act, a.lut);
        const float gi = __shfl_sync(kFull, act, sub);
        const float gf = __shfl_sync(kFull, act, 8 + sub);
        const float gg = __shfl_sync(kFull, act, 16 + sub);
        const float go = __shfl_sync(kFull, act, 24 + sub);
        if (blender) {
          // the saturating Q8.8 cell state; on the grid, so lut_tanh's own
          // rounding onto it changes nothing
          const float c = grid_round(
              __fadd_rn(__fmul_rn(gf, sp), __fmul_rn(gi, gg)), a.act);
          a.c_out[hb] = c;
          a.h_out[hb] =
              grid_round(__fmul_rn(go, lut_tanh(c, a.act, a.lut)), a.act);
        }
      }
    }
    if (b0 + a.chunk < a.B) __syncthreads();  // the next pass restages d_s
  }
}

__global__ void act_grid_kernel(float* sig, float* tnh, int n, int lo_code,
                                Grid act, Grid lut) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = __fdiv_rn((float)(lo_code + i), act.scale);  // exact
  sig[i] = lut_sigmoid(x, act, lut);
  tnh[i] = lut_tanh(x, act, lut);
}

__global__ void empty_kernel() {}

template <int G, int BITS, int VW, int NB, bool BUF>
int launch(const StepArgs& a, const CUtensorMap& map, int smem, int device,
           cudaStream_t stream) {
  // the dynamic shared memory this instance may take, raised once per
  // device as plans ask for more (no CUDA API call on a launch that fits)
  static int allowed[kMaxDevices] = {};
  auto kernel = delta_q8_kernel<G, BITS, VW, NB, BUF>;
  if (smem > 48 * 1024) {
    if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidValue;
    if (smem > allowed[device]) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      allowed[device] = smem;
    }
  }
  const dim3 grid((a.H + kRows - 1) / kRows);
  kernel<<<grid, (kRows + BUF) * 32, smem, stream>>>(a, map);
  return (int)cudaGetLastError();
}

template <int G, int BITS>
int launch_bits(const StepArgs& a, const CUtensorMap& map, int instance,
                int buffered, int smem, int device, cudaStream_t s) {
  constexpr int narrow = BITS == 8 ? 4 : 2;
  if (instance == kNarrow)
    return buffered
               ? launch<G, BITS, narrow, kMaxB, true>(a, map, smem, device, s)
               : launch<G, BITS, narrow, kMaxB, false>(a, map, smem, device,
                                                       s);
  if (instance == kOneStream)
    return buffered ? launch<G, BITS, 16, 1, true>(a, map, smem, device, s)
                    : launch<G, BITS, 16, 1, false>(a, map, smem, device, s);
  return buffered ? launch<G, BITS, 16, kMaxB, true>(a, map, smem, device, s)
                  : launch<G, BITS, 16, kMaxB, false>(a, map, smem, device, s);
}

// The widest box of a tensor copy (at most 256 bytes, a multiple of 16) that
// divides a block row of wbk bytes.
int box_bytes(int wbk) {
  for (int b = 256; b > 16; b -= 16)
    if (wbk % b == 0) return b;
  return 16;
}

// The tensor map of the buffered form: w_q as [G][Hp][row / box][box] bytes,
// its box one fired block of kRows rows and every gate, [G][kRows][wbk].
// The encoder comes from the driver once per process.
int encode_map(CUtensorMap* map, const StepArgs& a, int G, int wbk) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t row = (cuuint64_t)a.K * wbk / a.block_k;
  const cuuint64_t box = (cuuint64_t)a.box;
  const cuuint64_t dims[4] = {box, row / box, (cuuint64_t)a.Hp,
                              (cuuint64_t)G};
  const cuuint64_t strides[3] = {box, row, row * a.Hp};
  const cuuint32_t boxes[4] = {(cuuint32_t)box, (cuuint32_t)(wbk / box),
                               (cuuint32_t)kRows, (cuuint32_t)G};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(a.w_q),
      dims, strides, boxes, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Check a launch plan against the layout and what the kernel lays out, then
// launch the instance it names.
template <int G>
int dispatch(StepArgs a, int weight_bits, int buffered, int instance,
             int smem, int device, void* stream) {
  if (a.B <= 0 || a.H <= 0) return 0;
  if (a.block_k % 4 || a.K % a.block_k || a.ip % a.block_k ||
      (weight_bits != 8 && weight_bits != 4))
    return (int)cudaErrorInvalidValue;
  const int wbk = weight_bits == 8 ? a.block_k : a.block_k / 2;
  const bool wide = wbk % 16 == 0;
  if ((instance == kNarrow) == wide || instance < 0 || instance > kNarrow)
    return (int)cudaErrorInvalidValue;
  if (instance == kOneStream ? a.chunk != 1
                             : (a.chunk < 1 || a.chunk > kMaxB))
    return (int)cudaErrorInvalidValue;
  const int vw = wide ? 16 : (weight_bits == 8 ? 4 : 2);
  if (buffered ? (a.stages < 3 || a.stages < blocks_per_group(wbk / vw))
               : a.stages != 0)
    return (int)cudaErrorInvalidValue;
  const SmemLayout ly = smem_layout(G, wbk, a.K, a.block_k, a.chunk,
                                    a.stages, kRows + (buffered ? 1 : 0));
  if ((size_t)smem != ly.total) return (int)cudaErrorInvalidValue;
  CUtensorMap map{};
  if (buffered) {
    // tensor copies for 16-byte block rows; else the widest cp.async that
    // divides the block row and the row stride, else 2-byte plain copies
    const int row = weight_bits == 8 ? a.K : a.K / 2;
    a.fill = kFillCopy;
    a.copy_bytes = 2;
    for (int cw = 16; cw >= 4; cw /= 2) {
      if (wbk % cw == 0 && row % cw == 0) {
        a.fill = cw == 16 ? kFillTensor : kFillAsync;
        a.copy_bytes = cw;
        break;
      }
    }
    if (a.fill == kFillTensor) {
      a.box = box_bytes(wbk);
      const int err = encode_map(&map, a, G, wbk);
      if (err) return err;
    }
  }
  const cudaStream_t s = (cudaStream_t)stream;
  return weight_bits == 8
             ? launch_bits<G, 8>(a, map, instance, buffered, smem, device, s)
             : launch_bits<G, 4>(a, map, instance, buffered, smem, device, s);
}

StepArgs step_args(const void* w_q, const void* scales, const void* b4,
                   const void* m_prev, const void* s_prev, const void* dx,
                   const void* dh, void* m_out, void* h_out, void* c_out,
                   int B, int I, int H, int Hp, int K, int ip, int block_k,
                   int chunk, int stages, float act_scale, float act_min,
                   float act_max, float lut_scale, float lut_min,
                   float lut_max) {
  return StepArgs{(const int8_t*)w_q, (const float*)scales, (const float*)b4,
                  (const float*)m_prev, (const float*)s_prev,
                  (const float*)dx, (const float*)dh, (float*)m_out,
                  (float*)h_out, (float*)c_out, B, I, H, Hp, K, ip, block_k,
                  chunk, stages, 0, 0, 0, Grid{act_scale, act_min, act_max},
                  Grid{lut_scale, lut_min, lut_max}};
}

}  // namespace

// One int8 (weight_bits 8) or int4 (weight_bits 4) fused GRU layer step;
// buffered != 0 runs the buffered form (the same bits).
//   w_q int8 [3, Hp, K] or [3, Hp, K/2] (nibble-packed), scales f32 [3, Hp],
//   b4 f32 [4, Hp], m_prev/m_out f32 [B, 4H] (code domain), h_prev/h_out f32
//   [B, H], dx f32 [B, I], dh f32 [B, H]; contiguous, 16-byte aligned.
//   instance (0 one-stream, 1 tile, 2 narrow), chunk (streams a pass),
//   stages (0 unless buffered), smem (dynamic shared memory, bytes)
//   and device (the current device's index) are the host's launch plan.
// Requires block_k % 4 == 0 and K % block_k == 0. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan the kernel cannot
// run.
extern "C" int delta_q8_gru_step(
    const void* w_q, const void* scales, const void* b4, const void* m_prev,
    const void* h_prev, const void* dx, const void* dh, void* m_out,
    void* h_out, int B, int I, int H, int Hp, int K, int ip, int block_k,
    int weight_bits, int buffered, int instance, int chunk, int stages,
    int smem, int device, float act_scale, float act_min,
    float act_max, float lut_scale, float lut_min, float lut_max,
    void* stream) {
  return dispatch<3>(
      step_args(w_q, scales, b4, m_prev, h_prev, dx, dh, m_out, h_out,
                nullptr, B, I, H, Hp, K, ip, block_k, chunk, stages,
                act_scale, act_min, act_max, lut_scale, lut_min, lut_max),
      weight_bits, buffered, instance, smem, device, stream);
}

// One int8 / int4 fused LSTM layer step; buffered != 0 runs the buffered
// form (the same bits).
//   w_q int8 [4, Hp, K] or [4, Hp, K/2], scales f32 [4, Hp], b4 f32 [4, Hp],
//   m_prev/m_out f32 [B, 4H] (code domain), c_prev/c_out/h_out f32 [B, H]
//   (the cell state on the Q8.8 grid), dx f32 [B, I], dh f32 [B, H];
//   contiguous, 16-byte aligned. The plan and the requirements are those of
//   delta_q8_gru_step.
extern "C" int delta_q8_lstm_step(
    const void* w_q, const void* scales, const void* b4, const void* m_prev,
    const void* c_prev, const void* dx, const void* dh, void* m_out,
    void* h_out, void* c_out, int B, int I, int H, int Hp, int K, int ip,
    int block_k, int weight_bits, int buffered, int instance, int chunk,
    int stages, int smem, int device, float act_scale,
    float act_min, float act_max, float lut_scale, float lut_min,
    float lut_max, void* stream) {
  return dispatch<4>(
      step_args(w_q, scales, b4, m_prev, c_prev, dx, dh, m_out, h_out, c_out,
                B, I, H, Hp, K, ip, block_k, chunk, stages, act_scale,
                act_min, act_max, lut_scale, lut_min, lut_max),
      weight_bits, buffered, instance, smem, device, stream);
}

// The kernels' own activation stage over every point of the activation grid:
// sig[i] = lut(sigmoid(x)), tnh[i] = lut(tanh(x)) for x = (lo_code + i) /
// act_scale, i < n. Used to check the device's expf / tanhf exhaustively
// against the host's after the LUT rounding.
extern "C" int delta_q8_act_grid(void* sig, void* tnh, int n, int lo_code,
                                 float act_scale, float act_min,
                                 float act_max, float lut_scale,
                                 float lut_min, float lut_max, void* stream) {
  const Grid act{act_scale, act_min, act_max};
  const Grid lut{lut_scale, lut_min, lut_max};
  act_grid_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (float*)sig, (float*)tnh, n, lo_code, act, lut);
  return (int)cudaGetLastError();
}

// An empty kernel of this build, launched as blocks x threads: the floor
// under any launch of the steps above, for timing.
extern "C" int delta_q8_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
