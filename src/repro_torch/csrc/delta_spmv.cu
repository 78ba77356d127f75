// Block-column-skipping delta matvec for Hopper (sm_90a):
//   out[b, o] = acc[b, o] + sum_k dx[b, k] * w[o, k]
// reading only the block_k-wide column blocks of w in which some stream of
// dx fired; fp32 or bf16 weights and deltas, fp32 sums, the output in acc's
// type (w's without acc).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/delta_spmv.py::_kernel
// (pallas_call in delta_spmv). The TPU version prefetches the compacted
// fired block ids as scalars, walks the grid (o-block, k-step) in order and
// carries the sum across k in its output block; the accumulator is fp32.
//
// What bounds it on this card: the weight bytes of the fired column blocks.
// At batch 1 a call does 2 operations per fetched weight, far below any
// compute rate, so the bound is rows * fired columns * 4 (fp32) or 2 (bf16)
// bytes over memory bandwidth. One RWKV6 layer at D = 2048 is 50.9 MB of
// fp32 weights in four calls, one RG-LRU layer at W = 4096 is 268 MB, which
// never fits the 50 MB L2. On the LM main path most calls fire nothing at
// all (deep layers whose inputs stay below the threshold); those cost only
// the fixed cost of a launch and its prologue.
//
// What the design does about it:
// - One warp a row, kRows rows a block. Every block reads the whole of dx
//   to find the fired blocks (the one-barrier prologue of delta_walk.cuh:
//   16-byte delta loads issued first, fired flags by warp vote, each warp
//   compacting its own list by ballot), and a second wave of blocks pays
//   that prologue again; so the one-stream instance runs no more blocks
//   than the SMs hold at once (2 an SM at its registers), its warps taking
//   the rows in turn, two a warp at most (a 4096-row call: 264 blocks
//   instead of 512 in two waves). The tile instance runs one block a row
//   group.
// - Bytes in flight: the lanes of a warp read 16 bytes each along the row
//   (512 contiguous bytes a step), and a lane issues the loads of kUnroll
//   steps, 8 fired 128-column fp32 blocks (16 bf16), before its first
//   product: a fully fired 2048-column row takes 2 round trips, a 4096-column
//   one 4. With the weights beyond L2 (the RG-LRU layer) this register walk
//   already moves a fully fired layer faster than one cuBLAS addmm on the
//   H100 (PERF.md), so no TMA ring of row tiles was built.
// - A zero-fired fast path: a call whose deltas fire nothing reads no
//   weight, takes no cluster barrier and writes acc + 0 (the plain
//   version's bits) right after the one barrier of the prologue, each lane
//   storing the accumulator it loaded before it.
// - Accumulators sized to the streams: a one-stream instance (one
//   accumulator a lane) and the tile instance (kMaxB streams a pass), picked
//   by the host's launch plan; the narrow instance reads one element a lane
//   where a row or a block is not a whole number of 16-byte vectors (the
//   ragged edge of an unpacked [O, I] weight stays masked in the kernel).
// - A full card for narrow outputs: where the row groups are fewer than the
//   SMs (the 64-row RWKV6 decay call: 8 groups), the plan splits the k
//   blocks over `split` blocks of a thread-block cluster; each sums its
//   share and the cluster's first block adds the shares from the others'
//   shared memory (distributed shared memory) in rank order, in the same
//   launch, with no atomics: two launches give the same bits.
// Launch plans (instance, chunk, split, grid, rows, smem) come from the host
// (repro_torch/kernels/delta_spmv.py, spmv_launch_plan); the entry checks
// every plan against what the kernel lays out and makes no CUDA API query
// on a launch beyond the launch itself (the shared-memory attribute is set
// once per instance and device).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "delta_walk.cuh"

namespace {

namespace cg = cooperative_groups;
using delta_walk::bf16_bits_to_f32;
using delta_walk::dpos;
using delta_walk::kMaxB;

constexpr int kRows = 8;      // output rows (warps) a block
constexpr int kUnroll = 8;    // 16-byte loads a lane has in flight
constexpr int kMaxSplit = 8;  // blocks a cluster (the portable limit)
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

enum Instance { kOneStream = 0, kTile = 1, kNarrow = 2 };

struct SpmvArgs {
  const void* w;    // [>= O, ldw] float or bf16 bits
  const void* dx;   // [B, I] float or bf16 bits
  const void* acc;  // [B, O] float or bf16 bits, or null
  void* out;        // [B, O] float or bf16 bits
  int B, I, O, ldw, kp, block_k, chunk, split;
  int grid, rows;  // blocks of the launch, rows a warp walks at once
  int dx_bf16, acc_bf16, out_bf16;
};

// Dynamic shared memory of a launch: the staged deltas [chunk][kpad(kp)],
// the vote words, each warp's list of fired block ids and, for a split
// launch, each warp's partial sums [kRows][kMaxB]. Mirrored by
// spmv_smem_bytes in repro_torch/kernels/delta_spmv.py; the entry refuses
// a plan whose smem differs.
size_t smem_bytes(int kp, int block_k, int chunk, int split) {
  return (size_t)chunk * delta_walk::kpad(kp) * sizeof(float) +
         (size_t)((chunk * (kp / 4) + 31) / 32) * sizeof(unsigned) +
         (size_t)kRows * (kp / block_k) * sizeof(int) +
         (split > 1 ? (size_t)kRows * kMaxB * sizeof(float) : 0);
}

// Words of one lane's weight vector of VE elements of TW.
template <typename TW, int VE>
struct Vec {
  static constexpr int words = VE * (int)sizeof(TW) >= 4
                                   ? VE * (int)sizeof(TW) / 4
                                   : 1;
};

template <typename TW, int VE>
__device__ __forceinline__ void load_w(const TW* p,
                                       uint32_t (&r)[Vec<TW, VE>::words]) {
  if constexpr (VE * sizeof(TW) == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else if constexpr (sizeof(TW) == 4) {
    r[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    r[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// s + the products of one weight vector with the staged deltas d (the
// vector's first column at d[0]; a 16-column segment never splits a vector,
// so its columns sit side by side in d).
template <typename TW, int VE>
__device__ __forceinline__ float w_dot(const uint32_t (&r)[Vec<TW, VE>::words],
                                       const float* d, float s) {
  if constexpr (sizeof(TW) == 4) {
    if constexpr (VE == 4) {
      const float4 x = *reinterpret_cast<const float4*>(d);
      s = fmaf(x.x, __uint_as_float(r[0]), s);
      s = fmaf(x.y, __uint_as_float(r[1]), s);
      s = fmaf(x.z, __uint_as_float(r[2]), s);
      s = fmaf(x.w, __uint_as_float(r[3]), s);
    } else {
      s = fmaf(d[0], __uint_as_float(r[0]), s);
    }
  } else {
    if constexpr (VE == 8) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(d + 4 * q);
        s = fmaf(x.x, bf16_bits_to_f32(r[2 * q] & 0xffffu), s);
        s = fmaf(x.y, __uint_as_float(r[2 * q] & 0xffff0000u), s);
        s = fmaf(x.z, bf16_bits_to_f32(r[2 * q + 1] & 0xffffu), s);
        s = fmaf(x.w, __uint_as_float(r[2 * q + 1] & 0xffff0000u), s);
      }
    } else {
      s = fmaf(d[0], bf16_bits_to_f32(r[0]), s);
    }
  }
  return s;
}

__device__ __forceinline__ float load_acc(const SpmvArgs& a, size_t i) {
  return a.acc_bf16
             ? bf16_bits_to_f32(
                   __ldg(reinterpret_cast<const unsigned short*>(a.acc) + i))
             : __ldg(reinterpret_cast<const float*>(a.acc) + i);
}

__device__ __forceinline__ void store_out(const SpmvArgs& a, size_t i,
                                          float v) {
  if (a.out_bf16)
    reinterpret_cast<unsigned short*>(a.out)[i] =
        __bfloat16_as_ushort(__float2bfloat16_rn(v));
  else
    reinterpret_cast<float*>(a.out)[i] = v;
}

// Rows a warp of the one-stream instance may walk at once.
constexpr int kMaxRowsPerWarp = 2;

template <int NB>
struct Rows {  // rows a warp walks at once: several at one stream, else one
  static constexpr int max = NB == 1 ? kMaxRowsPerWarp : 1;
};

// Add this warp's fired blocks of its R rows (R <= 2, rows[r] the row's
// first weight, null past O) to acc[r * NB + b]: the lanes step over the
// (row, fired block, vector) triples 32 vectors at a time, kUnroll steps a
// group, every load of a group issued before its first product. A row's
// vectors stay in order (4 KB runs a group at fp32), and at low firing one
// group holds the loads of both rows. Vectors at or past ldw (the ragged
// edge of an unpacked row) are not read.
template <typename TW, int VE, int NB>
__device__ __forceinline__ void walk(const TW* const (&rows)[Rows<NB>::max],
                                     int R, const int* ids, int n,
                                     const float* d_s, int stride, int bc,
                                     int block_k, int ldw, int lane,
                                     float (&acc)[Rows<NB>::max * NB]) {
  const int L = block_k / VE;  // vectors a row has in a block
  const int lsh = (L & (L - 1)) == 0 ? __ffs(L) - 1 : -1;
  const int nl = n * L;  // vectors of one row
  const int total = nl * R;
  for (int u0 = 0; u0 < total; u0 += 32 * kUnroll) {
    uint32_t raw[kUnroll][Vec<TW, VE>::words];
    int col[kUnroll];  // 2 * column + row, or -1
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int u = u0 + 32 * t + lane;
      col[t] = -1;
      if (u < total) {
        const int r = u >= nl, rem = u - r * nl;
        const int j = lsh >= 0 ? rem >> lsh : rem / L;
        const int c = ids[j] * block_k + (rem - j * L) * VE;
        const TW* w_r = rows[Rows<NB>::max == 1 ? 0 : r];
        if (c < ldw && w_r != nullptr) {  // VE divides ldw when wide
          col[t] = 2 * c + r;
          load_w<TW, VE>(w_r + c, raw[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      if (col[t] >= 0) {
        const int p = dpos(col[t] >> 1), r = col[t] & 1;
        if constexpr (NB == 1) {
          const float sum = w_dot<TW, VE>(raw[t], d_s + p, 0.0f);
#pragma unroll
          for (int rr = 0; rr < Rows<NB>::max; ++rr)
            if (rr == r) acc[rr] += sum;
        } else {
#pragma unroll
          for (int bb = 0; bb < NB; ++bb)
            if (bb < bc)
              acc[bb] = w_dot<TW, VE>(raw[t], d_s + bb * stride + p, acc[bb]);
        }
      }
    }
  }
}

// Whether any of the first n_words vote words has a bit set (every lane
// gets the answer).
__device__ __forceinline__ bool any_fired(const unsigned* vmask, int n_words,
                                          int lane) {
  unsigned seen = 0;
  for (int i = lane; i < n_words; i += 32) seen |= vmask[i];
  return __any_sync(kFull, seen != 0);
}

// The grid and the rows come from the plan: gridDim.x / split groups of
// kRows warps, warp w of group g taking rows g * kRows + w + r * W (W the
// warps of the grid, r < a.rows), so a grid no larger than the blocks the
// SMs hold at once stages the deltas once a block and spreads the rows
// within one of even; a split launch has one row a warp.
template <typename TW, int VE, int NB>
__global__ void __launch_bounds__(kRows * 32)
    delta_spmv_kernel(const SpmvArgs a) {
  constexpr int RM = Rows<NB>::max;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = a.kp, nbk = kp / a.block_k;
  const int stride = delta_walk::kpad(kp);
  float* d_s = reinterpret_cast<float*>(smem);
  unsigned* vmask = reinterpret_cast<unsigned*>(d_s + a.chunk * stride);
  int* ids_all = reinterpret_cast<int*>(
      vmask + (a.chunk * (kp / 4) + 31) / 32);
  float* part = reinterpret_cast<float*>(ids_all + kRows * nbk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* ids = ids_all + warp * nbk;

  // a split launch runs clusters of `split` blocks along x: block s of a
  // cluster takes the k blocks j_lo .. j_hi - 1 of the cluster's rows
  const int split = a.split;
  cg::cluster_group cluster = cg::this_cluster();
  const int s = split > 1 ? (int)cluster.block_rank() : 0;
  const int o0 = (blockIdx.x / split) * kRows;  // this group's first row
  const int W = (gridDim.x / split) * kRows;
  const int R = a.rows;
  const int j_lo = s * nbk / split, j_hi = (s + 1) * nbk / split;
  const TW* rows[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int o = o0 + warp + r * W;
    rows[r] = r < R && o < a.O
                  ? reinterpret_cast<const TW*>(a.w) + (size_t)o * a.ldw
                  : nullptr;
  }
  // lane q finishes slot q: row q / NB of this warp, stream q % NB
  const int q_r = lane / NB, q_b = lane % NB;
  const int q_o = o0 + warp + q_r * W;

  for (int b0 = 0; b0 < a.B; b0 += a.chunk) {
    const int bc = min(a.chunk, a.B - b0);
    const bool mine_q = lane < RM * NB && q_r < R && q_b < bc && q_o < a.O;
    // its accumulator is loaded before anything waits on it
    const size_t idx = (size_t)(b0 + q_b) * a.O + q_o;
    float av = 0.0f;
    if (split == 1 && mine_q && a.acc != nullptr) av = load_acc(a, idx);

    // one operand: every column is an "x" column (ip = K = kp, H = 0)
    if (a.dx_bf16)
      delta_walk::stage_deltas<4>(
          reinterpret_cast<const uint16_t*>(a.dx),
          reinterpret_cast<const uint16_t*>(a.dx), d_s, vmask, b0, bc, a.I,
          0, kp, kp);
    else
      delta_walk::stage_deltas<4>(reinterpret_cast<const float*>(a.dx),
                                  reinterpret_cast<const float*>(a.dx), d_s,
                                  vmask, b0, bc, a.I, 0, kp, kp);
    __syncthreads();  // d_s and vmask visible to all
    if (!any_fired(vmask, (bc * (kp / 4) + 31) / 32, lane)) {
      // nothing fired in any stream (the same answer in every block): out =
      // acc + 0, no weight read, no cluster barrier; unsplit, each lane
      // stores the accumulator it loaded before the prologue
      if (split == 1) {
        if (mine_q) store_out(a, idx, av + 0.0f);
      } else if (s == 0) {
        for (int t = threadIdx.x; t < kRows * bc; t += blockDim.x) {
          const int r = t % kRows, bb = t / kRows;
          if (o0 + r < a.O) {
            const size_t i = (size_t)(b0 + bb) * a.O + o0 + r;
            store_out(a, i, (a.acc != nullptr ? load_acc(a, i) : 0.0f) + 0.0f);
          }
        }
      }
      if (b0 + a.chunk < a.B) __syncthreads();
      continue;
    }
    const int n = delta_walk::warp_fired_blocks(vmask, ids, bc, kp,
                                                a.block_k, lane, j_lo, j_hi);

    float acc[RM * NB];
#pragma unroll
    for (int i = 0; i < RM * NB; ++i) acc[i] = 0.0f;
    walk<TW, VE, NB>(rows, R, ids, n, d_s, stride, bc, a.block_k, a.ldw,
                     lane, acc);
    float mine = 0.0f;  // lane q: slot q's sum over this block's share
#pragma unroll
    for (int i = 0; i < RM * NB; ++i) {
      if (i / NB < R && i % NB < bc) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[i] += __shfl_xor_sync(kFull, acc[i], off);
        if (lane == i) mine = acc[i];
      }
    }

    if (split == 1) {
      if (mine_q) store_out(a, idx, av + mine);
    } else {
      if (lane < bc) part[warp * kMaxB + lane] = mine;
      cluster.sync();  // every share of the cluster written
      if (s == 0) {
        // thread r * kMaxB + b sums row o0 + r of stream b0 + b over the
        // shares in rank order
        const int r = threadIdx.x / kMaxB, bb = threadIdx.x % kMaxB;
        if (r < kRows && bb < bc && o0 + r < a.O) {
          float share[kMaxSplit];  // every remote read issued before the sum
#pragma unroll
          for (int q = 0; q < kMaxSplit; ++q)
            share[q] = q < split
                           ? cluster.map_shared_rank(part, q)[threadIdx.x]
                           : 0.0f;
          float sum = 0.0f;
#pragma unroll
          for (int q = 0; q < kMaxSplit; ++q)
            if (q < split) sum += share[q];
          const size_t i = (size_t)(b0 + bb) * a.O + o0 + r;
          store_out(a, i, (a.acc != nullptr ? load_acc(a, i) : 0.0f) + sum);
        }
      }
      cluster.sync();  // no block leaves (or restages) while rank 0 reads
    }
    if (b0 + a.chunk < a.B) __syncthreads();  // the next pass restages d_s
  }
}

template <typename TW, int VE, int NB>
int launch(const SpmvArgs& a, int smem, int device, cudaStream_t stream) {
  // the dynamic shared memory this instance may take, raised once per
  // device as plans ask for more (no CUDA API call on a launch that fits)
  static int allowed[kMaxDevices] = {};
  auto kernel = delta_spmv_kernel<TW, VE, NB>;
  if (smem > 48 * 1024) {
    if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidValue;
    if (smem > allowed[device]) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      allowed[device] = smem;
    }
  }
  const dim3 grid(a.grid), block(kRows * 32);
  if (a.split == 1) {
    kernel<<<grid, block, smem, stream>>>(a);
  } else {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename TW>
int launch_type(const SpmvArgs& a, int instance, int smem, int device,
                cudaStream_t s) {
  constexpr int wide = 16 / sizeof(TW);
  if (instance == kNarrow) return launch<TW, 1, kMaxB>(a, smem, device, s);
  if (instance == kOneStream) return launch<TW, wide, 1>(a, smem, device, s);
  return launch<TW, wide, kMaxB>(a, smem, device, s);
}

}  // namespace

// out [B, O] = acc [B, O] (or 0 when acc is null) + dx [B, I] @ w[:O, :I].T
// w: row-major with row stride ldw >= I and at least O rows (the packed
// layout: ldw = I rounded up to block_k; an unpacked [O, I] matrix: ldw = I).
// w_bf16, dx_bf16, acc_bf16, out_bf16: each operand's type, bf16 (1) or
// fp32 (0); contiguous, 16-byte aligned. instance (0 one-stream, 1 tile,
// 2 narrow), chunk (streams a pass), split (blocks a cluster shares the k
// blocks over), grid (blocks), rows (rows a warp walks at once: 1 or 2, 2
// only one-stream and unsplit), smem (dynamic shared memory,
// bytes) and device (the current device's index) are the host's launch
// plan. Requires block_k % 4 == 0.
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the kernel cannot run.
extern "C" int delta_spmv(const void* w, const void* dx, const void* acc,
                          void* out, int B, int I, int O, int ldw,
                          int block_k, int w_bf16, int dx_bf16, int acc_bf16,
                          int out_bf16, int instance, int chunk, int split,
                          int grid, int rows, int smem, int device,
                          void* stream) {
  if (B <= 0 || O <= 0) return 0;
  if (I <= 0 || block_k <= 0 || block_k % 4 || ldw < I)
    return (int)cudaErrorInvalidValue;
  const int kp = (I + block_k - 1) / block_k * block_k;
  const int ve = w_bf16 ? 8 : 4;  // elements of a 16-byte vector
  const bool wide =
      ldw % ve == 0 && block_k % ve == 0 && ((uintptr_t)w & 15) == 0;
  if (instance < kOneStream || instance > kNarrow ||
      (instance == kNarrow) == wide)
    return (int)cudaErrorInvalidValue;
  if (instance == kOneStream ? chunk != 1 : (chunk < 1 || chunk > kMaxB))
    return (int)cudaErrorInvalidValue;
  if (split < 1 || split > kMaxSplit || split > kp / block_k)
    return (int)cudaErrorInvalidValue;
  if (rows < 1 || rows > kMaxRowsPerWarp ||
      (rows > 1 && (instance != kOneStream || split > 1)) || grid < 1 ||
      grid % split || (long long)(grid / split) * kRows * rows < O)
    return (int)cudaErrorInvalidValue;
  if ((size_t)smem != smem_bytes(kp, block_k, chunk, split))
    return (int)cudaErrorInvalidValue;
  const SpmvArgs a{w,       dx,    acc,   out,  B,
                   I,       O,     ldw,   kp,   block_k,
                   chunk,   split, grid,  rows, dx_bf16,
                   acc != nullptr && acc_bf16, out_bf16};
  const cudaStream_t s = (cudaStream_t)stream;
  return w_bf16 ? launch_type<uint16_t>(a, instance, smem, device, s)
                : launch_type<float>(a, instance, smem, device, s);
}
