// The walk over fired column blocks shared by the fused kernels: the Delta
// Unit prologue each thread block runs (stage the concatenated deltas of a
// chunk of streams in shared memory, mark the column blocks any of them
// fired, compact their ids), the warp reduction of the accumulators, and the
// sizing of a launch. The fp32 kernels (deltagru_seq.cu, deltalstm_seq.cu,
// delta_spmv.cu) use stage_fired_blocks and size_launch; the int8 / int4
// kernels (delta_q8.cu) use the one-round-trip prologue at the end of this
// file and take their launch plan from the host.
#pragma once

#include <cuda_runtime.h>

namespace delta_walk {

constexpr int kMaxB = 8;    // streams per pass (accumulators per lane)
constexpr int kWarps = 4;   // output rows per thread block

// Stage [dx | 0 | dh | 0] of streams b0 .. b0 + bc - 1 into d_s [bc][K] and
// write the ids of the block_k column blocks that any of them fired to
// ids[0 .. *n_active). Every thread of the block calls it; it returns after
// a barrier, with d_s, ids and *n_active visible to all.
__device__ __forceinline__ void stage_fired_blocks(
    const float* __restrict__ dx, const float* __restrict__ dh, float* d_s,
    int* fired, int* ids, int* n_active, int b0, int bc, int I, int H, int K,
    int ip, int block_k) {
  const int nbk = K / block_k;
  const int tid = threadIdx.x;
  for (int j = tid; j < nbk; j += blockDim.x) fired[j] = 0;
  __syncthreads();
  for (int idx = tid; idx < bc * K; idx += blockDim.x) {
    const int bb = idx / K;
    const int k = idx - bb * K;
    float v = 0.0f;
    if (k < ip) {
      if (k < I) v = dx[(size_t)(b0 + bb) * I + k];
    } else if (k - ip < H) {
      v = dh[(size_t)(b0 + bb) * H + (k - ip)];
    }
    d_s[idx] = v;
    if (v != 0.0f) fired[k / block_k] = 1;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int j = 0; j < nbk; ++j)
      if (fired[j]) ids[n++] = j;
    *n_active = n;
  }
  __syncthreads();
}

// Sum each accumulator over the 32 lanes of the warp (every lane gets it).
__device__ __forceinline__ void warp_sum(float (&acc)[kMaxB]) {
#pragma unroll
  for (int bb = 0; bb < kMaxB; ++bb)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[bb] += __shfl_xor_sync(0xffffffffu, acc[bb], off);
}

// Size a launch: the number of streams per pass (at most kMaxB) whose
// staged deltas fit the device's shared memory beside `extra` bytes the
// kernel keeps for itself, the dynamic shared memory it needs, and that size
// allowed on `kernel`. Returns a CUDA error code.
template <typename Kernel>
cudaError_t size_launch(Kernel kernel, int B, int K, int block_k, int* chunk,
                        size_t* smem, size_t extra = 0) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t fixed = 2 * (size_t)(K / block_k) * sizeof(int) + extra;
  int c = B < kMaxB ? B : kMaxB;
  while (c > 1 && (size_t)c * K * sizeof(float) + fixed > (size_t)max_smem)
    --c;
  *chunk = c;
  *smem = (size_t)c * K * sizeof(float) + fixed;
  if (*smem > (size_t)max_smem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

// -- The one-round-trip prologue of the int8 / int4 kernels ----------------
//
// Staged deltas keep 4 floats of padding after every 16 columns: eight lanes
// that read 16 bytes each from eight neighbouring 16-column segments then
// fall on eight different groups of banks.
__host__ __device__ __forceinline__ int dpos(int c) {
  return c + ((c >> 4) << 2);
}

// Floats one staged stream takes (a multiple of 4, so every row of the
// staged tile stays 16-byte aligned).
__host__ __device__ __forceinline__ int kpad(int K) {
  return K + ((K + 15) >> 4) * 4;
}

// Stage [dx | 0 | dh | 0] of streams b0 .. b0 + bc - 1 into d_s [bc][kpad(K)]
// (column c at dpos(c)) as 16-byte float4 slots, and write for every 32
// slots of the flattened [bc][K/4] slot space one word of vmask whose bit l
// says that slot 32w + l holds a nonzero delta (a warp vote, no shared store
// per thread). Each thread issues the loads of NL slots before it uses any of
// them. Every thread of the block calls it (blockDim.x a multiple of 32);
// there is no barrier inside: the caller syncs before reading d_s or vmask.
// Requires K % 4 == 0 and ip % 4 == 0; rows of dx (dh) load as float4 when I
// (H) is a multiple of 4, else element by element.
template <int NL>
__device__ __forceinline__ void stage_deltas(
    const float* __restrict__ dx, const float* __restrict__ dh, float* d_s,
    unsigned* vmask, int b0, int bc, int I, int H, int K, int ip) {
  const int k4 = K >> 2;
  const int total = bc * k4;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int stride = kpad(K);
  const bool vec_x = (I & 3) == 0, vec_h = (H & 3) == 0;
  for (int base = 0; base < total; base += NL * nt) {  // uniform in the block
    float4 v[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int s = base + i * nt + tid;
      v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (s < total) {
        const int bb = bc == 1 ? 0 : s / k4;
        const int k = (s - bb * k4) << 2;
        const float* src;
        int lim;
        bool vec;
        if (k < ip) {
          src = dx + (size_t)(b0 + bb) * I + k;
          lim = I - k;
          vec = vec_x;
        } else {
          src = dh + (size_t)(b0 + bb) * H + (k - ip);
          lim = H - (k - ip);
          vec = vec_h;
        }
        if (vec && lim >= 4) {
          v[i] = __ldg(reinterpret_cast<const float4*>(src));
        } else if (lim > 0) {
          v[i].x = __ldg(src);
          if (lim > 1) v[i].y = __ldg(src + 1);
          if (lim > 2) v[i].z = __ldg(src + 2);
          if (lim > 3) v[i].w = __ldg(src + 3);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int s = base + i * nt + tid;
      const bool nz = v[i].x != 0.0f || v[i].y != 0.0f || v[i].z != 0.0f ||
                      v[i].w != 0.0f;
      const unsigned bits = __ballot_sync(0xffffffffu, nz);
      if (s < total) {
        const int bb = bc == 1 ? 0 : s / k4;
        const int k = (s - bb * k4) << 2;
        *reinterpret_cast<float4*>(d_s + bb * stride + dpos(k)) = v[i];
      }
      const int s0 = s - (tid & 31);  // this warp's first slot
      if ((tid & 31) == 0 && s0 < total) vmask[s0 >> 5] = bits;
    }
  }
}

// Whether any of bits a .. a + n - 1 of vmask is set.
__device__ __forceinline__ bool any_bit(const unsigned* vmask, int a, int n) {
  const int end = a + n;
  for (int w = a >> 5; w <= (end - 1) >> 5; ++w) {
    const int lo = max(a - (w << 5), 0);
    const int hi = min(end - (w << 5), 32);
    const unsigned keep =
        (hi == 32 ? 0xffffffffu : (1u << hi) - 1u) & ~((1u << lo) - 1u);
    if (vmask[w] & keep) return true;
  }
  return false;
}

// This warp's list of the block_k column blocks that any of the bc staged
// streams fired, in increasing order, compacted by ballot and popcount 32
// blocks at a time into ids[0 .. n). Returns n (the same in every lane).
// Every lane of the warp calls it after the barrier that follows
// stage_deltas; it ends with __syncwarp, so ids is visible to the warp.
__device__ __forceinline__ int warp_fired_blocks(const unsigned* vmask,
                                                 int* ids, int bc, int K,
                                                 int block_k, int lane) {
  const int nbk = K / block_k, k4 = K >> 2, bk4 = block_k >> 2;
  int n = 0;
  for (int j0 = 0; j0 < nbk; j0 += 32) {
    const int j = j0 + lane;
    bool fired = false;
    if (j < nbk)
      for (int bb = 0; bb < bc && !fired; ++bb)
        fired = any_bit(vmask, bb * k4 + j * bk4, bk4);
    const unsigned m = __ballot_sync(0xffffffffu, fired);
    if (fired) ids[n + __popc(m & ((1u << lane) - 1u))] = j;
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

}  // namespace delta_walk
