// The walk over fired column blocks shared by deltagru_seq.cu (fp32) and
// delta_q8.cu (int8 / int4): the Delta Unit prologue each thread block runs
// (stage the concatenated deltas of a chunk of streams in shared memory,
// mark the column blocks any of them fired, compact their ids), the warp
// reduction of the accumulators, and the sizing of a launch.
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

}  // namespace delta_walk
