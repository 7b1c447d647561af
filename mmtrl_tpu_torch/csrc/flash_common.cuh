// Pieces shared by the float32 CUDA-core kernels of flash_fwd.cu, flash_dq.cu
// and flash_dkv.cu: warp reductions, 16-byte row loads into shared memory, and
// the dispatch over head dim and block shape that the plain C launchers use.
#pragma once

#include <cuda_runtime.h>

namespace flash {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Copies rows [0, n) of a (rows, D) float32 slab into shared memory with row
// stride `stride` floats, 16 bytes at a time, all threads of the block taking
// part.
template <int D>
__device__ __forceinline__ void load_rows(const float* src, float* dst, int n, int stride) {
  constexpr int kRowChunks = D / 4;
  for (int c = threadIdx.x; c < n * kRowChunks; c += blockDim.x) {
    const int j = c / kRowChunks;
    const int col = (c % kRowChunks) * 4;
    *reinterpret_cast<float4*>(dst + j * stride + col) =
        *reinterpret_cast<const float4*>(src + static_cast<size_t>(j) * D + col);
  }
}

// Dot product of two float32 rows in shared memory, 16 bytes at a time.
template <int D>
__device__ __forceinline__ float dot_row(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 y = *reinterpret_cast<const float4*>(b + c);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// Output columns a lane owns: lane + 32 * i for i < kPer(D).  For D < 32
// lanes D..31 own none (col_ok false) and sit idle in the products.
template <int D>
struct Cols {
  static constexpr int kPer = D >= 32 ? D / 32 : 1;
  __device__ __forceinline__ static bool ok(int lane) { return D >= 32 || lane < D; }
};

// Calls F::template run<D, ROWS, KPL>() for the given head dim and block
// shape: rows per block in {4, 8, 16}, tile in {32, 64} rows.  Unsupported
// values give cudaErrorInvalidValue.
template <typename F, int D>
cudaError_t by_blocks(int rows, int tile, const F& f) {
#define FLASH_CASE(R, K) \
  if (rows == R && tile == K) return f.template run<D, R, K / 32>();
  FLASH_CASE(4, 32)
  FLASH_CASE(4, 64)
  FLASH_CASE(8, 32)
  FLASH_CASE(8, 64)
  FLASH_CASE(16, 32)
  FLASH_CASE(16, 64)
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}

// The float32 kernels' dispatch: their grid puts bh on y, so bh <= 65535.
template <typename F>
cudaError_t by_dim(int d, int rows, int tile, int bh, const F& f) {
  if (bh > 65535) return cudaErrorInvalidValue;
  if (d == 16) return by_blocks<F, 16>(rows, tile, f);
  if (d == 32) return by_blocks<F, 32>(rows, tile, f);
  if (d == 64) return by_blocks<F, 64>(rows, tile, f);
  if (d == 128) return by_blocks<F, 128>(rows, tile, f);
  return cudaErrorInvalidValue;
}

// Sets the dynamic shared memory a kernel needs, launches it on a grid of
// (ceil(seq / rows), bh) blocks of rows warps, and returns the launch error.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int rows, int seq, int bh, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + rows - 1) / rows, bh);
  kernel<<<grid, rows * 32, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace flash
