// Pieces shared by the causal flash-attention kernels (flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu): warp reductions, 16-byte row loads into float32
// shared memory, stores and roundings in the input dtype, and the dispatch
// over dtype, head dim and block shape that the plain C launchers use.
#pragma once

#include <cuda_bf16.h>
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

// One 16-byte chunk of a row from device memory into float32 shared memory.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
    reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
    reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
  }
};

// Copies rows [0, n) of a (rows, D) slab into shared memory with row stride
// `stride` floats, all threads of the block taking part.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* src, float* dst, int n, int stride) {
  constexpr int kChunk = Chunk<T>::kElems;
  constexpr int kRowChunks = D / kChunk;
  for (int c = threadIdx.x; c < n * kRowChunks; c += blockDim.x) {
    const int j = c / kRowChunks;
    const int col = (c % kRowChunks) * kChunk;
    Chunk<T>::load(src + static_cast<size_t>(j) * D + col, dst + j * stride + col);
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// x rounded to T and back: the JAX kernels' `.astype(v.dtype)` before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Output columns a lane owns: lane + 32 * i for i < kPer(D).  For D < 32
// lanes D..31 own none (col_ok false) and sit idle in the products.
template <int D>
struct Cols {
  static constexpr int kPer = D >= 32 ? D / 32 : 1;
  __device__ __forceinline__ static bool ok(int lane) { return D >= 32 || lane < D; }
};

// Calls F::template run<T, D, ROWS, KPL>() for the given dtype code (0 =
// float32, 1 = bfloat16), head dim and block shape; rows per block in
// {4, 8, 16}, tile in {32, 64} rows.  Unsupported values give
// cudaErrorInvalidValue.
template <typename F, typename T, int D>
cudaError_t by_blocks(int rows, int tile, const F& f) {
#define FLASH_CASE(R, K) \
  if (rows == R && tile == K) return f.template run<T, D, R, K / 32>();
  FLASH_CASE(4, 32)
  FLASH_CASE(4, 64)
  FLASH_CASE(8, 32)
  FLASH_CASE(8, 64)
  FLASH_CASE(16, 32)
  FLASH_CASE(16, 64)
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}

template <typename F, typename T>
cudaError_t by_dim(int d, int rows, int tile, const F& f) {
  if (d == 16) return by_blocks<F, T, 16>(rows, tile, f);
  if (d == 32) return by_blocks<F, T, 32>(rows, tile, f);
  if (d == 64) return by_blocks<F, T, 64>(rows, tile, f);
  if (d == 128) return by_blocks<F, T, 128>(rows, tile, f);
  return cudaErrorInvalidValue;
}

template <typename F>
cudaError_t dispatch(int dtype, int d, int rows, int tile, int bh, int seq, const F& f) {
  if (bh <= 0 || bh > 65535 || seq <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) return by_dim<F, float>(d, rows, tile, f);
  if (dtype == 1) return by_dim<F, __nv_bfloat16>(d, rows, tile, f);
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
