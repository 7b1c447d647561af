// Causal flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (mmtrl_tpu/ops/flash_attention.py,
// launched by `_fwd`): per query row, the causal online softmax over the keys
// up to that row, with S = scale * q.k in float32, O = softmax(S) V written in
// the input dtype and the row's logsumexp m + log(l) written in float32 for the
// backward kernels.  Nothing of size S x S goes to device memory.
//
// What bounds it on the H100: at the decision transformer's shapes (S = 90 for
// serving, S = 1026 for the long context, head dim 128, B*H = 64) the bytes
// that must move are 6-68 MB, i.e. 2-20 us at 3.35 TB/s, and the matrix
// products are 0.13-17 GFLOP, i.e. 0.1-17 us on the bf16 tensor cores.  At
// S = 90 the launch itself dominates.
//
// Design, simple and correct first: one warp per query row, `ROWS` rows (one
// block) share K/V tiles of 32 * KPL keys staged in shared memory as float32.
// Each lane scores its own keys (a float4 walk over the row; K rows are padded
// by 4 floats so the lanes' rows fall in distinct banks), the tile max and the
// running max/sum stay in registers, and each lane accumulates D / 32 output
// columns with the probabilities broadcast by warp shuffles.  Tiles strictly
// above a row's diagonal are skipped and the ragged tail is masked by bounds,
// so no padding is needed.  The products run on the CUDA cores and every FMA
// reads shared memory once, so the kernel is bound by shared-memory bandwidth
// well above the device-memory bound; tensor cores (mma / wgmma) and TMA are
// the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// q, k, v, o: (BH, S, D) contiguous; lse: (BH, S).  Grid (ceil(S / ROWS), BH),
// ROWS warps per block.
template <typename T, int D, int ROWS, int KPL>
__global__ void __launch_bounds__(ROWS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int seq, float scale) {
  constexpr int kTile = 32 * KPL;  // keys per shared-memory tile
  constexpr int kKStride = D + 4;  // padded K row, in floats
  constexpr int kPer = D / 32;     // output columns per lane
  constexpr int kChunk = Chunk<T>::kElems;
  constexpr int kRowChunks = D / kChunk;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // (ROWS, D)
  float* k_s = q_s + ROWS * D;                   // (kTile, D + 4)
  float* v_s = k_s + kTile * kKStride;           // (kTile, D)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Highest q-blocks see the most keys: schedule them first.
  const int row0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int row = row0 + warp;
  const int last_row = min(row0 + ROWS, seq) - 1;
  const bool active = row < seq;
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;

  if (active && lane < kRowChunks) {
    Chunk<T>::load(q + head + static_cast<size_t>(row) * D + lane * kChunk,
                   q_s + warp * D + lane * kChunk);
  }

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  float m = -INFINITY;  // running row max
  float l = 0.f;        // this lane's share of the running row sum

  for (int t0 = 0; t0 <= last_row; t0 += kTile) {
    const int n = min(kTile, seq - t0);
    __syncthreads();  // the previous tile is consumed (first pass: q_s is written)
    for (int c = threadIdx.x; c < n * kRowChunks; c += ROWS * 32) {
      const int j = c / kRowChunks;
      const int col = (c % kRowChunks) * kChunk;
      const size_t g = head + static_cast<size_t>(t0 + j) * D + col;
      Chunk<T>::load(k + g, k_s + j * kKStride + col);
      Chunk<T>::load(v + g, v_s + j * D + col);
    }
    __syncthreads();
    if (!active || t0 > row) continue;  // tile strictly above this row's diagonal

    float s[KPL];
    float tile_max = -INFINITY;
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      const int j = u * 32 + lane;
      s[u] = -INFINITY;
      if (t0 + j <= row) {  // causal mask; also keeps j < n
        const float* kr = k_s + j * kKStride;
        const float* qr = q_s + warp * D;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + c);
          const float4 qq = *reinterpret_cast<const float4*>(qr + c);
          dot = fmaf(qq.x, kk.x, dot);
          dot = fmaf(qq.y, kk.y, dot);
          dot = fmaf(qq.z, kk.z, dot);
          dot = fmaf(qq.w, kk.w, dot);
        }
        s[u] = scale * dot;
      }
      tile_max = fmaxf(tile_max, s[u]);
    }
    // Key t0 <= row is always unmasked, so m_new is finite from the first tile on.
    const float m_new = fmaxf(m, warp_max(tile_max));
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      const float p = expf(s[u] - m_new);
      l += p;
      const int nk = min(32, row - (t0 + u * 32) + 1);  // unmasked keys of this slot
      for (int j = 0; j < nk; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
        const float* vr = v_s + (u * 32 + j) * D + lane;
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i] = fmaf(pj, vr[32 * i], acc[i]);
      }
    }
    m = m_new;
  }

  if (!active) return;
  const float l_row = warp_sum(l);
  const float inv = 1.f / l_row;
  T* orow = o + head + static_cast<size_t>(row) * D + lane;
#pragma unroll
  for (int i = 0; i < kPer; ++i) store(orow + 32 * i, acc[i] * inv);
  if (lane == 0) lse[static_cast<size_t>(blockIdx.y) * seq + row] = m + logf(l_row);
}

template <typename T, int D, int ROWS, int KPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int seq, float scale, cudaStream_t stream) {
  constexpr int kTile = 32 * KPL;
  const int smem = static_cast<int>(sizeof(float) * (ROWS * D + kTile * (D + 4) + kTile * D));
  auto kernel = flash_fwd_kernel<T, D, ROWS, KPL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + ROWS - 1) / ROWS, bh);
  kernel<<<grid, ROWS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), seq, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_blocks(int block_q, int block_k, const void* q, const void* k, const void* v,
                      void* o, void* lse, int bh, int seq, float scale, cudaStream_t stream) {
#define FLASH_FWD_CASE(BQ, BK)                                                          \
  if (block_q == BQ && block_k == BK)                                                  \
    return launch<T, D, BQ, BK / 32>(q, k, v, o, lse, bh, seq, scale, stream);
  FLASH_FWD_CASE(4, 32)
  FLASH_FWD_CASE(4, 64)
  FLASH_FWD_CASE(8, 32)
  FLASH_FWD_CASE(8, 64)
  FLASH_FWD_CASE(16, 32)
  FLASH_FWD_CASE(16, 64)
#undef FLASH_FWD_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_dim(int d, int block_q, int block_k, const void* q, const void* k,
                   const void* v, void* o, void* lse, int bh, int seq, float scale,
                   cudaStream_t stream) {
  if (d == 64) return by_blocks<T, 64>(block_q, block_k, q, k, v, o, lse, bh, seq, scale, stream);
  if (d == 128) return by_blocks<T, 128>(block_q, block_k, q, k, v, o, lse, bh, seq, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int bh, int seq, int d, int dtype, int block_q, int block_k,
                         float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || seq <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_dim<float>(d, block_q, block_k, q, k, v, o, lse, bh, seq, scale, st);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(d, block_q, block_k, q, k, v, o, lse, bh, seq, scale, st);
  return cudaErrorInvalidValue;
}
