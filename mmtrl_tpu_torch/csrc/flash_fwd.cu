// Causal flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (mmtrl_tpu/ops/flash_attention.py,
// launched by `_fwd`): per query row, the causal online softmax over the keys
// up to that row, with S = scale * q.k in float32, O = softmax(S) V written in
// the input dtype and the row's logsumexp m + log(l) written in float32 for the
// backward kernels.  As in the TPU kernel, the probabilities are rounded to the
// input dtype for the PV product while l sums them in float32.  Nothing of size
// S x S goes to device memory.
//
// What bounds it on the H100: at the decision transformer's shapes (S = 90,
// head dim 128, B*H = 64 for serving and 512 for training; S = 1026 for the
// long context) the bytes that must move are 6-68 MB, i.e. 2-20 us at
// 3.35 TB/s, and the matrix products are 0.13-17 GFLOP, i.e. 0.1-17 us on the
// bf16 tensor cores.
//
// Design, simple and correct first: one warp per query row, `ROWS` rows (one
// block) share K/V tiles of 32 * KPL keys staged in shared memory as float32.
// Each lane scores its own keys (a float4 walk over the row; K rows are padded
// by 4 floats so the lanes' rows fall in distinct banks), the tile max and the
// running max/sum stay in registers, and each lane accumulates D / 32 output
// columns (one for D < 32, lanes past D idle) with the probabilities broadcast
// by warp shuffles.  Tiles strictly above a row's diagonal are skipped and the
// ragged tail is masked by bounds, so no padding is needed.  The products run
// on the CUDA cores and every FMA reads shared memory once, so the kernel is
// bound by shared-memory bandwidth well above the device-memory bound; tensor
// cores (mma / wgmma) and TMA are the next step.
#include "flash_common.cuh"

namespace {

using namespace flash;

// q, k, v, o: (BH, S, D) contiguous; lse: (BH, S).  Grid (ceil(S / ROWS), BH),
// ROWS warps per block.
template <typename T, int D, int ROWS, int KPL>
__global__ void __launch_bounds__(ROWS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int seq, float scale) {
  constexpr int kTile = 32 * KPL;  // keys per shared-memory tile
  constexpr int kKStride = D + 4;  // padded K row, in floats
  constexpr int kPer = Cols<D>::kPer;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // (ROWS, D)
  float* k_s = q_s + ROWS * D;                   // (kTile, D + 4)
  float* v_s = k_s + kTile * kKStride;           // (kTile, D)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool col_ok = Cols<D>::ok(lane);
  // Highest q-blocks see the most keys: schedule them first.
  const int row0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int row = row0 + warp;
  const int last_row = min(row0 + ROWS, seq) - 1;
  const bool active = row < seq;
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;

  load_rows<T, D>(q + head + static_cast<size_t>(row0) * D, q_s, last_row - row0 + 1, D);

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  float m = -INFINITY;  // running row max
  float l = 0.f;        // this lane's share of the running row sum

  for (int t0 = 0; t0 <= last_row; t0 += kTile) {
    const int n = min(kTile, seq - t0);
    __syncthreads();  // the previous tile is consumed (first pass: q_s is written)
    load_rows<T, D>(k + head + static_cast<size_t>(t0) * D, k_s, n, kKStride);
    load_rows<T, D>(v + head + static_cast<size_t>(t0) * D, v_s, n, D);
    __syncthreads();
    if (!active || t0 > row) continue;  // tile strictly above this row's diagonal

    float s[KPL];
    float tile_max = -INFINITY;
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      const int j = u * 32 + lane;
      s[u] = -INFINITY;
      if (t0 + j <= row) {  // causal mask; also keeps j < n
        s[u] = scale * dot_row<D>(q_s + warp * D, k_s + j * kKStride);
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
      const float pv = round_to<T>(p);  // p.astype(v.dtype) for the PV product
      const int nk = min(32, row - (t0 + u * 32) + 1);  // unmasked keys of this slot
      for (int j = 0; j < nk; ++j) {
        const float pj = __shfl_sync(kFull, pv, j);
        const float* vr = v_s + (u * 32 + j) * D + lane;
        if (col_ok) {
#pragma unroll
          for (int i = 0; i < kPer; ++i) acc[i] = fmaf(pj, vr[32 * i], acc[i]);
        }
      }
    }
    m = m_new;
  }

  if (!active) return;
  const float l_row = warp_sum(l);
  const float inv = 1.f / l_row;
  T* orow = o + head + static_cast<size_t>(row) * D + lane;
  if (col_ok) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) store(orow + 32 * i, acc[i] * inv);
  }
  if (lane == 0) lse[static_cast<size_t>(blockIdx.y) * seq + row] = m + logf(l_row);
}

struct Fwd {
  const void *q, *k, *v;
  void *o, *lse;
  int bh, seq;
  float scale;
  cudaStream_t stream;

  template <typename T, int D, int ROWS, int KPL>
  cudaError_t run() const {
    constexpr int kTile = 32 * KPL;
    const size_t smem = sizeof(float) * (ROWS * D + kTile * (D + 4) + kTile * D);
    return launch(flash_fwd_kernel<T, D, ROWS, KPL>, ROWS, seq, bh, smem, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
                  seq, scale);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; block_q query rows per block (one warp
// each), block_k keys per shared-memory tile.  Returns the launch's
// cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int bh, int seq, int d, int dtype, int block_q, int block_k,
                         float scale, void* stream) {
  const Fwd f{q, k, v, o, lse, bh, seq, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, d, block_q, block_k, bh, seq, f);
}
