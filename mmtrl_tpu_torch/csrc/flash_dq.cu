// Causal flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dq_kernel` (mmtrl_tpu/ops/flash_attention.py,
// first `pallas_call` of `_bwd`): per query row i, with the probabilities
// recomputed from the saved float32 logsumexp,
//     p_ij  = exp(scale * q_i.k_j - lse_i)          (j <= i)
//     dp_ij = dO_i . v_j
//     ds_ij = p_ij * (dp_ij - delta_i),  delta_i = dO_i . O_i
//     dQ_i  = scale * sum_j round(ds_ij) k_j
// in float32, with ds rounded to the input dtype before the product as the TPU
// kernel does (`ds.astype(k.dtype)`), and dQ written in the input dtype.
//
// What bounds it on the H100: at the training shape (B*H = 512, S = 90,
// D = 128, bf16) it must read q, k, v, dO (47 MB) and write dQ (12 MB), about
// 18 us at 3.35 TB/s, while its 6 * D FLOPs per causal pair are 1.6 GFLOP,
// under 2 us on the tensor cores; at S = 1026 the FLOPs (26 GFLOP) set the
// bound instead.
//
// Design, the forward kernel's (flash_fwd.cu): one warp per query row, ROWS
// rows a block, K and V tiles of 32 * KPL keys staged in shared memory as
// float32 with rows padded by 4 floats, so each lane can walk its own key's
// row without bank conflicts.  Each lane scores its own keys (q.k and dO.v),
// and each lane accumulates D / 32 columns of dQ with ds broadcast by warp
// shuffles.  Tiles above a row's diagonal are skipped and the ragged tail is
// masked by bounds.  Like the forward, it runs on the CUDA cores and is bound
// by shared-memory reads, far above the device-memory bound.
#include "flash_common.cuh"

namespace {

using namespace flash;

// q, k, v, dout, dq: (BH, S, D) contiguous; lse, delta: (BH, S) float32.
// Grid (ceil(S / ROWS), BH), ROWS warps per block.
template <typename T, int D, int ROWS, int KPL>
__global__ void __launch_bounds__(ROWS * 32)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int seq, float scale) {
  constexpr int kTile = 32 * KPL;  // keys per shared-memory tile
  constexpr int kStride = D + 4;   // padded K and V rows, in floats
  constexpr int kPer = Cols<D>::kPer;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // (ROWS, D)
  float* do_s = q_s + ROWS * D;                  // (ROWS, D)
  float* k_s = do_s + ROWS * D;                  // (kTile, D + 4)
  float* v_s = k_s + kTile * kStride;            // (kTile, D + 4)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool col_ok = Cols<D>::ok(lane);
  // Highest q-blocks see the most keys: schedule them first.
  const int row0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int row = row0 + warp;
  const int last_row = min(row0 + ROWS, seq) - 1;
  const bool active = row < seq;
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;
  const size_t vec = static_cast<size_t>(blockIdx.y) * seq;

  const int nrows = last_row - row0 + 1;
  load_rows<T, D>(q + head + static_cast<size_t>(row0) * D, q_s, nrows, D);
  load_rows<T, D>(dout + head + static_cast<size_t>(row0) * D, do_s, nrows, D);
  const float lse_r = active ? lse[vec + row] : 0.f;
  const float delta_r = active ? delta[vec + row] : 0.f;

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 <= last_row; t0 += kTile) {
    const int n = min(kTile, seq - t0);
    __syncthreads();  // the previous tile is consumed (first pass: q_s, do_s are written)
    load_rows<T, D>(k + head + static_cast<size_t>(t0) * D, k_s, n, kStride);
    load_rows<T, D>(v + head + static_cast<size_t>(t0) * D, v_s, n, kStride);
    __syncthreads();
    if (!active || t0 > row) continue;  // tile strictly above this row's diagonal

    float ds[KPL];
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      const int j = u * 32 + lane;
      ds[u] = 0.f;
      if (t0 + j <= row) {  // causal mask; also keeps j < n
        const float p = expf(scale * dot_row<D>(q_s + warp * D, k_s + j * kStride) - lse_r);
        const float dp = dot_row<D>(do_s + warp * D, v_s + j * kStride);
        ds[u] = round_to<T>(p * (dp - delta_r));  // ds.astype(k.dtype)
      }
    }
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      const int nk = min(32, row - (t0 + u * 32) + 1);  // unmasked keys of this slot
      for (int j = 0; j < nk; ++j) {
        const float dsj = __shfl_sync(kFull, ds[u], j);
        const float* kr = k_s + (u * 32 + j) * kStride + lane;
        if (col_ok) {
#pragma unroll
          for (int i = 0; i < kPer; ++i) acc[i] = fmaf(dsj, kr[32 * i], acc[i]);
        }
      }
    }
  }

  if (!active || !col_ok) return;
  T* out = dq + head + static_cast<size_t>(row) * D + lane;
#pragma unroll
  for (int i = 0; i < kPer; ++i) store(out + 32 * i, acc[i] * scale);
}

struct Dq {
  const void *q, *k, *v, *dout, *lse, *delta;
  void* dq;
  int bh, seq;
  float scale;
  cudaStream_t stream;

  template <typename T, int D, int ROWS, int KPL>
  cudaError_t run() const {
    constexpr int kTile = 32 * KPL;
    const size_t smem = sizeof(float) * (2 * ROWS * D + 2 * kTile * (D + 4));
    return launch(flash_dq_kernel<T, D, ROWS, KPL>, ROWS, seq, bh, smem, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<T*>(dq), seq, scale);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; block_q query rows per block (one warp
// each), block_k keys per shared-memory tile.  Returns the launch's
// cudaError_t.
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int bh, int seq, int d,
                        int dtype, int block_q, int block_k, float scale, void* stream) {
  const Dq f{q, k, v, dout, lse, delta, dq, bh, seq, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, d, block_q, block_k, bh, seq, f);
}
