// Causal flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dkv_kernel` (mmtrl_tpu/ops/flash_attention.py,
// second `pallas_call` of `_bwd`): per key row j, over the query rows i >= j,
// with the probabilities recomputed from the saved float32 logsumexp,
//     p_ij  = exp(scale * q_i.k_j - lse_i)
//     dV_j  = sum_i round(p_ij) dO_i                      (`p.astype(do.dtype)`)
//     ds_ij = p_ij * (dO_i.v_j - delta_i)
//     dK_j  = scale * sum_i round(ds_ij) q_i              (`ds.astype(q.dtype)`)
// in float32, written in the input dtype.
//
// What bounds it on the H100: at the training shape (B*H = 512, S = 90,
// D = 128, bf16) it must read q, k, v, dO (47 MB) and write dK and dV
// (24 MB), about 21 us at 3.35 TB/s, while its 8 * D FLOPs per causal pair
// are 2.2 GFLOP, about 2 us on the tensor cores; at S = 1026 the FLOPs
// (35 GFLOP) set the bound instead.
//
// Design, the transpose of flash_dq.cu: one warp per key row, ROWS key rows a
// block with their K and V rows in shared memory, and tiles of 32 * KPL query
// rows (q, dO, lse, delta) staged in shared memory as float32, the q and dO
// rows padded by 4 floats.  Where the TPU kernel starts at the first query
// block that sees its key block (`first_qb`) and masks up to `first_full`, a
// block here starts its walk at its own first key row, the first query that
// can see any of its keys, and masks each pair i < j by bounds, as it masks
// the ragged tail.  Each lane scores its own query rows and accumulates D / 32
// columns of dK and dV with p and ds broadcast by warp shuffles.  Low key rows
// see the most queries, so their blocks are scheduled first.
#include "flash_common.cuh"

namespace {

using namespace flash;

// q, k, v, dout, dk, dv: (BH, S, D) contiguous; lse, delta: (BH, S) float32.
// Grid (ceil(S / ROWS), BH), ROWS warps per block.
template <typename T, int D, int ROWS, int KPL>
__global__ void __launch_bounds__(ROWS * 32)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                 int seq, float scale) {
  constexpr int kTile = 32 * KPL;  // query rows per shared-memory tile
  constexpr int kStride = D + 4;   // padded q and dO rows, in floats
  constexpr int kPer = Cols<D>::kPer;

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // (ROWS, D)
  float* v_s = k_s + ROWS * D;                   // (ROWS, D)
  float* q_s = v_s + ROWS * D;                   // (kTile, D + 4)
  float* do_s = q_s + kTile * kStride;           // (kTile, D + 4)
  float* lse_s = do_s + kTile * kStride;         // (kTile,)
  float* delta_s = lse_s + kTile;                // (kTile,)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool col_ok = Cols<D>::ok(lane);
  const int row0 = blockIdx.x * ROWS;
  const int key = row0 + warp;
  const bool active = key < seq;
  const size_t head = static_cast<size_t>(blockIdx.y) * seq * D;
  const size_t vec = static_cast<size_t>(blockIdx.y) * seq;

  const int nrows = min(row0 + ROWS, seq) - row0;
  load_rows<T, D>(k + head + static_cast<size_t>(row0) * D, k_s, nrows, D);
  load_rows<T, D>(v + head + static_cast<size_t>(row0) * D, v_s, nrows, D);

  float dk_acc[kPer], dv_acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // Queries before row0 see none of this block's keys.
  for (int t0 = row0; t0 < seq; t0 += kTile) {
    const int n = min(kTile, seq - t0);
    __syncthreads();  // the previous tile is consumed (first pass: k_s, v_s are written)
    load_rows<T, D>(q + head + static_cast<size_t>(t0) * D, q_s, n, kStride);
    load_rows<T, D>(dout + head + static_cast<size_t>(t0) * D, do_s, n, kStride);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      lse_s[i] = lse[vec + t0 + i];
      delta_s[i] = delta[vec + t0 + i];
    }
    __syncthreads();
    if (!active) continue;

    float p[KPL], ds[KPL];
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      const int i = u * 32 + lane;
      p[u] = ds[u] = 0.f;
      if (i < n && t0 + i >= key) {  // causal mask and ragged tail
        const float pr =
            expf(scale * dot_row<D>(q_s + i * kStride, k_s + warp * D) - lse_s[i]);
        const float dp = dot_row<D>(do_s + i * kStride, v_s + warp * D);
        p[u] = round_to<T>(pr);                      // p.astype(do.dtype)
        ds[u] = round_to<T>(pr * (dp - delta_s[i]));  // ds.astype(q.dtype)
      }
    }
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      const int first = max(0, key - (t0 + u * 32));  // queries before the key are masked
      const int last = min(32, n - u * 32);
      for (int j = first; j < last; ++j) {
        const float pj = __shfl_sync(kFull, p[u], j);
        const float dsj = __shfl_sync(kFull, ds[u], j);
        const float* qr = q_s + (u * 32 + j) * kStride + lane;
        const float* dr = do_s + (u * 32 + j) * kStride + lane;
        if (col_ok) {
#pragma unroll
          for (int c = 0; c < kPer; ++c) {
            dv_acc[c] = fmaf(pj, dr[32 * c], dv_acc[c]);
            dk_acc[c] = fmaf(dsj, qr[32 * c], dk_acc[c]);
          }
        }
      }
    }
  }

  if (!active || !col_ok) return;
  const size_t out = head + static_cast<size_t>(key) * D + lane;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    store(dk + out + 32 * c, dk_acc[c] * scale);
    store(dv + out + 32 * c, dv_acc[c]);
  }
}

struct Dkv {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dk, *dv;
  int bh, seq;
  float scale;
  cudaStream_t stream;

  template <typename T, int D, int ROWS, int KPL>
  cudaError_t run() const {
    constexpr int kTile = 32 * KPL;
    const size_t smem = sizeof(float) * (2 * ROWS * D + 2 * kTile * (D + 4) + 2 * kTile);
    return launch(flash_dkv_kernel<T, D, ROWS, KPL>, ROWS, seq, bh, smem, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<T*>(dk), static_cast<T*>(dv), seq, scale);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; block_q key rows per block (one warp
// each), block_k query rows per shared-memory tile.  Returns the launch's
// cudaError_t.
extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int bh,
                         int seq, int d, int dtype, int block_q, int block_k, float scale,
                         void* stream) {
  const Dkv f{q,  k,  v,   dout, lse,   delta,
              dk, dv, bh,  seq,  scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, d, block_q, block_k, bh, seq, f);
}
