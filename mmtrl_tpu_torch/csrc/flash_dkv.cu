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
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at the training
// shape (B*H = 512, S = 90, D = 128, bf16) it must read q, k, v, dO (47 MB)
// and write dK and dV (24 MB), 21.2 us, while its 8 * D FLOPs per causal pair
// are 2.2 GFLOP, about 2 us on the tensor cores: bound by bytes.  At the long
// shape (64, 1026, 128) the FLOPs (35 GFLOP, 34.9 us) bound it instead.
//
// Two kernels, by dtype, never one in place of the other:
//
// bfloat16: `dkv_sm90`, on the tensor cores, the transpose of the forward's
// `fwd_sm90` (flash_fwd.cu).  A block has one producer warp and one consumer
// warpgroup and is persistent: it walks work items (a tile of 64 key rows of
// one head), the lowest key tiles first since they see the most queries, in
// snake order.  The producer loads an item's K and V tiles once and streams
// the Q and dO tiles of 64 queries from the diagonal tile on through a ring of
// two stages with TMA; its 32 lanes also copy each Q tile's 64 lse (times
// log2 e) and delta values into the stage with plain loads bounded by seq, and
// the stage completes on one mbarrier when the TMA bytes have landed and all
// 32 lanes have arrived (a tensor map over the (B*H, S) float32 vectors is
// illegal at S = 90: TMA needs 16-byte global strides).  Per Q tile the
// consumer warpgroup computes, with the keys as the 64 rows of every product,
//     S^T  = K Q^T    and   dP^T = V dO^T     (wgmma m64n64, both K-major),
//     P^T  = exp2(S^T scale log2 e - lse log2 e),   dS^T = P^T (dP^T - delta),
// in float32 registers, rounds P^T and dS^T to bf16 into A fragments, and
//     dV  += P^T dO    and   dK  += dS^T Q        (wgmma m64nD, A from
// registers, dO and Q read MN-major from the same swizzled tiles that S^T and
// dP^T read K-major).  Only the diagonal tile is masked element by element,
// and the ragged last one by seq: those Q and dO rows load as zeros but
// their lse and delta are set to 0, so P and dS are set to 0 there
// explicitly.  K and V are released after an item's last S^T and dP^T, so
// the next item's loads overlap this one's last products and its epilogue.
// Each block owns its dK and dV rows: no atomics, and the result is
// deterministic.  The dK and dV accumulators (2 x D / 2 floats a thread) with
// S^T and dP^T (2 x 32) hold 231 registers a thread at D = 128, so one block
// runs on an SM, and each group of products is waited for before its results
// are read: the kernel is bound by that latency more than by bytes or FLOPs.
// Committing S^T and dP^T as two groups, so that P^T is computed while dP^T
// runs and dS^T while dV runs, measured 45-69% slower; a third ring stage
// measured 2% slower at the training shape and 3.5% faster at the long one
// (PERF.md).
//
// float32: `flash_dkv_kernel`, the CUDA-core kernel of the first port, built
// for float32 only, because a float32 wgmma computes in TF32 (about three
// decimal digits), which would break float32's agreement with the plain
// version to 1e-5: one warp per key row, ROWS key rows a block with their K
// and V rows in shared memory, and tiles of 32 * KPL query rows (q, dO, lse,
// delta) staged in shared memory, the q and dO rows padded by 4 floats.  A
// block starts its walk at its own first key row and masks each pair i < j and
// the ragged tail by bounds.  Each lane scores its own query rows and
// accumulates D / 32 columns of dK and dV with p and ds broadcast by warp
// shuffles.  It is bound by shared-memory reads, well above the device-memory
// bound.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace flash;

// ---- bfloat16: TMA + wgmma ---------------------------------------------------

constexpr int kBK = 64;  // key rows of an item: one consumer warpgroup
constexpr int kBQ = 64;  // queries of a Q or dO tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct DkvTiles {
  static constexpr int kThreads = 128 + 32;  // the consumers + the producer warp
  static constexpr int kStages = 2;
  static constexpr int kTileBytes = sm90::Tile<D>::kBytes;  // any of K, V, Q, dO
  // K and V, then per stage Q and dO, then per stage lse and delta (kBQ
  // floats each), then the barriers: K/V full and empty, per stage full and
  // empty.
  static constexpr int kVecOffset = (2 + 2 * kStages) * kTileBytes;
  static constexpr int kBarOffset = kVecOffset + kStages * 2 * kBQ * 4;
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (2 + 2 * kStages);
};

// q, k, v, dout: tensor maps over (BH, S, D) bf16 (sm90::bf16_head_map) with
// a box of 64 rows; lse, delta: (BH, S) float32; dk, dv: (BH, S, D) bf16.
template <int D>
__global__ void __launch_bounds__(DkvTiles<D>::kThreads, 1)
dkv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
         const float* __restrict__ lse, const float* __restrict__ delta,
         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int bh, int seq,
         float scale) {
  using L = DkvTiles<D>;
  constexpr int kStages = L::kStages;
  constexpr int T = L::kTileBytes;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - sm90::smem_addr(smem_raw) % 1024) % 1024);
  uint8_t* k_s = base;
  uint8_t* v_s = base + T;
  auto q_s = [&](int st) { return base + (2 + 2 * st) * T; };
  auto do_s = [&](int st) { return q_s(st) + T; };  // dO follows Q in a stage
  auto lse_s = [&](int st) { return reinterpret_cast<float*>(base + L::kVecOffset) + st * 2 * kBQ; };
  auto delta_s = [&](int st) { return lse_s(st) + kBQ; };
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBarOffset);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = full + kStages;

  // Item i: key tile i / bh of head i % bh, the lowest key tiles first; its
  // Q tiles run from the diagonal one (the same rows) to the last.
  const int n_t = (seq + kBK - 1) / kBK;
  const int n_items = n_t * bh;
  auto item_k0 = [&](int i) { return i / bh * kBK; };
  auto item_tiles = [&](int i) { return n_t - i / bh; };

  if (threadIdx.x == 0) {
    sm90::tma_prefetch(&tq);
    sm90::tma_prefetch(&tk);
    sm90::tma_prefetch(&tv);
    sm90::tma_prefetch(&tdo);
    sm90::mbar_init(kv_full, 1);
    sm90::mbar_init(kv_empty, 128);
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(&full[st], 32);  // the producer's lanes; lane 0 also expects the bytes
      sm90::mbar_init(&empty[st], 128);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // Tile g counts the Q (and dO) tiles of this block over all its items: it
  // sits in stage g % kStages, in that stage's use g / kStages.
  if (warp == 4) {  // the producer warp: lane 0 issues the TMA loads
    int g0 = 0;     // tiles of the earlier items
    for (int n = 0, i = sm90::snake_item(0); i < n_items; i = sm90::snake_item(++n)) {
      const int head = i % bh;
      const int k0 = item_k0(i);
      const int n_tiles = item_tiles(i);
      if (lane == 0) {
        if (n > 0) sm90::mbar_wait(kv_empty, (n - 1) & 1);
        sm90::mbar_expect_tx(kv_full, 2 * T);
        sm90::tma_load_tile<D>(k_s, &tk, kv_full, k0, head);
        sm90::tma_load_tile<D>(v_s, &tv, kv_full, k0, head);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int g = g0 + t, st = g % kStages;
        const int q0 = k0 + t * kBQ;
        if (g >= kStages) sm90::mbar_wait(&empty[st], (g / kStages - 1) & 1);
        const size_t vec = static_cast<size_t>(head) * seq;
        for (int c = lane; c < kBQ; c += 32) {
          const bool in = q0 + c < seq;
          lse_s(st)[c] = in ? lse[vec + q0 + c] * kLog2e : 0.f;
          delta_s(st)[c] = in ? delta[vec + q0 + c] : 0.f;
        }
        if (lane == 0) {
          sm90::mbar_expect_tx(&full[st], 2 * T);
          sm90::tma_load_tile<D>(q_s(st), &tq, &full[st], q0, head);
          sm90::tma_load_tile<D>(do_s(st), &tdo, &full[st], q0, head);
        } else {
          sm90::mbar_arrive(&full[st]);
        }
      }
      g0 += n_tiles;
    }
    return;
  }

  // The consumer warpgroup: key rows k0 .. k0 + 63 of each item.  This thread
  // holds key rows key[0] and key[1] = key[0] + 8 of every accumulator, and
  // query columns 8 j + 2 quad + {0, 1} of S^T and dP^T.
  const int quad = lane % 4;
  const int row_off = 16 * warp + lane / 4;
  const float scale_log2 = scale * kLog2e;

  int g0 = 0;
  for (int n = 0, i = sm90::snake_item(0); i < n_items; i = sm90::snake_item(++n)) {
    const int k0 = item_k0(i);
    const int head = i % bh;
    const int n_tiles = item_tiles(i);
    const int key[2] = {k0 + row_off, k0 + row_off + 8};

    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc_k[x] = acc_v[x] = 0.f;

    sm90::mbar_wait(kv_full, n & 1);
    for (int t = 0; t < n_tiles; ++t) {
      const int g = g0 + t, st = g % kStages;
      const int q0 = k0 + t * kBQ;

      // S^T = K Q^T and dP^T = V dO^T; then K and V are free after the
      // item's last tile.
      float s[32], dp[32];
      sm90::mbar_wait(&full[st], (g / kStages) & 1);
      sm90::wgmma_fence();
      sm90::wgmma_abt<D>(s, k_s, q_s(st));
      sm90::wgmma_abt<D>(dp, v_s, do_s(st));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      if (t + 1 == n_tiles) sm90::mbar_arrive(kv_empty);

      // P^T and dS^T in float32, masked, rounded to bf16 A fragments.
      const bool edge = t == 0 || q0 + kBQ > seq;  // the diagonal tile, or past seq
      const float* lse_t = lse_s(st);
      const float* delta_t = delta_s(st);
      uint32_t p[4][4], ds[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * quad;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_t + col);
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = exp2f(s[4 * j + e] * scale_log2 - (e % 2 ? l2.y : l2.x));
          pv[e] = x;
          dsv[e] = x * (dp[4 * j + e] - (e % 2 ? d2.y : d2.x));
          if (edge) {
            const int qi = q0 + col + e % 2;
            if (qi < key[e / 2] || qi >= seq) pv[e] = dsv[e] = 0.f;
          }
        }
        // A fragment of k-step j / 2: key rows g and g + 8, queries +0..7
        // then +8..15
        p[j / 2][2 * (j % 2)] = sm90::pack_bf16(pv[0], pv[1]);
        p[j / 2][2 * (j % 2) + 1] = sm90::pack_bf16(pv[2], pv[3]);
        ds[j / 2][2 * (j % 2)] = sm90::pack_bf16(dsv[0], dsv[1]);
        ds[j / 2][2 * (j % 2) + 1] = sm90::pack_bf16(dsv[2], dsv[3]);
      }

      // dV += P^T dO and dK += dS^T Q, then the stage is free.
      sm90::wgmma_fence();
      sm90::wgmma_ab<D>(acc_v, p, do_s(st));
      sm90::wgmma_ab<D>(acc_k, ds, q_s(st));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc_v);
      sm90::fence_regs(acc_k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::fence_regs(p[kk]);
        sm90::fence_regs(ds[kk]);
      }
      sm90::mbar_arrive(&empty[st]);
    }

    // Epilogue: dK * scale and dV in bf16, key rows < seq only.
    const size_t head_off = static_cast<size_t>(head) * seq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (key[h] >= seq) continue;
      const size_t row = (head_off + key[h]) * D + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * j) = __floats2bfloat162_rn(
            acc_k[4 * j + 2 * h] * scale, acc_k[4 * j + 2 * h + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * j) =
            __floats2bfloat162_rn(acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
      }
    }
    g0 += n_tiles;
  }
}

struct DkvSm90 {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dk, *dv;
  int bh, seq;
  float scale;
  cudaStream_t stream;

  template <int D>
  int run() const {
    using L = DkvTiles<D>;
    CUtensorMap tq, tk, tv, tdo;
    cudaError_t err = sm90::bf16_head_map(&tq, q, bh, seq, D, kBQ);
    if (err == cudaSuccess) err = sm90::bf16_head_map(&tk, k, bh, seq, D, kBK);
    if (err == cudaSuccess) err = sm90::bf16_head_map(&tv, v, bh, seq, D, kBK);
    if (err == cudaSuccess) err = sm90::bf16_head_map(&tdo, dout, bh, seq, D, kBQ);
    if (err != cudaSuccess) return err;
    auto kernel = dkv_sm90<D>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kSmem));
    if (err != cudaSuccess) return err;
    static const int resident = sm90::resident_blocks(kernel, L::kThreads, L::kSmem);
    if (resident <= 0) return cudaErrorInvalidConfiguration;
    const int items = (seq + kBK - 1) / kBK * bh;
    kernel<<<min(items, resident), L::kThreads, L::kSmem, stream>>>(
        tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), bh, seq, scale);
    return cudaGetLastError();
  }
};

struct DkvSmem {
  template <int D>
  int run() const {
    return static_cast<int>(DkvTiles<D>::kSmem);
  }
};

// ---- float32: CUDA cores -----------------------------------------------------

// q, k, v, dout, dk, dv: (BH, S, D) float32 contiguous; lse, delta: (BH, S).
// Grid (ceil(S / ROWS), BH), ROWS warps per block.
template <int D, int ROWS, int KPL>
__global__ void __launch_bounds__(ROWS * 32)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int seq, float scale) {
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
  load_rows<D>(k + head + static_cast<size_t>(row0) * D, k_s, nrows, D);
  load_rows<D>(v + head + static_cast<size_t>(row0) * D, v_s, nrows, D);

  float dk_acc[kPer], dv_acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // Queries before row0 see none of this block's keys.
  for (int t0 = row0; t0 < seq; t0 += kTile) {
    const int n = min(kTile, seq - t0);
    __syncthreads();  // the previous tile is consumed (first pass: k_s, v_s are written)
    load_rows<D>(q + head + static_cast<size_t>(t0) * D, q_s, n, kStride);
    load_rows<D>(dout + head + static_cast<size_t>(t0) * D, do_s, n, kStride);
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
        p[u] = pr;  // float32: p.astype(do.dtype) and ds.astype(q.dtype) keep it as it is
        ds[u] = pr * (dp - delta_s[i]);
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
    dk[out + 32 * c] = dk_acc[c] * scale;
    dv[out + 32 * c] = dv_acc[c];
  }
}

struct Dkv {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dk, *dv;
  int bh, seq;
  float scale;
  cudaStream_t stream;

  template <int D, int ROWS, int KPL>
  cudaError_t run() const {
    constexpr int kTile = 32 * KPL;
    const size_t smem = sizeof(float) * (2 * ROWS * D + 2 * kTile * (D + 4) + 2 * kTile);
    return launch(flash_dkv_kernel<D, ROWS, KPL>, ROWS, seq, bh, smem, stream,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dout),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<float*>(dk), static_cast<float*>(dv), seq, scale);
  }
};

}  // namespace

// dtype: 0 = float32, the CUDA-core kernel with block_q key rows per block
// (one warp each) in {4, 8, 16} and block_k queries per shared-memory tile in
// {32, 64}, on a grid whose y is bh (so bh <= 65535); 1 = bfloat16, the
// tensor-core kernel, whose one tile is block_q = 64 key rows by block_k = 64
// queries, on a 1-D persistent grid.  Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a shape or block it does not take).
extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int bh,
                         int seq, int d, int dtype, int block_q, int block_k, float scale,
                         void* stream) {
  if (bh <= 0 || seq <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return by_dim(d, block_q, block_k, bh,
                  Dkv{q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, s});
  }
  if (dtype != 1 || block_q != kBK || block_k != kBQ) return cudaErrorInvalidValue;
  return sm90::by_head_dim(d, cudaErrorInvalidValue,
                           DkvSm90{q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, s});
}

// Dynamic shared memory, in bytes, of the bf16 kernel at head dim d; -1 for
// a head dim it does not take.
extern "C" int flash_dkv_bf16_smem(int d) { return sm90::by_head_dim(d, -1, DkvSmem{}); }
