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
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at the training
// shape (B*H = 512, S = 90, D = 128, bf16) it must read q, k, v, dO (47 MB)
// and write dQ (12 MB), 17.7 us, while its 6 * D FLOPs per causal pair are
// 1.6 GFLOP, under 2 us on the tensor cores: bound by bytes.  At the long
// shape (64, 1026, 128) the FLOPs (26 GFLOP, 26.2 us) bound it instead.
//
// Two kernels, by dtype, never one in place of the other:
//
// bfloat16: `dq_sm90`, on the tensor cores: the forward's `fwd_sm90`
// (flash_fwd.cu) with a second score product and no online softmax.  A block
// has one producer warp and one consumer warpgroup and is persistent: it walks
// work items (a tile of 64 query rows of one head), the highest query tiles
// first since they see the most keys, in snake order.  The producer loads an
// item's Q and dO tiles once and streams the K and V tiles of 64 keys up to
// the diagonal through a ring of two stages with TMA, each stage completing on
// an mbarrier; the consumers read the item's 2 rows of lse and delta a thread
// once, bounded by seq.  Per key tile the consumer warpgroup computes
//     S  = Q K^T   and   dP = dO V^T            (wgmma m64n64, both K-major),
//     dS = exp2(S scale log2 e - lse log2 e) (dP - delta)
// in float32 registers (P comes from the saved lse, so no running max or sum
// is kept), rounds dS to bf16 into A fragments, and
//     dQ += dS K                                (wgmma m64nD, A from
// registers, K read MN-major as the forward reads V).  Only the diagonal tile
// is masked element by element; the keys past seq lie above every valid
// row's diagonal, and rows past seq are never written.  Q and dO are released
// after an item's last S and dP, so the next item's loads overlap this one's
// last product and its epilogue.  The dQ accumulator (D / 2 floats a thread)
// with S and dP (2 x 32) hold 158 registers a thread at D = 128, so two blocks
// share an SM and overlap each other's waits; each group of products is
// waited for before its results are read (computing P while dP runs measured
// no faster, PERF.md).
//
// float32: `flash_dq_kernel`, the CUDA-core kernel of the first port, built for
// float32 only, because a float32 wgmma computes in TF32 (about three decimal
// digits), which would break float32's agreement with the plain version to
// 1e-5: one warp per query row, ROWS rows a block, K and V tiles of 32 * KPL
// keys staged in shared memory with rows padded by 4 floats, so each lane can
// walk its own key's row without bank conflicts.  Each lane scores its own
// keys (q.k and dO.v), and each lane accumulates D / 32 columns of dQ with ds
// broadcast by warp shuffles.  Tiles above a row's diagonal are skipped and
// the ragged tail is masked by bounds.  It is bound by shared-memory reads,
// well above the device-memory bound.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace flash;

// ---- bfloat16: TMA + wgmma ---------------------------------------------------

constexpr int kBQ = 64;  // query rows of an item: one consumer warpgroup
constexpr int kBK = 64;  // keys of a K or V tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct DqTiles {
  static constexpr int kThreads = 128 + 32;  // the consumers + the producer warp
  static constexpr int kStages = 2;
  static constexpr int kTileBytes = sm90::Tile<D>::kBytes;  // any of Q, dO, K, V
  // Q and dO, then per stage K and V, then the barriers: Q/dO full and
  // empty, per stage full and empty.
  static constexpr int kBarOffset = (2 + 2 * kStages) * kTileBytes;
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (2 + 2 * kStages);
};

// q, k, v, dout: tensor maps over (BH, S, D) bf16 (sm90::bf16_head_map) with
// a box of 64 rows; lse, delta: (BH, S) float32; dq: (BH, S, D) bf16.
template <int D>
__global__ void __launch_bounds__(DqTiles<D>::kThreads, 1)
dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dq, int bh, int seq, float scale) {
  using L = DqTiles<D>;
  constexpr int kStages = L::kStages;
  constexpr int T = L::kTileBytes;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - sm90::smem_addr(smem_raw) % 1024) % 1024);
  uint8_t* q_s = base;
  uint8_t* do_s = base + T;
  auto k_s = [&](int st) { return base + (2 + 2 * st) * T; };
  auto v_s = [&](int st) { return k_s(st) + T; };  // V follows K in a stage
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = full + kStages;

  // Item i: the highest query tiles of every head first; key tiles up to
  // the tile's last row.
  const int n_qt = (seq + kBQ - 1) / kBQ;
  const int n_items = n_qt * bh;
  auto item_q0 = [&](int i) { return (n_qt - 1 - i / bh) * kBQ; };
  auto item_tiles = [&](int i) { return (min(item_q0(i) + kBQ, seq) - 1) / kBK + 1; };

  if (threadIdx.x == 0) {
    sm90::tma_prefetch(&tq);
    sm90::tma_prefetch(&tk);
    sm90::tma_prefetch(&tv);
    sm90::tma_prefetch(&tdo);
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(q_empty, 128);
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(&full[st], 1);
      sm90::mbar_init(&empty[st], 128);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // Tile g counts the K (and V) tiles of this block over all its items: it
  // sits in stage g % kStages, in that stage's use g / kStages.
  if (warp == 4) {  // the producer warp; one lane issues every load
    if (lane == 0) {
      int g0 = 0;  // tiles of the earlier items
      for (int n = 0, i = sm90::snake_item(0); i < n_items; i = sm90::snake_item(++n)) {
        const int head = i % bh;
        const int n_tiles = item_tiles(i);
        if (n > 0) sm90::mbar_wait(q_empty, (n - 1) & 1);
        sm90::mbar_expect_tx(q_full, 2 * T);
        sm90::tma_load_tile<D>(q_s, &tq, q_full, item_q0(i), head);
        sm90::tma_load_tile<D>(do_s, &tdo, q_full, item_q0(i), head);
        for (int t = 0; t < n_tiles; ++t) {
          const int g = g0 + t, st = g % kStages;
          if (g >= kStages) sm90::mbar_wait(&empty[st], (g / kStages - 1) & 1);
          sm90::mbar_expect_tx(&full[st], 2 * T);
          sm90::tma_load_tile<D>(k_s(st), &tk, &full[st], t * kBK, head);
          sm90::tma_load_tile<D>(v_s(st), &tv, &full[st], t * kBK, head);
        }
        g0 += n_tiles;
      }
    }
    return;
  }

  // The consumer warpgroup: query rows q0 .. q0 + 63 of each item.  This
  // thread holds rows row[0] and row[1] = row[0] + 8 of the accumulators.
  const int quad = lane % 4;
  const int row_off = 16 * warp + lane / 4;
  const float scale_log2 = scale * kLog2e;

  int g0 = 0;
  for (int n = 0, i = sm90::snake_item(0); i < n_items; i = sm90::snake_item(++n)) {
    const int q0 = item_q0(i);
    const int head = i % bh;
    const int n_tiles = item_tiles(i);
    const int row[2] = {q0 + row_off, q0 + row_off + 8};
    const size_t head_off = static_cast<size_t>(head) * seq;
    float lse2[2], delta_r[2];  // lse * log2 e and delta of this thread's rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = row[h] < seq;
      lse2[h] = in ? lse[head_off + row[h]] * kLog2e : 0.f;
      delta_r[h] = in ? delta[head_off + row[h]] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;

    sm90::mbar_wait(q_full, n & 1);
    for (int t = 0; t < n_tiles; ++t) {
      const int g = g0 + t, st = g % kStages;

      // S = Q K^T and dP = dO V^T; then Q and dO are free after the item's
      // last tile.
      float s[32], dp[32];
      sm90::mbar_wait(&full[st], (g / kStages) & 1);
      sm90::wgmma_fence();
      sm90::wgmma_abt<D>(s, q_s, k_s(st));
      sm90::wgmma_abt<D>(dp, do_s, v_s(st));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      if (t + 1 == n_tiles) sm90::mbar_arrive(q_empty);

      // dS in float32, masked on the diagonal tile, rounded to bf16 A
      // fragments.
      const int k0 = t * kBK;
      const bool diagonal = k0 + kBK - 1 > q0;
      uint32_t ds[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          const float p = exp2f(s[4 * j + e] * scale_log2 - lse2[h]);
          dsv[e] = p * (dp[4 * j + e] - delta_r[h]);
          if (diagonal && k0 + 8 * j + 2 * quad + (e % 2) > row[h]) dsv[e] = 0.f;
        }
        // A fragment of k-step j / 2: rows g and g + 8, keys +0..7 then +8..15
        ds[j / 2][2 * (j % 2)] = sm90::pack_bf16(dsv[0], dsv[1]);
        ds[j / 2][2 * (j % 2) + 1] = sm90::pack_bf16(dsv[2], dsv[3]);
      }

      // dQ += dS K, then the stage is free.
      sm90::wgmma_fence();
      sm90::wgmma_ab<D>(acc, ds, k_s(st));  // K read MN-major
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(ds[kk]);
      sm90::mbar_arrive(&empty[st]);
    }

    // Epilogue: dQ * scale in bf16, rows < seq only.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= seq) continue;
      __nv_bfloat16* out = dq + (head_off + row[h]) * D + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
      }
    }
    g0 += n_tiles;
  }
}

struct DqSm90 {
  const void *q, *k, *v, *dout, *lse, *delta;
  void* dq;
  int bh, seq;
  float scale;
  cudaStream_t stream;

  template <int D>
  int run() const {
    using L = DqTiles<D>;
    CUtensorMap tq, tk, tv, tdo;
    cudaError_t err = sm90::bf16_head_map(&tq, q, bh, seq, D, kBQ);
    if (err == cudaSuccess) err = sm90::bf16_head_map(&tk, k, bh, seq, D, kBK);
    if (err == cudaSuccess) err = sm90::bf16_head_map(&tv, v, bh, seq, D, kBK);
    if (err == cudaSuccess) err = sm90::bf16_head_map(&tdo, dout, bh, seq, D, kBQ);
    if (err != cudaSuccess) return err;
    auto kernel = dq_sm90<D>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kSmem));
    if (err != cudaSuccess) return err;
    static const int resident = sm90::resident_blocks(kernel, L::kThreads, L::kSmem);
    if (resident <= 0) return cudaErrorInvalidConfiguration;
    const int items = (seq + kBQ - 1) / kBQ * bh;
    kernel<<<min(items, resident), L::kThreads, L::kSmem, stream>>>(
        tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<__nv_bfloat16*>(dq), bh, seq, scale);
    return cudaGetLastError();
  }
};

struct DqSmem {
  template <int D>
  int run() const {
    return static_cast<int>(DqTiles<D>::kSmem);
  }
};

// ---- float32: CUDA cores -----------------------------------------------------

// q, k, v, dout, dq: (BH, S, D) float32 contiguous; lse, delta: (BH, S).
// Grid (ceil(S / ROWS), BH), ROWS warps per block.
template <int D, int ROWS, int KPL>
__global__ void __launch_bounds__(ROWS * 32)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int seq, float scale) {
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
  load_rows<D>(q + head + static_cast<size_t>(row0) * D, q_s, nrows, D);
  load_rows<D>(dout + head + static_cast<size_t>(row0) * D, do_s, nrows, D);
  const float lse_r = active ? lse[vec + row] : 0.f;
  const float delta_r = active ? delta[vec + row] : 0.f;

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 <= last_row; t0 += kTile) {
    const int n = min(kTile, seq - t0);
    __syncthreads();  // the previous tile is consumed (first pass: q_s, do_s are written)
    load_rows<D>(k + head + static_cast<size_t>(t0) * D, k_s, n, kStride);
    load_rows<D>(v + head + static_cast<size_t>(t0) * D, v_s, n, kStride);
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
        ds[u] = p * (dp - delta_r);  // float32: ds.astype(k.dtype) keeps it as it is
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
  float* out = dq + head + static_cast<size_t>(row) * D + lane;
#pragma unroll
  for (int i = 0; i < kPer; ++i) out[32 * i] = acc[i] * scale;
}

struct Dq {
  const void *q, *k, *v, *dout, *lse, *delta;
  void* dq;
  int bh, seq;
  float scale;
  cudaStream_t stream;

  template <int D, int ROWS, int KPL>
  cudaError_t run() const {
    constexpr int kTile = 32 * KPL;
    const size_t smem = sizeof(float) * (2 * ROWS * D + 2 * kTile * (D + 4));
    return launch(flash_dq_kernel<D, ROWS, KPL>, ROWS, seq, bh, smem, stream,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dout),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<float*>(dq), seq, scale);
  }
};

}  // namespace

// dtype: 0 = float32, the CUDA-core kernel with block_q query rows per block
// (one warp each) in {4, 8, 16} and block_k keys per shared-memory tile in
// {32, 64}, on a grid whose y is bh (so bh <= 65535); 1 = bfloat16, the
// tensor-core kernel, whose one tile is block_q = block_k = 64, on a 1-D
// persistent grid.  Returns the launch's cudaError_t (cudaErrorInvalidValue
// for a shape or block it does not take).
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int bh, int seq, int d,
                        int dtype, int block_q, int block_k, float scale, void* stream) {
  if (bh <= 0 || seq <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return by_dim(d, block_q, block_k, bh, Dq{q, k, v, dout, lse, delta, dq, bh, seq, scale, s});
  }
  if (dtype != 1 || block_q != kBQ || block_k != kBK) return cudaErrorInvalidValue;
  return sm90::by_head_dim(d, cudaErrorInvalidValue,
                           DqSm90{q, k, v, dout, lse, delta, dq, bh, seq, scale, s});
}

// Dynamic shared memory, in bytes, of the bf16 kernel at head dim d; -1 for
// a head dim it does not take.
extern "C" int flash_dq_bf16_smem(int d) { return sm90::by_head_dim(d, -1, DqSmem{}); }
