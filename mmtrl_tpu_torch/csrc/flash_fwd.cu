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
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at the decision
// transformer's shapes, head dim 128 in bf16, the bytes that must move (q, k,
// v read once, o and lse written once) are 5.9 MB at (B*H, S) = (64, 90)
// (serve), 47 MB at (512, 90) (train) and 67 MB at (64, 1026) (long context):
// 1.8, 14.1 and 20.1 us.  The two products are 0.13, 1.1 and 17.3 GFLOP, so
// 0.1, 1.1 and 17.5 us: every shape is bound by bytes, the long one barely.
//
// Two kernels, by dtype, never one in place of the other:
//
// bfloat16: `fwd_sm90`, on the tensor cores.  A block has one producer warp and
// one consumer warpgroup, and is persistent: the grid holds as many blocks as
// the card runs at once, and each walks work items (a tile of 64 query rows of
// one head), heaviest tiles first, in snake order.  The producer loads an
// item's Q tile once and streams its K and V tiles of 64 keys through two rings
// of two shared-memory stages with TMA (cp.async.bulk.tensor), each load
// completing on an mbarrier; the consumers release a K stage once S is
// computed, a V stage once O is, and Q after the item's last S, so the next
// item's loads overlap this one's last product and epilogue.  One tile,
// 64 x 64: it measured fastest at the serve, train and long-context shapes
// against 64 x 128, 128 x 64 and 128 x 128 (PERF.md), and since the query and
// key tiles are equal, only an item's last key tile crosses the diagonal and
// none lies wholly above it.  The tensor maps are 3-D (d, seq, heads) with a box of one
// head, so the rows past seq of a ragged last tile load as zeros and never as
// the next head's rows (a masked score gives p = 0, and 0 * NaN is NaN).  Per
// key tile the consumer warpgroup computes S = Q K^T with wgmma m64n64k16 from
// shared memory (both K-major), scales and masks it in registers, takes the row
// max and sum over the quad of threads that holds each row, rescales the O
// accumulator, rounds P to bf16 in registers (the TPU kernel's
// `p.astype(v.dtype)`) and computes O += P V with wgmma m64nDk16, A from those
// registers and V read MN-major.  Only the diagonal tile is masked element by
// element; rows past seq are never written.  The shared tiles carry the 32-,
// 64- or 128-byte swizzle of their row length (D = 16, 32, 64; D = 128 is two
// 64-column chunks), the same in the TMA box and the wgmma descriptor
// (flash_sm90.cuh).  The tensor maps are encoded on the host at every call with
// cuTensorMapEncodeTiled, from libcuda through the runtime's entry-point
// lookup, so the library links no -lcuda.  Each product is waited for before
// its result is read (software pipelining S of the next tile under this tile's
// softmax measured slower: more registers, and the SM's two blocks already
// overlap each other); two blocks fit an SM (83 KB of shared memory each at
// D = 128), and what holds the kernel back at each shape is in PERF.md.
//
// float32: `flash_fwd_kernel`, the CUDA-core kernel of the first port, built
// for float32 only: one warp per query row, ROWS rows a block sharing K/V
// tiles of 32 * KPL keys staged in shared memory as float32; each lane
// scores its own keys and accumulates D / 32 output columns with the
// probabilities broadcast by warp shuffles.  It stays because a float32
// wgmma runs in TF32 (about three decimal digits), which would break
// float32's agreement with the plain version to 1e-5.  It is bound by
// shared-memory reads, well above the device-memory bound.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace flash;

// ---- bfloat16: TMA + wgmma ---------------------------------------------------

constexpr int kBQ = 64;  // query rows of a block: one consumer warpgroup
constexpr int kBK = 64;  // keys of a K or V tile

template <int D>
struct Sm90Tiles {
  static constexpr int kThreads = 128 + 32;  // the consumers + the producer warp
  static constexpr int kStages = 2;
  static constexpr int kQBytes = sm90::Tile<D>::kBytes;
  static constexpr int kKVBytes = sm90::Tile<D>::kBytes;  // one K or one V tile
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kKVBytes;
  // + room to align the base to 1024 bytes; barriers: Q full and empty, and
  // per stage K and V full and empty
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (2 + 4 * kStages);
};

// q, k, v: tensor maps over (BH, S, D) bf16 (sm90::bf16_head_map) with a
// box of 64 rows; o: (BH, S, D) bf16; lse: (BH, S) float32.
// Persistent: a grid of at most as many blocks as fit on the card at once,
// each walking its share of the work items (query tile, head), so that the
// loads of a block's next item overlap the end of its last.
template <int D>
__global__ void __launch_bounds__(Sm90Tiles<D>::kThreads, 1)
fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
         float* __restrict__ lse, int bh, int seq, float scale_log2) {
  using L = Sm90Tiles<D>;
  constexpr int kStages = L::kStages;
  constexpr int BQ = kBQ, BK = kBK;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - sm90::smem_addr(smem_raw) % 1024) % 1024);
  uint8_t* q_s = base;
  auto k_s = [&](int st) { return base + L::kQBytes + st * 2 * L::kKVBytes; };
  auto v_s = [&](int st) { return k_s(st) + L::kKVBytes; };  // V follows K in a stage
  // K and V are two rings: a K tile is free once its S product is done, a V
  // tile only after the PV product, which runs later.  Q is one buffer,
  // free once an item's last S product is done.
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* k_full = bars + 2;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // Item i: the highest query tiles of every head first, since they see the
  // most keys.  Key tiles up to the tile's last row.  A block takes one item
  // a round, in snake order (sm90::snake_item).
  const int n_qt = (seq + BQ - 1) / BQ;
  const int n_items = n_qt * bh;
  auto item_q0 = [&](int i) { return (n_qt - 1 - i / bh) * BQ; };
  auto item_tiles = [&](int i) { return (min(item_q0(i) + BQ, seq) - 1) / BK + 1; };

  if (threadIdx.x == 0) {
    sm90::tma_prefetch(&tq);
    sm90::tma_prefetch(&tk);
    sm90::tma_prefetch(&tv);
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(q_empty, 128);
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(&k_full[st], 1);
      sm90::mbar_init(&v_full[st], 1);
      sm90::mbar_init(&k_empty[st], 128);
      sm90::mbar_init(&v_empty[st], 128);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // Tile g counts the K (or V) tiles of this block over all its items: it
  // sits in stage g % kStages, in that stage's use g / kStages.
  if (warp == 4) {  // the producer warp; one lane issues every load
    if (lane == 0) {
      int g0 = 0;  // tiles of the earlier items
      for (int n = 0, i = sm90::snake_item(0); i < n_items; i = sm90::snake_item(++n)) {
        const int head = i % bh;
        const int n_tiles = item_tiles(i);
        if (n > 0) sm90::mbar_wait(q_empty, (n - 1) & 1);
        sm90::mbar_expect_tx(q_full, L::kQBytes);
        sm90::tma_load_tile<D>(q_s, &tq, q_full, item_q0(i), head);
        // K and V tile t of this item into their rings; V sits kKVBytes
        // after K in each stage.  K runs one tile ahead of V, as the
        // consumers need them: K(t + 1) is asked for before V(t).
        auto load = [&](const CUtensorMap* map, int offset, uint64_t* full, uint64_t* empty,
                        int t) {
          const int g = g0 + t, st = g % kStages;
          if (g >= kStages) sm90::mbar_wait(&empty[st], (g / kStages - 1) & 1);
          sm90::mbar_expect_tx(&full[st], L::kKVBytes);
          sm90::tma_load_tile<D>(k_s(st) + offset, map, &full[st], t * BK, head);
        };
        load(&tk, 0, k_full, k_empty, 0);
        for (int t = 0; t < n_tiles; ++t) {
          if (t + 1 < n_tiles) load(&tk, 0, k_full, k_empty, t + 1);
          load(&tv, L::kKVBytes, v_full, v_empty, t);
        }
        g0 += n_tiles;
      }
    }
    return;
  }

  // The consumer warpgroup: query rows q0 .. q0 + 63 of each item.  Per
  // key tile: S = Q K^T, the softmax, then O += P V, each product waited
  // for before its result is read; the SM's other block fills the tensor
  // cores meanwhile.  This thread holds rows row[0] and row[1] = row[0] + 8
  // of the accumulators.
  const int quad = lane % 4;
  const int row_off = 16 * warp + lane / 4;

  int g0 = 0;
  for (int n = 0, i = sm90::snake_item(0); i < n_items; i = sm90::snake_item(++n)) {
    const int q0 = item_q0(i);
    const int head = i % bh;
    const int n_tiles = item_tiles(i);
    const int row[2] = {q0 + row_off, q0 + row_off + 8};

    float acc[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running row max of the log2-scaled scores
    float l[2] = {0.f, 0.f};              // this thread's share of the running row sum

    sm90::mbar_wait(q_full, n & 1);
    for (int t = 0; t < n_tiles; ++t) {
      const int g = g0 + t, st = g % kStages;
      const uint32_t parity = (g / kStages) & 1;

      // S = Q K^T, then K's stage (and Q after the item's last tile) is free.
      float s[BK / 2];
      sm90::mbar_wait(&k_full[st], parity);
      sm90::wgmma_fence();
      sm90::wgmma_abt<D>(s, q_s, k_s(st));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::mbar_arrive(&k_empty[st]);
      if (t + 1 == n_tiles) sm90::mbar_arrive(q_empty);

      // Scale, mask, and the online softmax over this tile.
      const int k0 = t * BK;
      const bool diagonal = k0 + BK - 1 > q0;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          float x = s[4 * j + e] * scale_log2;
          if (diagonal && k0 + 8 * j + 2 * quad + (e % 2) > row[h]) x = -INFINITY;
          s[4 * j + e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
        // Key 0 is in every row's first tile, so m is finite from there on.
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int x = 0; x < D / 2; ++x) acc[x] *= corr[(x / 2) % 2];
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = exp2f(s[4 * j] - m[0]), p1 = exp2f(s[4 * j + 1] - m[0]);
        const float p2 = exp2f(s[4 * j + 2] - m[1]), p3 = exp2f(s[4 * j + 3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        // A fragment of k-step j / 2: rows g and g + 8, keys +0..7 then +8..15
        p[j / 2][2 * (j % 2)] = sm90::pack_bf16(p0, p1);
        p[j / 2][2 * (j % 2) + 1] = sm90::pack_bf16(p2, p3);
      }

      // O += P V, then V's stage is free.
      sm90::mbar_wait(&v_full[st], parity);
      sm90::wgmma_fence();
      sm90::wgmma_ab<D>(acc, p, v_s(st));  // V read MN-major
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) sm90::fence_regs(p[kk]);
      sm90::mbar_arrive(&v_empty[st]);
    }

    // Epilogue: the full row sums, O = acc / l in bf16 and lse, rows < seq
    // only.  The stores drain while the next item's loads arrive.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(kFull, l[h], 1);
      l[h] += __shfl_xor_sync(kFull, l[h], 2);
    }
    const size_t head_off = static_cast<size_t>(head) * seq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= seq) continue;
      const float inv = 1.f / l[h];
      __nv_bfloat16* orow = o + (head_off + row[h]) * D + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      }
      if (quad == 0) lse[head_off + row[h]] = m[h] * 0.69314718055994531f + logf(l[h]);
    }
    g0 += n_tiles;
  }
}

struct Sm90Launch {
  const void *q, *k, *v;
  void *o, *lse;
  int bh, seq;
  float scale;
  cudaStream_t stream;

  template <int D>
  int run() const {
    using L = Sm90Tiles<D>;
    CUtensorMap tq, tk, tv;
    cudaError_t err = sm90::bf16_head_map(&tq, q, bh, seq, D, kBQ);
    if (err == cudaSuccess) err = sm90::bf16_head_map(&tk, k, bh, seq, D, kBK);
    if (err == cudaSuccess) err = sm90::bf16_head_map(&tv, v, bh, seq, D, kBK);
    if (err != cudaSuccess) return err;
    auto kernel = fwd_sm90<D>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kSmem));
    if (err != cudaSuccess) return err;
    // As many blocks as the card holds at once, found once per kernel.
    static const int resident = sm90::resident_blocks(kernel, L::kThreads, L::kSmem);
    if (resident <= 0) return cudaErrorInvalidConfiguration;
    const int items = (seq + kBQ - 1) / kBQ * bh;
    kernel<<<min(items, resident), L::kThreads, L::kSmem, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), bh, seq,
        scale * 1.4426950408889634f);
    return cudaGetLastError();
  }
};

struct Sm90Smem {
  template <int D>
  int run() const {
    return static_cast<int>(Sm90Tiles<D>::kSmem);
  }
};

// ---- float32: CUDA cores -----------------------------------------------------

// q, k, v, o: (BH, S, D) float32 contiguous; lse: (BH, S).  Grid
// (ceil(S / ROWS), BH), ROWS warps per block.
template <int D, int ROWS, int KPL>
__global__ void __launch_bounds__(ROWS * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int seq, float scale) {
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

  load_rows<D>(q + head + static_cast<size_t>(row0) * D, q_s, last_row - row0 + 1, D);

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  float m = -INFINITY;  // running row max
  float l = 0.f;        // this lane's share of the running row sum

  for (int t0 = 0; t0 <= last_row; t0 += kTile) {
    const int n = min(kTile, seq - t0);
    __syncthreads();  // the previous tile is consumed (first pass: q_s is written)
    load_rows<D>(k + head + static_cast<size_t>(t0) * D, k_s, n, kKStride);
    load_rows<D>(v + head + static_cast<size_t>(t0) * D, v_s, n, D);
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
      l += p;  // p.astype(v.dtype) for the PV product leaves float32 p as it is
      const int nk = min(32, row - (t0 + u * 32) + 1);  // unmasked keys of this slot
      for (int j = 0; j < nk; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
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
  float* orow = o + head + static_cast<size_t>(row) * D + lane;
  if (col_ok) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) orow[32 * i] = acc[i] * inv;
  }
  if (lane == 0) lse[static_cast<size_t>(blockIdx.y) * seq + row] = m + logf(l_row);
}

struct Fwd {
  const void *q, *k, *v;
  void *o, *lse;
  int bh, seq;
  float scale;
  cudaStream_t stream;

  template <int D, int ROWS, int KPL>
  cudaError_t run() const {
    constexpr int kTile = 32 * KPL;
    const size_t smem = sizeof(float) * (ROWS * D + kTile * (D + 4) + kTile * D);
    return launch(flash_fwd_kernel<D, ROWS, KPL>, ROWS, seq, bh, smem, stream,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o),
                  static_cast<float*>(lse), seq, scale);
  }
};

}  // namespace

// dtype: 0 = float32, the CUDA-core kernel with block_q query rows per block
// (one warp each) in {4, 8, 16} and block_k keys per shared-memory tile in
// {32, 64}, on a grid whose y is bh (so bh <= 65535); 1 = bfloat16, the
// tensor-core kernel, whose one tile is block_q = block_k = 64, on a 1-D
// persistent grid.  Returns the launch's cudaError_t (cudaErrorInvalidValue
// for a shape or block it does not take).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int bh, int seq, int d, int dtype, int block_q, int block_k,
                         float scale, void* stream) {
  if (bh <= 0 || seq <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_dim(d, block_q, block_k, bh, Fwd{q, k, v, o, lse, bh, seq, scale, s});
  if (dtype != 1 || block_q != kBQ || block_k != kBK) return cudaErrorInvalidValue;
  return sm90::by_head_dim(d, cudaErrorInvalidValue,
                           Sm90Launch{q, k, v, o, lse, bh, seq, scale, s});
}

// Dynamic shared memory, in bytes, of the bf16 kernel at head dim d; -1 for
// a head dim it does not take.
extern "C" int flash_fwd_bf16_smem(int d) { return sm90::by_head_dim(d, -1, Sm90Smem{}); }
