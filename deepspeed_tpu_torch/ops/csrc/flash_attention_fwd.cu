// Flash attention forward for Hopper (sm_90a): the training path's
// attention, O = softmax(scale * Q K^T, causal) V, and the row
// log-sum-exp LSE that the backward kernels recompute P from.
//
// Replaces the TPU kernels deepspeed_tpu/ops/pallas/flash_attention.py:
// _fwd_kernel and _fwd_kernel_biased (body _fwd_impl; host side
// _flash_fwd).  Same arithmetic: fp32 online softmax (running max m, sum
// l, accumulator acc), masked scores -1e30, rows that see no key finalise
// to 0, LSE = m + log(l) in fp32 [B, H, S].  The biased instantiations add
// slope[h] * key to the scaled score and mask keys outside a sliding
// window (_mask_bias); the key loop then starts at the first tile the
// window reaches, as _k_range skips far-past blocks.  Unlike the TPU
// entry, which sends every S that is not a multiple of its block to the
// jnp reference, this kernel takes any S: the last tiles are masked.
//
// What bounds it on the H100: causal attention at gpt_1b's training shape
// (B=2, S=1024, 16 heads of 128, bf16) does 2*B*H*S^2*D = 8.6 GFLOP on
// 34 MB (q, k, v, o and the fp32 LSE), 255 flop per byte -- just under the
// ~295 flop/byte ridge, so the bytes bound it (10.1 us at 3.35 TB/s), with
// the tensor cores' time (8.7 us at 989 TFLOP/s) close behind.  BLOOM's
// ALiBi layers (S=2048) do 4x that work on 2x the bytes and are bound by
// operations (34.8 us); a window of 256 at S=2048 leaves 491,648 of the
// 2,098,176 causal (q, k) pairs and is bound by bytes again.
//
// bf16 and fp16: tensor cores fed by TMA, one body for both (the tile's
// element type E is a template argument: wgmma .bf16 or .f16, the tensor
// maps' data type, P's and O's rounding).  One block of three warpgroups per
// (128-row q tile, b * h); the blocks with the most key tiles (the causal
// q tiles at the end of the sequence) are first in launch order.  A
// producer warp loads the Q tile once and streams 128-key K and V tiles
// through a two-stage ring in shared memory (TMA, 128-byte swizzle, rows
// past S zero-filled; one mbarrier per stage each way).  Two consumer
// warpgroups own 64 query rows each: S = Q K^T by wgmma from shared
// memory, the fp32 online softmax on the accumulator registers (a row
// lives in the 4 lanes of a quad: two shuffles reduce it; exponentials
// are one ex2.approx each, the row max folded into one FFMA), then P,
// rounded to E in registers, is the A operand of O += P V, V read
// transposed from the same swizzled tile.  Masks are applied only on
// tiles that touch the diagonal, the window's edge or S; a warpgroup skips
// a tile it cannot see at all.  setmaxnreg moves registers from the
// producer to the consumers (S, O and P take 160 a thread).  The K/V
// stream is two 64 KB tiles per 128 x 128 block-tile: at S=2048 the card's
// L2 bandwidth alone sets a floor near half this kernel's time.
//
// Head dims 64, 80 and 96: a body of their own.  At gpt_350m's training
// shape (B=8, S=1024, 16 heads of 64, causal) the forward does 17.2 GFLOP
// on 67.6 MB: bound by bytes (20.2 us), the tensor cores' 17.4 us close
// behind; but its 67.1 M exponentials take ~17 us of the SFUs (16 a clock
// an SM) on their own, a 128 x 128 tile's products are now shorter than
// its softmax, and a q tile has only 4.5 key tiles on average.  The D =
// 128 design (one block per q tile, S, softmax and P V in series in each
// warpgroup) measured 0.125 ms there.  At gpt_2_7b's training shape (B=8,
// S=1024, 32 heads of 80) the forward does 42.9 GFLOP on 168.8 MB, at
// gpt_760m's (16 heads of 96) 25.8 GFLOP on 101.2 MB: both bound by bytes
// (50.4 and 30.2 us), with the same 4.5 key tiles a q tile and products
// 5/8 and 3/4 of D = 128's; the D = 128 body measured 0.2676 and 0.1421 ms
// there, 1.85x and 1.76x SDPA's time.  So at all three head dims:
//   * the consumer warpgroups run wgmma_attention.cuh (shared with the
//     ragged paged prefill tiles at D = 64): FA3's order (S of the next
//     tile and P V of this one issued together, the next softmax under P
//     V), the two warpgroups taking turns to issue their products
//     (ping-pong), and a softmax with fewer FP32 operations a score (the
//     row max on the raw products -- ALiBi's on the scaled scores plus
//     slope * key -- and the scale and log2(e) folded into the FFMA that
//     feeds ex2).  LSE is written in the units the backward kernels read
//     (m * scale + log l).
//   * the grid is persistent, one block an SM (Walk, below): a block's
//     start is paid once, the producer streams every q tile's K and V
//     through one ring, and the q tiles come in pairs of equal causal
//     work, head by head, so the heads whose K and V are being read at
//     once stay in L2.
// At D = 64 a Q, K or V tile is one 64-column TMA box, and the ring holds
// 4 stages of K and V (160 KB of shared memory with two Q tiles: the next
// q tile's Q loads while the consumers finish this one).  At 80 and 96 a
// tile is two boxes, as at D = 128: TMA reads the D columns there are and
// zero-fills the rest of the second box, so a tile costs 32 KB of shared
// memory but only D columns of HBM traffic; S = Q K^T walks D / 16 slices
// (5 or 6) and O += P V is one m64nD wgmma a 16-key slice, which reads V's
// first D columns only.  The ring there is one Q tile and 3 stages (224
// KB): a third stage was worth more than a second Q buffer.  Registers: S
// 64, P 32, O D / 2 (32, 40, 48) of the 240 setmaxnreg gives a consumer
// thread; no spill.  Measured on the H100 by scripts/flash_kernel_ab.py
// (bf16): gpt_2_7b's shape 0.2659 -> 0.1378 ms, gpt_760m's 0.1419 ->
// 0.0775 ms, 0.95x and 0.96x SDPA's time and 2.7x and 2.6x their bounds.
//
// Head dim 256 (Gemma): the persistent body too, on the shared consumer
// with 64-key K/V tiles.  At Gemma-2B's training shape (B=2, S=2048, 8
// heads of 256 over one kv head, causal) the forward does 34.4 GFLOP on 38
// MB: bound by the tensor cores (34.7 us).  A 128-row Q tile is four
// 64-column boxes, 64 KB, and O alone is 128 fp32 registers a thread, so
// a K/V tile holds 64 keys (32 KB each): S = Q K^T is an m64n64 product
// over 16 k steps, O += P V one m64n256 product a 16-key slice, and the
// ring is one Q tile and 2 stages (192 KB).  The body before ran one
// block per q tile, S, softmax and P V in series in each warpgroup, the
// two warpgroups in step: 0.0836 ms (bf16), 0.42 of its bound, and its
// blocks moved their K/V tiles into shared memory at 3.3 TB/s, what one
// 64 KB stage in flight behind the one in use allows.  Here the walk is
// persistent (its 128 units a block each at that shape: the next item's
// first K/V tile streams under this one's end), and each warpgroup runs
// a tile's S, softmax and P V in series but takes turns with the other
// for each product (kFa3At256 false): one warpgroup's softmax runs under
// the other's products, and S and P never share its registers with O --
// FA3's order (S of the next tile beside P V of this one) spilled 44-72
// bytes at setmaxnreg's 240.  Thread-block clusters of 2 and 4 of a GQA
// group's heads, loading each K/V tile once between them by TMA
// multicast, ran 1.2x and 2.2x slower (a stage is released only
// when every block of the cluster is done with it; at 4 the launch, sized
// by cudaOccupancyMaxActiveClusters, may also have run fewer clusters
// than the walk's 32 units -- not measured for this kernel), so no
// cluster is kept.  In fp16 P is
// rounded once, as SDPA rounds it: within B1's fp16 rule at every D=256
// case of chip_smoke.py (the body before entered it as two fp16 terms,
// +31% time).  Measured on an NVIDIA H100 80GB HBM3 at 700 W by
// scripts/flash_kernel_ab.py: 0.0826-0.0831 -> 0.0684 ms in bf16,
// 0.1069-0.1070 -> 0.0693 in fp16; ALiBi (8 heads, S=2048) 0.0870-0.0881
// -> 0.0706, a window of 256 0.0502-0.0504 -> 0.0416 (PERF.md has every
// plan).
//
// fp16 keeps 3 more mantissa bits than bf16 (P, O and the products' inputs
// round at 2^-11 instead of 2^-8) and the same fp32 accumulators, LSE and
// softmax; P <= 1 and O is a convex mix of V's rows, so neither can leave
// fp16's range where V does not.
//
// fp32 stays on the CUDA-core kernel (flash_tile.cuh): the fp32 checks
// hold it to 1e-4 of the plain version, ALiBi scores of ~1.4e3 included,
// which tf32 products (10-bit mantissa) would not meet.  At D = 256 its
// tiles (Q, K or V and S, 146 KB) still fit.  The dtype picks
// the instantiation in the C entry; a bf16 or fp16 launch never takes this
// path.
#include "flash_tile.cuh"
#include "hopper.cuh"
#include "wgmma_attention.cuh"

namespace {

using namespace dsflash;

// One parameter block for every instantiation; the tensor maps are the
// tensor-core kernels' and stay zero for fp32.
struct FwdParams {
  CUtensorMap q_map, k_map, v_map;
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const float* slopes;
  int window, B, S, H, Hkv, causal;
  float scale;
};

// ---- fp32: CUDA cores -------------------------------------------------

template <int D>
constexpr size_t smem_floats() {
  return 2 * 64 * pitch<D>() + BQ * PT + 3 * BQ;
}

template <bool SLOPE, bool WINDOW, int D>
__device__ __forceinline__ void fwd_cuda_cores(const FwdParams& p,
                                               float* smem) {
  using T = float;
  constexpr int PD = pitch<D>(), J = D / 16;   // J: output columns a thread
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);
  const int S = p.S, causal = p.causal;
  const float scale = p.scale;
  float* q_s = smem;              // [BQ][PD] Q * scale (Q with ALiBi)
  float* kv_s = q_s + BQ * PD;    // [BK][PD] K, then V
  float* p_s = kv_s + BK * PD;    // [BQ][PT] scores, then probabilities
  float* m_s = p_s + BQ * PT;     // [BQ] running max
  float* l_s = m_s + BQ;          // [BQ] running sum
  float* c_s = l_s + BQ;          // [BQ] rescale factor of this key tile

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const Heads hd(S, p.H, p.Hkv, D);
  const Bias<SLOPE, WINDOW> bias(p.slopes, hd.h, p.window);

  // the ALiBi kernels scale the product, not Q (see masked())
  load_tile<T, D>(q_s, q, hd.q_base, hd.q_stride, q0, S,
                  SLOPE ? 1.f : scale);
  if (tid < BQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;

  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  for (int k0 = bias.key_lo(q0); k0 < kv_hi; k0 += BK) {
    __syncthreads();  // previous tile's P V done; Q and m/l written
    load_tile<T, D>(kv_s, k, hd.kv_base, hd.kv_stride, k0, S, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    gemm_nt<4, 4, D, PD, PD>(s, q_s, kv_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float raw = SLOPE ? __fmul_rn(s[i][j], scale) : s[i][j];
        p_s[r * PT + c] = masked(raw, q0 + r, k0 + c, S, causal, bias);
      }
    __syncthreads();  // scores complete; K no longer read

    // online softmax: warp w owns rows 8w..8w+7, a lane two columns
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      const float a = p_s[r * PT + lane], b = p_s[r * PT + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, dsattn::warp_max(fmaxf(a, b)));
      float pa = expf(a - m_new), pb = expf(b - m_new);
      if (m_new <= kNeg / 2) pa = pb = 0.f;
      p_s[r * PT + lane] = pa;
      p_s[r * PT + lane + 32] = pb;
      const float sum = dsattn::warp_sum(pa + pb);
      if (lane == 0) {
        const float corr = m_prev <= kNeg / 2 ? 0.f : expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    load_tile<T, D>(kv_s, v, hd.kv_base, hd.kv_stride, k0, S, 1.f);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] *= corr;
    }
    gemm_nn<4, J, BK, PT, PD>(acc, p_s, kv_s, ty, tx);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qrow = q0 + r;
    if (qrow < S) {
      const float l = fmaxf(l_s[r], 1e-30f);
      T* orow = o + hd.q_base + (long long)qrow * hd.q_stride;
#pragma unroll
      for (int j = 0; j < J; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / l);
    }
  }
  if (tid < BQ && q0 + tid < S)
    p.lse[(long long)hd.bh * S + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

// ---- bf16 / fp16: tensor cores --------------------------------------------

namespace tc {
constexpr int BM = 128;                       // query rows of a block
constexpr int BN = 128;                       // keys of a K/V tile
constexpr int kThreads = 384;                 // 2 consumer + 1 producer WG
constexpr int kQBox = BM * hopper::kBoxCols * 2;   // one 64-column Q box
// The ring at head dims 80 and 96: one Q buffer and 3 stages of K and V,
// 32 KB a tile (224 KB).  Two Q buffers and two stages (192 KB) ran 1.2x
// its time at gpt_2_7b's and gpt_760m's shapes, and plans with a narrow
// second box (D - 64 columns: 20 or 24 KB tiles, 4-5 stages) read -3% to
// +5% of it (scripts/flash_kernel_ab.py; PERF.md has the numbers).
constexpr int kQBufs8096 = 1, kStages8096 = 3;
// The ring at head dim 256: one 64 KB Q tile and 2 stages of 64-key K and
// V tiles (32 KB each; 192 KB), the most that fits.
constexpr int kStages256 = 2;
// The consumers' order at head dim 256: FA3's (S of the next tile issued
// with P V of this one; it spilled), or each tile in series with turns for
// each product (S and P never in registers at once).
constexpr bool kFa3At256 = false;
// setmaxnreg's split at head dim 256: producer, consumers
constexpr int kProducerRegs256 = 32, kConsumerRegs256 = 232;
// Head dims 64, 80, 96 and 256 run the persistent body on the shared
// consumer (wgmma_attention.cuh); 128 one block per q tile.
__host__ __device__ constexpr bool persistent(int D) {
  return D <= 96 || D == 256;
}
// The shared-memory plan at head dim D: kQBufs Q tiles, then kStages x
// (K, V), then the barriers -- at D = 128 Q's, full[], empty[]; on the
// persistent body q_full[kQBufs], q_empty[kQBufs], full[], empty[].  A
// tile is whole 64-column boxes: a Q tile 16 KB at D = 64, 32 at 80, 96
// and 128, 64 at 256; a K or V tile of kKeys keys the same but at 256,
// where it takes 64 keys (32 KB; the header says why).
template <int D>
struct Smem {
  static constexpr int kKeys = dswg::tile_keys(D);   // keys of a K/V tile
  static constexpr int kQTile = BM * hopper::box_cols<D>() * 2;
  static constexpr int kTile = kKeys * hopper::box_cols<D>() * 2;
  static constexpr int kKVBox = kKeys * hopper::kBoxCols * 2;
  static constexpr int kStages =
      D == 64 ? 4 : D <= 96 ? kStages8096 : D == 256 ? kStages256 : 2;
  static constexpr int kQBufs = D == 64 ? 2 : D <= 96 ? kQBufs8096 : 1;
  static constexpr int kBarOffset = kQBufs * kQTile + kStages * 2 * kTile;
  static constexpr int kBars =
      persistent(D) ? 2 * kQBufs + 2 * kStages : 1 + 2 * kStages;
  static constexpr size_t kBytes = 1024 + kBarOffset + 8 * kBars;
  static_assert(kBytes <= 232448, "a block has 227 KB of shared memory");
};
constexpr int kFar = 1 << 30;   // a key bound no tile reaches
}  // namespace tc

template <typename E, bool SLOPE, bool WINDOW, int D>
__device__ __forceinline__ void fwd_tensor_cores(const FwdParams& p,
                                                 unsigned char* raw) {
  using namespace hopper;
  using namespace tc;
  static_assert(D == 128, "one block per q tile: head dim 128");
  constexpr int kTile = Smem<D>::kTile, kStages = Smem<D>::kStages;
  constexpr int kQTile = Smem<D>::kQTile, kKeys = Smem<D>::kKeys;
  constexpr int kKVBox = Smem<D>::kKVBox;
  constexpr int kBarOffset = Smem<D>::kBarOffset;
  constexpr int kS = kKeys / 2;   // S: m64n128, 64 accumulators a thread
  // tiles on 1024-byte boundaries (the swizzle atom)
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = base;
  unsigned char* kv_s = base + kQTile;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(base + kBarOffset);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kStages;

  const int S = p.S, H = p.H, bh = blockIdx.x, h = bh % H, b = bh / H;
  const int hk = h / (H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // longest rows first
  const int window = WINDOW ? p.window : 0;
  int k_lo = 0;                          // _k_range: the window's first tile
  if (WINDOW && window > 0 && q0 - (window - 1) > 0)
    k_lo = (q0 - (window - 1)) / kKeys * kKeys;
  const int k_hi = p.causal ? min(S, q0 + BM) : S;
  const int n_tiles = (k_hi - k_lo + kKeys - 1) / kKeys;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);   // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    regs_dealloc<24>();
    if (t == 0) {
      mbar_arrive_expect_tx(q_bar, kQTile);
      tma_load_rows<D>(q_s, &p.q_map, q_bar, BM, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        unsigned char* k_t = kv_s + st * 2 * kTile;
        const int k0 = k_lo + it * kKeys;
        mbar_arrive_expect_tx(&full[st], 2 * kTile);
        tma_load_rows<D>(k_t, &p.k_map, &full[st], kKeys, hk, k0, b);
        tma_load_rows<D>(k_t + kTile, &p.v_map, &full[st], kKeys, hk, k0, b);
      }
    }
  } else {  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    regs_alloc<240>();
    const int r_first = q0 + 64 * wg, r_last = r_first + 63;
    const int row0 = r_first + acc_row(0, t);       // and row0 + 8
    const float slope = SLOPE ? __ldg(p.slopes + h) : 0.f;
    const float scale = p.scale;
    const uint32_t q_addr = smem_u32(q_s) + 64 * wg * 128;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};   // l: this lane's share

    mbar_wait(q_bar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages, k0 = k_lo + it * kKeys;
      const bool unseen =
          (p.causal && k0 > r_last) || r_first >= S ||
          (WINDOW && window > 0 && r_first - (k0 + kKeys - 1) >= window);
      mbar_wait(&full[st], (it / kStages) & 1);
      if (!unseen) {
        const uint32_t k_addr = smem_u32(kv_s) + st * 2 * kTile;
        const uint32_t v_addr = k_addr + kTile;
        float s[kS];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint64_t qd = desc_kmajor(q_addr + kslice(kk, kQBox));
          const uint64_t kd = desc_kmajor(k_addr + kslice(kk, kKVBox));
          wgmma_ss_n128<E>(s, qd, kd, kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        const bool edge =
            (p.causal && k0 + kKeys - 1 > r_first) || k0 + kKeys > S ||
            (WINDOW && window > 0 && r_last - k0 >= window);
        float mx[2] = {kNeg, kNeg};
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          const int key = k0 + acc_col(i, t), row = row0 + 8 * ((i / 2) % 2);
          float x = __fmul_rn(s[i], scale);
          if (SLOPE) x = __fadd_rn(x, __fmul_rn(slope, (float)key));
          if (edge) {
            bool ok = key < S && (!p.causal || key <= row);
            if (WINDOW) ok = ok && (window <= 0 || row - key < window);
            if (!ok) x = kNeg;
          }
          s[i] = x;
          mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
        }
        float corr[2], ml[2];   // ml: m * log2(e), the exponents' offset
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          // a row that has seen no key yet keeps m = -1e30; its exponents
          // are taken from 0, so its masked scores give exactly 0
          const float m_new = fmaxf(m[r], mx[r]);
          ml[r] = m_new <= kNeg / 2 ? 0.f : m_new * kLog2e;
          corr[r] = ex2(fmaf(m[r], kLog2e, -ml[r]));
          m[r] = m_new;
          l[r] *= corr[r];
        }
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          const int r = (i / 2) % 2;
          const float pr = ex2(fmaf(s[i], kLog2e, -ml[r]));
          l[r] += pr;
          s[i] = pr;
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];
        uint32_t pa[kS / 2];
        acc_to_a<E>(s, pa);
        fence_regs(o);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          const uint64_t vd = desc_mnmajor(v_addr + kk * 2048, kKVBox);
          const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                                 pa[4 * kk + 3]};
          wgmma_rs<E, D>(o, a, vd);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
      }
      mbar_arrive(&empty[st]);
    }

    E* out = static_cast<E*>(p.o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      uint32_t* orow = reinterpret_cast<uint32_t*>(
          out + (((long long)b * S + row) * H + h) * D);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        orow[(8 * j + 2 * (t % 4)) / 2] =
            pack2<E>(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      if (t % 4 == 0)
        p.lse[(long long)bh * S + row] = m[r] + logf(fmaxf(l[r], 1e-30f));
    }
  }
}

// ---- bf16 / fp16, head dims 64, 80, 96: persistent, on the shared consumer

// What a consumer thread's two rows (row0, row0 + 8) see at D = 64, 80 and
// 96, as bounds for the shared consumer of wgmma_attention.cuh: a tile at key
// k0 needs the mask if k0 > e_hi (it crosses the diagonal or S) or k0 <=
// e_lo (the window's edge); row r sees keys lo[r] < key <= hi[r].
// Unbiased logits are the raw products (the scale goes into c, the
// exponent's multiplier); ALiBi's are scale * s + slope * key, in scaled
// units.
template <bool SLOPE, bool WINDOW>
struct FlashRows {
  float c, scale, slope;
  int e_hi, e_lo, hi[2], lo[2];
  int kt;   // 2 (t % 4): this lane's first column
  __device__ __forceinline__ bool edge(int k0) const {
    return k0 > e_hi || (WINDOW && k0 <= e_lo);
  }
  __device__ __forceinline__ bool keep(int key, int r) const {
    return key <= hi[r] && (!WINDOW || key > lo[r]);
  }
  // slope * key = slope * (k0 + kt) + slope * (the column's offset)
  __device__ __forceinline__ float key_base(int k0) const {
    return SLOPE ? slope * (float)(k0 + kt) : 0.f;
  }
  __device__ __forceinline__ float logit(float s, int i, float kb) const {
    if (!SLOPE) return s;
    return fmaf(s, scale, fmaf(slope, (float)(8 * (i / 4) + i % 2), kb));
  }
};

// A work item of the persistent forward: one 128-row q tile of one (batch,
// head), and its key tiles of Smem<D>::kKeys keys.
struct Item {
  int b, h, hk, q0, k_lo, n_tiles;
};

template <int D>
__device__ __forceinline__ Item fwd_item(const FwdParams& p, int bh, int qi,
                                         int window) {
  constexpr int kKeys = tc::Smem<D>::kKeys;
  Item it;
  it.q0 = qi * tc::BM;
  it.b = bh / p.H;
  it.h = bh % p.H;
  it.hk = it.h / (p.H / p.Hkv);
  it.k_lo = 0;                           // _k_range: the window's first tile
  if (window > 0 && it.q0 - (window - 1) > 0)
    it.k_lo = (it.q0 - (window - 1)) / kKeys * kKeys;
  const int k_hi = p.causal ? min(p.S, it.q0 + tc::BM) : p.S;
  it.n_tiles = (k_hi - it.k_lo + kKeys - 1) / kKeys;
  return it;
}

// The items a block walks, in units: unit u is q tiles n_qt - 1 - k and k
// (k = u % per_head; one tile where they meet) of (batch, head) u /
// per_head -- under the causal mask every unit but a middle one has
// n_qt + 1 key tiles of 128 keys (2 n_qt + 2 of 64), so equal shares of
// units are equal shares of work.
// A block takes units blockIdx.x, then round by round one per gridDim.x,
// forward in even rounds and backward in odd ones; the units running at
// once belong to ~gridDim.x / per_head heads, whose K and V stay in L2
// while their q tiles read them.
struct Walk {
  int n_qt, per_head, n_units;
  __device__ __forceinline__ int unit(int r) const {   // round r's unit
    const int G = gridDim.x, b = blockIdx.x;
    return r * G + (r & 1 ? G - 1 - b : b);
  }
  // q tile i (0 or 1) of unit u, or -1
  __device__ __forceinline__ int q_tile(int u, int i) const {
    const int k = u % per_head;
    const int q = i ? k : n_qt - 1 - k;
    return i && q == n_qt - 1 - k ? -1 : q;
  }
};

// One work item of the persistent forward, consumer side: the rows'
// bounds, the walk over the item's tiles (ring slots g .. g + n_tiles - 1,
// Q in buffer j % kQBufs), then O and LSE.
template <typename E, bool SLOPE, bool WINDOW, int D>
__device__ __forceinline__ void consume_item(
    const FwdParams& p, const Item& it, int j, int g, int wg, int t,
    unsigned char* q_s, unsigned char* kv_s, uint64_t* q_full,
    uint64_t* q_empty, uint64_t* full, uint64_t* empty, int window) {
  using namespace hopper;
  using namespace tc;
  constexpr int kTile = Smem<D>::kTile, kStages = Smem<D>::kStages;
  constexpr int kQTile = Smem<D>::kQTile, kKeys = Smem<D>::kKeys;
  constexpr unsigned kQBufs = Smem<D>::kQBufs;
  constexpr bool kFa3 = D != 256 || kFa3At256;
  const int S = p.S, H = p.H;
  const float scale = p.scale;
  const int r_first = it.q0 + 64 * wg, r_last = r_first + 63;
  const int row0 = r_first + acc_row(0, t);   // and row0 + 8
  const auto unseen = [&](int i) {
    const int k0 = it.k_lo + i * kKeys;
    return (p.causal && k0 > r_last) || r_first >= S ||
           (WINDOW && window > 0 && r_first - (k0 + kKeys - 1) >= window);
  };
  int first = 0;       // the tiles this warpgroup sees: [first, last)
  while (first < it.n_tiles && unseen(first)) ++first;
  int last = first;
  while (last < it.n_tiles && !unseen(last)) ++last;
  FlashRows<SLOPE, WINDOW> rows;
  rows.c = SLOPE ? kLog2e : scale * kLog2e;
  rows.scale = scale;
  rows.slope = SLOPE ? __ldg(p.slopes + it.h) : 0.f;
  rows.e_hi = min(p.causal ? r_first - kKeys + 1 : kFar, S - kKeys);
  rows.e_lo = WINDOW && window > 0 ? r_last - window : -kFar;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    rows.hi[r] = p.causal ? min(S - 1, row) : S - 1;
    rows.lo[r] = WINDOW && window > 0 ? row - window : -kFar;
  }
  rows.kt = 2 * (t % 4);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};   // l: this lane's share

  const unsigned qb = (unsigned)j % kQBufs;
  mbar_wait(&q_full[qb], ((unsigned)j / kQBufs) & 1);
  dswg::attend_tiles<E, D, kStages, kTile, kFa3>(
      rows, smem_u32(q_s + qb * kQTile) + 64 * wg * 128, smem_u32(kv_s),
      full, empty, g, it.n_tiles, first, last, it.k_lo, t, o, m, l);
  mbar_arrive(&q_empty[qb]);   // every product that read Q retired

  E* out = static_cast<E*>(p.o);
  const int bh = it.b * H + it.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        out + (((long long)it.b * S + row) * H + it.h) * D);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      orow[(8 * c + 2 * (t % 4)) / 2] =
          pack2<E>(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
    // LSE in scaled units, as the backward kernels read it
    const float ms = SLOPE || m[r] <= kNeg / 2 ? m[r] : m[r] * scale;
    if (t % 4 == 0)
      p.lse[(long long)bh * S + row] = ms + logf(fmaxf(l[r], 1e-30f));
  }
}

// One block an SM walks its share of the items (Walk): a block's start
// (barriers, the first Q and K/V loads, the pipeline's fill) is paid once,
// not once per q tile -- at gpt_350m's shape a q tile has 4.5 key tiles
// on average, and that start cost about as much as 3 of them.  With two Q
// buffers the producer loads the next item's Q while the consumers run
// this one; with one it loads it after the item's first K/V tile, once
// the consumers are done with Q.  Every item's K/V tiles stream through
// one ring.
template <typename E, bool SLOPE, bool WINDOW, int D>
__device__ __forceinline__ void fwd_tensor_cores_persistent(
    const FwdParams& p, unsigned char* raw) {
  using namespace hopper;
  using namespace tc;
  using Plan = Smem<D>;
  constexpr int kTile = Plan::kTile, kStages = Plan::kStages;
  constexpr int kQTile = Plan::kQTile;
  constexpr unsigned kQBufs = Plan::kQBufs;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = base;                     // Q tiles 0 .. kQBufs - 1
  unsigned char* kv_s = base + kQBufs * kQTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + Plan::kBarOffset);
  uint64_t* q_empty = q_full + kQBufs;
  uint64_t* full = q_empty + kQBufs;
  uint64_t* empty = full + kStages;

  const int S = p.S, H = p.H;
  const int n_qt = (S + BM - 1) / BM;
  const Walk walk{n_qt, (n_qt + 1) / 2, p.B * H * ((n_qt + 1) / 2)};
  const int window = WINDOW ? p.window : 0;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < (int)kQBufs; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 256);   // every consumer thread
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    regs_dealloc<D == 256 ? kProducerRegs256 : 24>();
    if (t == 0) {
      int g = 0;   // K/V tiles streamed so far: the ring's slot
      int j = 0;   // items so far: the Q buffer's and its barriers' phase
      for (int r = 0, u = walk.unit(0); u < walk.n_units;
           u = walk.unit(++r)) {
        for (int i = 0; i < 2; ++i, ++j) {
          const int qi = walk.q_tile(u, i);
          if (qi < 0) break;
          const Item it = fwd_item<D>(p, u / walk.per_head, qi, window);
          const unsigned qb = (unsigned)j % kQBufs;
          const auto load_q = [&] {
            mbar_wait(&q_empty[qb], (((unsigned)j / kQBufs) & 1) ^ 1);
            mbar_arrive_expect_tx(&q_full[qb], kQTile);
            tma_load_rows<D>(q_s + qb * kQTile, &p.q_map, &q_full[qb], BM,
                             it.h, it.q0, it.b);
          };
          if (kQBufs > 1) load_q();
          for (int c = 0; c < it.n_tiles; ++c, ++g) {
            const int st = g % kStages;
            mbar_wait(&empty[st], ((g / kStages) & 1) ^ 1);
            unsigned char* k_t = kv_s + st * 2 * kTile;
            const int k0 = it.k_lo + c * Plan::kKeys;
            mbar_arrive_expect_tx(&full[st], 2 * kTile);
            tma_load_rows<D>(k_t, &p.k_map, &full[st], Plan::kKeys, it.hk,
                             k0, it.b);
            tma_load_rows<D>(k_t + kTile, &p.v_map, &full[st], Plan::kKeys,
                             it.hk, k0, it.b);
            if (kQBufs == 1 && c == 0) load_q();
          }
        }
      }
    }
  } else {  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63 of each
    regs_alloc<D == 256 ? kConsumerRegs256 : 240>();
    dswg::first_turn(wg);
    int g = 0, j = 0;
    for (int r = 0, u = walk.unit(0); u < walk.n_units; u = walk.unit(++r)) {
      for (int i = 0; i < 2; ++i, ++j) {
        const int qi = walk.q_tile(u, i);
        if (qi < 0) break;
        const Item it = fwd_item<D>(p, u / walk.per_head, qi, window);
        consume_item<E, SLOPE, WINDOW, D>(p, it, j, g, wg, t, q_s, kv_s,
                                          q_full, q_empty, full, empty,
                                          window);
        g += it.n_tiles;
      }
    }
  }
}

template <typename T>
constexpr int fwd_threads() {
  return std::is_same<T, float>::value ? kThreads : tc::kThreads;
}

template <typename T, bool SLOPE, bool WINDOW, int D>
__global__ void __launch_bounds__(fwd_threads<T>(), 1)
flash_fwd_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (std::is_same<T, float>::value)
    fwd_cuda_cores<SLOPE, WINDOW, D>(p, reinterpret_cast<float*>(smem_raw));
  else if constexpr (tc::persistent(D))
    fwd_tensor_cores_persistent<T, SLOPE, WINDOW, D>(p, smem_raw);
  else
    fwd_tensor_cores<T, SLOPE, WINDOW, D>(p, smem_raw);
}

template <typename T, bool SLOPE, bool WINDOW, int D>
int launch(const FwdParams& p, int B, cudaStream_t stream) {
  constexpr bool fp32 = std::is_same<T, float>::value;
  const size_t smem =
      fp32 ? smem_floats<D>() * sizeof(float) : tc::Smem<D>::kBytes;
  // once per instantiation, before any graph capture can be running
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, SLOPE, WINDOW, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid = fp32 ? dim3((p.S + BQ - 1) / BQ, B * p.H)
                   : dim3(B * p.H, (p.S + tc::BM - 1) / tc::BM);
  if (!fp32 && tc::persistent(D)) {   // one block an SM, at most
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const unsigned units = grid.x * ((grid.y + 1) / 2);   // Walk's units
    grid = dim3(units < (unsigned)sms ? units : (unsigned)sms);
  }
  flash_fwd_kernel<T, SLOPE, WINDOW, D>
      <<<grid, fwd_threads<T>(), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_biased(const FwdParams& p, int B, cudaStream_t stream) {
  return with_bias(p.slopes, p.window, [&](auto slope, auto win) {
    return launch<T, decltype(slope)::value, decltype(win)::value, D>(
        p, B, stream);
  });
}

// The tensor-core kernels: their tensor maps, then the launch.
template <typename E, int D>
int launch_tensor_cores(FwdParams& p, int B, cudaStream_t stream) {
  using hopper::make_head_map;
  const int S = p.S, Hkv = p.Hkv;
  constexpr int kKeys = tc::Smem<D>::kKeys;
  int rc = make_head_map<E>(&p.q_map, p.q, B, S, p.H, tc::BM, D);
  if (!rc) rc = make_head_map<E>(&p.k_map, p.k, B, S, Hkv, kKeys, D);
  if (!rc) rc = make_head_map<E>(&p.v_map, p.v, B, S, Hkv, kKeys, D);
  return rc ? rc : launch_biased<E, D>(p, B, stream);
}

}  // namespace

// q: [B, S, H, D]; k/v: [B, S, Hkv, D]; o: [B, S, H, D] (q's dtype);
// lse: fp32 [B, H, S].  slopes: fp32 [H] ALiBi slopes or null; window:
// the sliding window, <= 0 for none.  dtype: 0 = float32, 1 = bfloat16,
// 2 = float16; D is 64, 80, 96, 128 or 256.  Returns a CUDA error code, 0
// on success.
extern "C" int ds_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      const void* slopes, int B, int S,
                                      int H, int Hkv, int D, int causal,
                                      int dtype, int window, float scale,
                                      void* stream) {
  const int bad = dsflash::check_shape(B, S, H, Hkv, D);
  if (bad) return bad;
  FwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.slopes = static_cast<const float*>(slopes);
  p.window = window;
  p.B = B;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dsflash::with_head_dim(D, [&](auto d) {
    constexpr int Dc = decltype(d)::value;
    if (dtype == 0) return launch_biased<float, Dc>(p, B, s);
    if (dtype == 1) return launch_tensor_cores<__nv_bfloat16, Dc>(p, B, s);
    if (dtype == 2) return launch_tensor_cores<__half, Dc>(p, B, s);
    return (int)cudaErrorInvalidValue;
  });
}
