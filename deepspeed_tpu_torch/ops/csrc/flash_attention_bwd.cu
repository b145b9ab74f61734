// Flash attention backward for Hopper (sm_90a): two kernels, as on the TPU.
//
// Replaces deepspeed_tpu/ops/pallas/flash_attention.py: _bwd_dq_kernel
// and _bwd_dq_kernel_biased (body _bwd_dq_impl), _bwd_dkv_kernel and
// _bwd_dkv_kernel_biased (body _bwd_dkv_impl); host side
// _flash_bwd_pallas.  Both recompute P = exp(scale * Q K^T - LSE) tile by
// tile from the forward's fp32 LSE, zeroing it where the masked score is
// <= -1e30 / 2 (so a masked entry contributes exactly 0), and use
// delta = sum_d dO * O (fp32 [B, H, S], computed by the wrapper):
//   dS = P * (dO V^T - delta) * scale
//   dQ = sum over key tiles of dS K          (one block per q tile)
//   dK = sum over q tiles of dS^T Q,  dV = sum over q tiles of P^T dO
//                                            (one block per key tile)
// dQ is stored in q's dtype.  dK and dV are stored in fp32 per QUERY head
// ([B, S, H, D]); the wrapper sums them over the GQA group and casts, as
// _flash_bwd_pallas does, so no atomics are needed and runs repeat bit for
// bit.  The biased instantiations add slope[h] * key after the scale and
// mask keys outside the sliding window, as the TPU kernels do; the dQ
// kernel's key loop starts at the first tile the window reaches, and the
// dK/dV kernel's q loop ends after the last q tile that can see its keys.
// Any S is taken: ragged last tiles are masked.
//
// What bounds them on the H100: at gpt_1b's training shape (B=2, S=1024,
// 16 heads of 128, causal, bf16) dQ does 3*B*H*S^2*D = 12.9 GFLOP on 42 MB,
// 307 flop per byte, over the ~295 flop/byte ridge: the tensor cores bound
// it (13.0 us).  dK/dV does 4*B*H*S^2*D = 17.2 GFLOP on 51 MB (dK and dV
// counted in k's dtype at Hkv heads, as the function returns them), 340
// flop per byte: the tensor cores bound it too (17.4 us); its fp32
// per-query-head outputs write 34 MB more than that.  BLOOM's ALiBi layers
// (S=2048) do 4x the work and are bound by operations; a window of 256 at
// S=2048 leaves 491,648 of the 2,098,176 causal (q, k) pairs and is bound
// by bytes.
//
// bf16 and fp16 run one tensor-core body each for dQ and dK/dV, templated
// on the tile's element type E (wgmma .bf16 or .f16, the tensor maps' data
// type, the rounding of P, dS and dQ).  fp16 rounds at 2^-11 where bf16
// rounds at 2^-8, with bf16's fp32 accumulators; but its range ends at
// 65504, and a loss scale rides in dO, so dS (rounded to E as an A
// operand) can overflow where the TPU kernel, which keeps dS in fp32,
// overflows only in its outputs; the fp16 training check of chip_smoke.py
// reports any step where the kernels and the plain versions disagree on
// overflow.
//
// dK/dV: tensor cores fed by TMA.  One block of three warpgroups per
// (128-key tile, b * h), the key tiles with the longest causal q loops
// first.  K and V (32 KB each) stay in shared memory for the block; a
// producer warp streams 64-row Q and dO tiles through a two-stage ring
// (TMA, 128-byte swizzle, rows past S zero-filled) and writes their rows'
// LSE and delta beside them.  Two consumer warpgroups own 64 keys each and
// compute the products transposed, keys as wgmma's M: S^T = K Q^T and
// dP^T = V dO^T from shared memory; P^T = exp(S^T (+ slope * key) - LSE)
// and dS^T = P^T (dP^T - delta) scale on the accumulator registers; then
// P^T and dS^T, rounded to E in registers, are the A operands of
// dV += P^T dO and dK += dS^T Q, dO and Q read transposed from the same
// swizzled tiles -- nothing goes back through shared memory, and dV's
// product runs while dS is formed.  dK and dV (128 fp32 registers a
// thread) need setmaxnreg: 240 for the consumers, 24 for the producer.
// The q loop runs from the diagonal to the last row the window lets see
// the tile; masks apply only on tiles that touch the diagonal, the window
// edge or S.
//
// dQ, bf16/fp16: the same shape as the forward with two score products,
// dS in P's place.  One block of three warpgroups per (128-row q tile, b * h),
// the q tiles with the longest causal key loops first.  A producer warp
// loads the Q and dO tiles once and streams 64-key K and V tiles through a
// two-stage ring (TMA, 128-byte swizzle, rows past S zero-filled); Q and
// dO are read at H heads, K and V at Hkv, so GQA reads its kv head
// directly.  Two consumer warpgroups own 64 query rows each and read
// their rows' LSE (times log2 e) and delta once: S = Q K^T and dP = dO V^T
// by wgmma from shared memory (64 keys wide: S, dP and dQ take 32 + 32 +
// 64 fp32 registers a thread, which 128-key products would take past
// setmaxnreg's 240); P = exp(S scale (+ slope * key) - LSE), masked only
// on tiles that touch the diagonal, the window's edge or S; dS = P (dP -
// delta) scale on the accumulator registers, rounded to E as the A
// operand of dQ += dS K, K read transposed from the same swizzled tile.
// The key loop starts at the window's first tile and ends at the causal
// frontier.  dQ stays a kernel of its own, summed in registers: no fp32
// atomics, so runs repeat bit for bit.
//
// Head dim 64: the same bodies with D = 64 as a template argument.  Every
// Q, dO, K and V tile is one 64-column TMA box instead of two, so the
// score products (S = Q K^T, dP = dO V^T and their transposes), whose depth
// is D, walk 4 slices instead of 8; the products whose N is D (dQ += dS K,
// dV += P^T dO, dK += dS^T Q) are m64n64, which halves the accumulators:
// dQ takes 32 fp32 registers a thread, dK + dV 64 instead of 128.  The
// tiles are half the bytes, so each ring holds 4 stages instead of 2.  One
// block still runs on an SM: two would leave the consumers under 116
// registers, below S + dP + the accumulators, so setmaxnreg stays 240 / 24.
// At gpt_350m's training shape (B=8, S=1024, 16 heads of 64, causal) dQ
// does 25.8 GFLOP on 85 MB and dK/dV 34.4 GFLOP on 102 MB: both bound by
// the tensor cores (26.1 and 34.7 us).
//
// Head dims 80 (gpt_2_7b) and 96 (gpt_760m): the same bodies again, with
// D = 128's tiles and stages.  A tile is two 64-column TMA boxes whose
// columns past D TMA fills with zeros without reading HBM; the score
// products walk D / 16 slices (5 or 6), and the products whose N is D are
// m64n80 or m64n96, reading only the D columns of dO, Q or K: dQ takes 40
// or 48 fp32 registers a thread, dK + dV 80 or 96.  At gpt_2_7b's training
// shape (B=8, S=1024, 32 heads of 80, causal) dQ does 64.4 GFLOP and dK/dV
// 85.9, at gpt_760m's (16 heads of 96) 38.7 and 51.5: all bound by the
// tensor cores (65.1 and 86.9 us; 39.1 and 52.1 us).
//
// Head dim 256 (Gemma): a tile is four 64-column boxes, and every
// accumulator whose N is D is 128 fp32 registers a thread.
//   * dQ: the body as it is (dQ 128 + S 32 + dP 32 registers of the
//     consumers' 240, no spill); Q and dO take 64 KB each, so the K/V ring
//     has one stage of 64-key tiles (192 KB in all), and a tile's loads no
//     longer overlap the products of the one before.
//   * dK/dV: dK + dV for 64 keys a warpgroup would be 256 registers, and
//     K and V resident for 128 keys with the Q/dO ring 256 KB.  A block
//     takes 64 keys (K, V 64 KB; two stages of 64-row Q and dO 128 KB),
//     and both consumer warpgroups compute S^T and dP^T for those keys;
//     each then owns 128 of dK's and dV's columns (m64n128 products over
//     its half of dO and Q): 64 + 64 + 32 + 32 registers, no spill.  The
//     score products are done twice, 1.5x the block's tensor-core work.
//     A design that split them instead (one warpgroup S^T, the other dP^T,
//     trading P^T in fp32 and dS^T in E through 24 KB of shared memory and
//     two named barriers a tile) measured slower on an H100 (0.1966-0.1989
//     against 0.1950 ms at Gemma-2B's shape, scripts/flash_kernel_ab.py):
//     it spilled 48 bytes and ptxas serialised its wgmma pipeline (a
//     WARPGROUP.DEPBAR after each of its 46 HGMMA).
// At Gemma-2B's training shape (B=2, S=2048, 8 heads of 256 over one kv
// head, causal) dQ does 51.5 GFLOP and dK/dV 68.7: bound by the tensor
// cores (52.1 and 69.5 us).
//
// fp32 dQ and dK/dV run on the CUDA cores (the first kernels,
// flash_tile.cuh): 256 threads, fp32 products; the dQ block walks key
// tiles up to its causal frontier.  fp32 stays there because the fp32
// checks hold it to 1e-4 of the plain version, ALiBi scores of ~1.4e3
// included, which tf32 products would not meet; the dtype picks the
// instantiation in the C entry.  At D = 256 their tiles are 32 rows by 32
// keys (flash_tile.cuh bwd_rows): four 64-row [64][257] fp32 tiles would
// not fit a block's shared memory.
#include "flash_tile.cuh"
#include "hopper.cuh"

namespace {

using namespace dsflash;

// Per-row P and dS of one (q tile, key tile) pair of R rows and keys from
// the shared Q, dO, K, V tiles; row r of the q tile is query q0 + r,
// column c key k0 + c.  s, dp: this thread's scores and dO V^T (I = R / 16
// rows and columns); writes P (if p_s) and dS, pitch R + 1.
template <bool SLOPE, bool WINDOW, int I>
__device__ __forceinline__ void probs_and_ds(
    float (&s)[I][I], float (&dp)[I][I], const float* __restrict__ lse_s,
    const float* __restrict__ dl_s, float* __restrict__ p_s,
    float* __restrict__ ds_s, int q0, int k0, int S, float scale, int causal,
    const Bias<SLOPE, WINDOW>& bias, int ty, int tx) {
  constexpr int P = 16 * I + 1;
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < I; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const float x = masked(SLOPE ? __fmul_rn(s[i][j], scale)
                                   : s[i][j] * scale,
                             q0 + r, k0 + c, S, causal, bias);
      const float p = x <= kNeg / 2 ? 0.f : expf(x - lse_s[r]);
      if (p_s != nullptr) p_s[r * P + c] = p;
      ds_s[r * P + c] = p * (dp[i][j] - dl_s[r]) * scale;
    }
}

// lse / delta of rows [q0, q0 + R) of head bh -> shared (0 past S)
template <int R>
__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int bh, int q0, int S) {
  if (threadIdx.x < R) {
    const int row = q0 + threadIdx.x;
    const long long at = (long long)bh * S + row;
    lse_s[threadIdx.x] = row < S ? lse[at] : 0.f;
    dl_s[threadIdx.x] = row < S ? delta[at] : 0.f;
  }
}

template <int I, int J>
__device__ __forceinline__ void zero(float (&a)[I][J]) {
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) a[i][j] = 0.f;
}

// One parameter block for both dQ instantiations; the tensor maps are the
// tensor-core kernels' and stay zero for fp32.
struct DqParams {
  CUtensorMap q_map, do_map, k_map, v_map;
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  const float* slopes;
  int window, S, H, Hkv, causal;
  float scale;
};

// ---- dQ, fp32: CUDA cores -------------------------------------------------

template <int D>
constexpr size_t dq_smem_floats() {
  constexpr int R = bwd_rows<D>();
  return 4 * R * pitch<D>() + R * (R + 1) + 2 * R;
}

template <bool SLOPE, bool WINDOW, int D>
__device__ __forceinline__ void dq_cuda_cores(const DqParams& p,
                                              float* smem) {
  using T = float;
  constexpr int PD = pitch<D>(), J = D / 16;   // J: output columns a thread
  // R rows and keys a tile, I = R / 16 of them a thread, pitch PR
  constexpr int R = bwd_rows<D>(), I = R / 16, PR = R + 1;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  T* dq = static_cast<T*>(p.dq);
  const int S = p.S, causal = p.causal;
  const float scale = p.scale;
  float* q_s = smem;             // [R][PD]
  float* do_s = q_s + R * PD;    // [R][PD]
  float* k_s = do_s + R * PD;    // [R][PD]
  float* v_s = k_s + R * PD;     // [R][PD]
  float* ds_s = v_s + R * PD;    // [R][PR]
  float* lse_s = ds_s + R * PR;
  float* dl_s = lse_s + R;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * R;
  const Heads hd(S, p.H, p.Hkv, D);
  const Bias<SLOPE, WINDOW> bias(p.slopes, hd.h, p.window);
  load_tile<T, D, R>(q_s, q, hd.q_base, hd.q_stride, q0, S, 1.f);
  load_tile<T, D, R>(do_s, dout, hd.q_base, hd.q_stride, q0, S, 1.f);
  load_rows<R>(lse_s, dl_s, p.lse, p.delta, hd.bh, q0, S);

  float acc[I][J];
  zero(acc);
  const int kv_hi = causal ? min(S, q0 + R) : S;
  for (int k0 = bias.template key_lo<R>(q0); k0 < kv_hi; k0 += R) {
    __syncthreads();  // previous dS K done
    load_tile<T, D, R>(k_s, k, hd.kv_base, hd.kv_stride, k0, S, 1.f);
    load_tile<T, D, R>(v_s, v, hd.kv_base, hd.kv_stride, k0, S, 1.f);
    __syncthreads();
    float s[I][I], dp[I][I];
    zero(s);
    zero(dp);
    gemm_nt<I, I, D, PD, PD>(s, q_s, k_s, ty, tx);
    gemm_nt<I, I, D, PD, PD>(dp, do_s, v_s, ty, tx);
    probs_and_ds(s, dp, lse_s, dl_s, nullptr, ds_s, q0, k0, S, scale, causal,
                 bias, ty, tx);
    __syncthreads();
    gemm_nn<I, J, R, PR, PD>(acc, ds_s, k_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int qrow = q0 + ty + 16 * i;
    if (qrow < S) {
      T* row = dq + hd.q_base + (long long)qrow * hd.q_stride;
#pragma unroll
      for (int j = 0; j < J; ++j) row[tx + 16 * j] = from_f<T>(acc[i][j]);
    }
  }
}

// ---- dQ, bf16 / fp16: tensor cores ----------------------------------------

namespace tcq {
constexpr int BM = 128;                      // query rows of a block
constexpr int BN = 64;                       // keys of a K/V tile
constexpr int kThreads = 384;                // 2 consumer + 1 producer WG
constexpr int kQBox = BM * hopper::kBoxCols * 2;    // one 64-column box
constexpr int kKvBox = BN * hopper::kBoxCols * 2;
// The shared-memory plan at head dim D: Q, dO, then kStages x (K, V),
// then the barriers: Q/dO's, full[], empty[].  Tiles are whole 64-column
// boxes (D = 80 and 96 take D = 128's).  At D = 256 Q and dO take 64 KB
// each and a K/V stage 64 KB, so the ring has one stage (192 KB).
template <int D>
struct Smem {
  // 32 and 16 KB at D = 80, 96 and 128; half that at 64, twice at 256
  static constexpr int kQTile = BM * hopper::box_cols<D>() * 2;
  static constexpr int kKvTile = BN * hopper::box_cols<D>() * 2;
  static constexpr int kStages = D == 64 ? 4 : D == 256 ? 1 : 2;
  static constexpr int kStageOffset = 2 * kQTile;
  static constexpr int kBarOffset = kStageOffset + kStages * 2 * kKvTile;
  static constexpr size_t kBytes = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};
}  // namespace tcq

template <typename E, bool SLOPE, bool WINDOW, int D>
__device__ __forceinline__ void dq_tensor_cores(const DqParams& p,
                                                unsigned char* raw) {
  using namespace hopper;
  using namespace tcq;
  constexpr int kQTile = Smem<D>::kQTile, kKvTile = Smem<D>::kKvTile;
  constexpr int kStages = Smem<D>::kStages;
  constexpr int kStageOffset = Smem<D>::kStageOffset;
  constexpr int kBarOffset = Smem<D>::kBarOffset;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = base;
  unsigned char* do_s = base + kQTile;
  unsigned char* kv_s = base + kStageOffset;       // [stage][K, V]
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(base + kBarOffset);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kStages;

  const int S = p.S, H = p.H, bh = blockIdx.x, h = bh % H, b = bh / H;
  const int hk = h / (H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // longest rows first
  const int window = WINDOW ? p.window : 0;
  int k_lo = 0;                          // _k_range: the window's first tile
  if (WINDOW && window > 0 && q0 - (window - 1) > 0)
    k_lo = (q0 - (window - 1)) / BN * BN;
  const int k_hi = p.causal ? min(S, q0 + BM) : S;
  const int n_tiles = (k_hi - k_lo + BN - 1) / BN;

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
      mbar_arrive_expect_tx(q_bar, 2 * kQTile);
      tma_load_rows<D>(q_s, &p.q_map, q_bar, BM, h, q0, b);
      tma_load_rows<D>(do_s, &p.do_map, q_bar, BM, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        unsigned char* k_t = kv_s + st * 2 * kKvTile;
        const int k0 = k_lo + it * BN;
        mbar_arrive_expect_tx(&full[st], 2 * kKvTile);
        tma_load_rows<D>(k_t, &p.k_map, &full[st], BN, hk, k0, b);
        tma_load_rows<D>(k_t + kKvTile, &p.v_map, &full[st], BN, hk, k0, b);
      }
    }
  } else {  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    regs_alloc<240>();
    const int r_first = q0 + 64 * wg, r_last = r_first + 63;
    const int row0 = r_first + acc_row(0, t);       // and row0 + 8
    const float slope = SLOPE ? __ldg(p.slopes + h) : 0.f;
    const float scale = p.scale;
    const uint32_t q_addr = smem_u32(q_s) + 64 * wg * 128;
    const uint32_t do_addr = smem_u32(do_s) + 64 * wg * 128;
    // this thread's two rows' LSE (times log2 e) and delta, 0 past S
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const long long at = (long long)bh * S + row;
      lse2[r] = row < S ? __ldg(p.lse + at) * kLog2e : 0.f;
      dl[r] = row < S ? __ldg(p.delta + at) : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    mbar_wait(q_bar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages, k0 = k_lo + it * BN;
      const bool unseen =
          (p.causal && k0 > r_last) || r_first >= S ||
          (WINDOW && window > 0 && r_first - (k0 + BN - 1) >= window);
      mbar_wait(&full[st], (it / kStages) & 1);
      if (!unseen) {
        const uint32_t k_addr = smem_u32(kv_s) + st * 2 * kKvTile;
        const uint32_t v_addr = k_addr + kKvTile;
        // S = Q K^T and dP = dO V^T, both operands K-major
        float s[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t q_off = kslice(kk, kQBox);
          const uint32_t kv_off = kslice(kk, kKvBox);
          wgmma_ss_n64<E>(s, desc_kmajor(q_addr + q_off),
                          desc_kmajor(k_addr + kv_off), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t q_off = kslice(kk, kQBox);
          const uint32_t kv_off = kslice(kk, kKvBox);
          wgmma_ss_n64<E>(dp, desc_kmajor(do_addr + q_off),
                          desc_kmajor(v_addr + kv_off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        const bool edge =
            (p.causal && k0 + BN - 1 > r_first) || k0 + BN > S ||
            (WINDOW && window > 0 && r_last - k0 >= window);
        // P = exp(S scale (+ slope key) - LSE), 0 where masked; then
        // dS = P (dP - delta) scale on the accumulator registers
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i / 2) % 2;
          const int key = k0 + acc_col(i, t), row = row0 + 8 * r;
          float x = __fmul_rn(s[i], scale);
          if (SLOPE) x = __fadd_rn(x, __fmul_rn(slope, (float)key));
          if (edge) {
            bool ok = key < S && (!p.causal || key <= row);
            if (WINDOW) ok = ok && (window <= 0 || row - key < window);
            if (!ok) x = kNeg;
          }
          const float pr = ex2(fmaf(x, kLog2e, -lse2[r]));
          dp[i] = pr * (dp[i] - dl[r]) * scale;
        }
        // dQ += dS K: dS rounded to E as register A operands, K read
        // transposed (MN-major: its keys are the depth) from the same tile
        uint32_t da[16];
        acc_to_a<E>(dp, da);
        fence_regs(dq);
        fence_regs(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                                 da[4 * kk + 3]};
          wgmma_rs<E, D>(dq, a, desc_mnmajor(k_addr + kk * 2048, kKvBox));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(da);
      }
      mbar_arrive(&empty[st]);
    }

    E* out = static_cast<E*>(p.dq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      uint32_t* orow = reinterpret_cast<uint32_t*>(
          out + (((long long)b * S + row) * H + h) * D);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        orow[(8 * j + 2 * (t % 4)) / 2] =
            pack2<E>(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    }
  }
}

template <typename T>
constexpr int dq_threads() {
  return std::is_same<T, float>::value ? kThreads : tcq::kThreads;
}

template <typename T, bool SLOPE, bool WINDOW, int D>
__global__ void __launch_bounds__(dq_threads<T>(), 1)
flash_bwd_dq_kernel(const __grid_constant__ DqParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (std::is_same<T, float>::value)
    dq_cuda_cores<SLOPE, WINDOW, D>(p, reinterpret_cast<float*>(smem_raw));
  else
    dq_tensor_cores<T, SLOPE, WINDOW, D>(p, smem_raw);
}

// One parameter block for both dK/dV instantiations; the tensor maps are
// the tensor-core kernels' and stay zero for fp32.
struct DkvParams {
  CUtensorMap q_map, k_map, v_map, do_map;
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  float* dk;
  float* dv;
  const float* slopes;
  int window, S, H, Hkv, causal;
  float scale;
};

// ---- dK/dV, fp32: CUDA cores --------------------------------------------

template <int D>
constexpr size_t dkv_smem_floats() {
  constexpr int R = bwd_rows<D>();
  return 4 * R * pitch<D>() + 2 * R * (R + 1) + 2 * R;
}

template <bool SLOPE, bool WINDOW, int D>
__device__ __forceinline__ void dkv_cuda_cores(const DkvParams& p,
                                               float* smem) {
  using T = float;
  constexpr int PD = pitch<D>(), J = D / 16;   // J: output columns a thread
  // R keys and rows a tile, I = R / 16 of them a thread, pitch PR
  constexpr int R = bwd_rows<D>(), I = R / 16, PR = R + 1;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const int S = p.S, causal = p.causal;
  const float scale = p.scale;
  float* k_s = smem;             // [R][PD]
  float* v_s = k_s + R * PD;     // [R][PD]
  float* q_s = v_s + R * PD;     // [R][PD]
  float* do_s = q_s + R * PD;    // [R][PD]
  float* p_s = do_s + R * PD;    // [R][PR]
  float* ds_s = p_s + R * PR;    // [R][PR]
  float* lse_s = ds_s + R * PR;
  float* dl_s = lse_s + R;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * R;
  const Heads hd(S, p.H, p.Hkv, D);
  const Bias<SLOPE, WINDOW> bias(p.slopes, hd.h, p.window);
  load_tile<T, D, R>(k_s, k, hd.kv_base, hd.kv_stride, k0, S, 1.f);
  load_tile<T, D, R>(v_s, v, hd.kv_base, hd.kv_stride, k0, S, 1.f);

  float dk_acc[I][J], dv_acc[I][J];
  zero(dk_acc);
  zero(dv_acc);
  // causal: q tiles before this key tile's diagonal see none of its keys;
  // window: q tiles from q_hi on are past the window of all of them
  const int q_hi = bias.template q_hi<R>(k0, S);
  for (int q0 = causal ? k0 : 0; q0 < q_hi; q0 += R) {
    __syncthreads();  // previous tile's products done
    load_tile<T, D, R>(q_s, q, hd.q_base, hd.q_stride, q0, S, 1.f);
    load_tile<T, D, R>(do_s, dout, hd.q_base, hd.q_stride, q0, S, 1.f);
    load_rows<R>(lse_s, dl_s, p.lse, p.delta, hd.bh, q0, S);
    __syncthreads();
    float s[I][I], dp[I][I];
    zero(s);
    zero(dp);
    gemm_nt<I, I, D, PD, PD>(s, q_s, k_s, ty, tx);
    gemm_nt<I, I, D, PD, PD>(dp, do_s, v_s, ty, tx);
    probs_and_ds(s, dp, lse_s, dl_s, p_s, ds_s, q0, k0, S, scale, causal,
                 bias, ty, tx);
    __syncthreads();
    gemm_tn<I, J, R, PR, PD>(dv_acc, p_s, do_s, ty, tx);
    gemm_tn<I, J, R, PR, PD>(dk_acc, ds_s, q_s, ty, tx);
  }

  // fp32, per query head: row `key` of head h in the [B, S, H, D] layout
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key < S) {
      const long long at = hd.q_base + (long long)key * hd.q_stride;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        p.dk[at + tx + 16 * j] = dk_acc[i][j];
        p.dv[at + tx + 16 * j] = dv_acc[i][j];
      }
    }
  }
}

// ---- dK/dV, bf16 / fp16: tensor cores -------------------------------------

namespace tc {
constexpr int BN = 128;                      // keys of a block
constexpr int BM = 64;                       // query rows of a Q/dO tile
constexpr int kThreads = 384;                // 2 consumer + 1 producer WG
constexpr int kQBox = BM * hopper::kBoxCols * 2;   // one 64-column box
// The shared-memory plan at head dim D: K, V, then kStages x (Q, dO),
// kStages x (lse, delta) rows, the barriers: K/V's, full[], empty[].
// Tiles are whole 64-column boxes (D = 80 and 96 take D = 128's).  At D =
// 256 a block takes 64 keys, which both consumer warpgroups share: each
// owns 128 of dK's and dV's 256 columns (kSplit; the header says why).
template <int D>
struct Smem {
  static constexpr int kKeys = D == 256 ? 64 : BN;   // keys of a block
  static constexpr bool kSplit = D == 256;   // warpgroups split D, not keys
  // K, V: 32 KB at D = 80, 96, 128 and 256, 16 at 64; Q, dO: half that
  // but 32 at 256
  static constexpr int kKvTile = kKeys * hopper::box_cols<D>() * 2;
  static constexpr int kKvBox = kKeys * hopper::kBoxCols * 2;
  static constexpr int kQTile = BM * hopper::box_cols<D>() * 2;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kStageOffset = 2 * kKvTile;
  static constexpr int kRowsOffset = kStageOffset + kStages * 2 * kQTile;
  static constexpr int kBarOffset = kRowsOffset + kStages * 2 * BM * 4;
  static constexpr size_t kBytes = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};
}  // namespace tc

template <typename E, bool SLOPE, bool WINDOW, int D>
__device__ __forceinline__ void dkv_tensor_cores(const DkvParams& p,
                                                 unsigned char* raw) {
  using namespace hopper;
  using namespace tc;
  using Plan = Smem<D>;
  constexpr int kKvTile = Plan::kKvTile, kQTile = Plan::kQTile;
  constexpr int kKvBox = Plan::kKvBox, kKeys = Plan::kKeys;
  constexpr int kStages = Plan::kStages;
  constexpr bool kSplit = Plan::kSplit;
  // the columns of dK and dV a warpgroup owns: all D, or 128 at D = 256
  constexpr int N = kSplit ? 128 : D;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  unsigned char* k_s = base;
  unsigned char* v_s = base + kKvTile;
  unsigned char* qdo_s = base + Plan::kStageOffset;   // [stage][Q, dO]
  float* rows_s = reinterpret_cast<float*>(base + Plan::kRowsOffset);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(base + Plan::kBarOffset);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + kStages;

  const int S = p.S, H = p.H, bh = blockIdx.x, h = bh % H, b = bh / H;
  const int hk = h / (H / p.Hkv);
  const int k0 = blockIdx.y * kKeys;       // causal: longest q loops first
  const int window = WINDOW ? p.window : 0;
  // the q loop: from the diagonal to the last row that sees key k0 +
  // kKeys - 1
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi =
      WINDOW && window > 0
          ? (int)min((long long)S, (long long)k0 + kKeys - 1 + window)
          : S;
  const int n_tiles = (q_hi - q_lo + BM - 1) / BM;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);     // the producer warp's lanes
      mbar_init(&empty[s], 256);   // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: warp 0 of the last warpgroup
    regs_dealloc<24>();
    if (t < 32) {
      if (t == 0) {
        mbar_arrive_expect_tx(kv_bar, 2 * kKvTile);
        tma_load_rows<D>(k_s, &p.k_map, kv_bar, kKeys, hk, k0, b);
        tma_load_rows<D>(v_s, &p.v_map, kv_bar, kKeys, hk, k0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages, q0 = q_lo + it * BM;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        // lse and delta of the tile's rows (0 past S), by the lanes
        float* lse_s = rows_s + st * 2 * BM;
#pragma unroll
        for (int r = t; r < BM; r += 32) {
          const long long at = (long long)bh * S + q0 + r;
          lse_s[r] = q0 + r < S ? p.lse[at] * kLog2e : 0.f;
          lse_s[BM + r] = q0 + r < S ? p.delta[at] : 0.f;
        }
        if (t == 0) {
          unsigned char* q_t = qdo_s + st * 2 * kQTile;
          mbar_arrive_expect_tx(&full[st], 2 * kQTile);
          tma_load_rows<D>(q_t, &p.q_map, &full[st], BM, h, q0, b);
          tma_load_rows<D>(q_t + kQTile, &p.do_map, &full[st], BM, h, q0,
                           b);
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63, or at
            // D = 256 all 64 keys and columns 128 wg .. + 127
    regs_alloc<240>();
    const int kw = kSplit ? k0 : k0 + 64 * wg;
    const int key0 = kw + acc_row(0, t);              // and key0 + 8
    const float scale = p.scale;
    const float slope = SLOPE ? __ldg(p.slopes + h) : 0.f;
    const uint32_t k_addr = smem_u32(k_s) + (kSplit ? 0 : 64 * wg * 128);
    const uint32_t v_addr = smem_u32(v_s) + (kSplit ? 0 : 64 * wg * 128);
    // byte offset of this warpgroup's columns in a Q or dO tile
    const uint32_t c_off = kSplit ? 2 * wg * kQBox : 0;
    float dk[N / 2], dv[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kv_bar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages, q0 = q_lo + it * BM;
      const bool unseen =
          (p.causal && q0 + BM - 1 < kw) || kw >= S ||
          (WINDOW && window > 0 && q0 - (kw + 63) >= window);
      mbar_wait(&full[st], (it / kStages) & 1);
      if (!unseen) {
        const uint32_t q_addr = smem_u32(qdo_s) + st * 2 * kQTile;
        const uint32_t do_addr = q_addr + kQTile;
        const float* lse_s = rows_s + st * 2 * BM;
        const float* dl_s = lse_s + BM;
        const bool edge =
            q0 + BM > S || kw + 64 > S || (p.causal && q0 < kw + 63) ||
            (WINDOW && window > 0 && q0 + BM - 1 - kw >= window);
        // S^T = K Q^T and dP^T = V dO^T: keys are the rows (at D = 256
        // both warpgroups compute both, for the same 64 keys)
        float s[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64<E>(s, desc_kmajor(k_addr + kslice(kk, kKvBox)),
                          desc_kmajor(q_addr + kslice(kk, kQBox)), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64<E>(dp, desc_kmajor(v_addr + kslice(kk, kKvBox)),
                          desc_kmajor(do_addr + kslice(kk, kQBox)), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // P^T first: dV += P^T dO starts on the tensor cores (P^T as E
        // A operands from registers, dO read transposed: its rows are the
        // depth) while dS^T is formed; then dK += dS^T Q the same way --
        // both over this warpgroup's N columns of dO and Q
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = acc_col(i, t), qrow = q0 + c;
          const int key = key0 + 8 * ((i / 2) % 2);
          float x = __fmul_rn(s[i], scale);
          if (SLOPE) x = __fadd_rn(x, __fmul_rn(slope, (float)key));
          if (edge) {
            bool ok = qrow < S && key < S && (!p.causal || key <= qrow);
            if (WINDOW) ok = ok && (window <= 0 || qrow - key < window);
            if (!ok) x = kNeg;
          }
          s[i] = ex2(fmaf(x, kLog2e, -lse_s[c]));   // 0 where masked
        }
        uint32_t pa[16], da[16];
        acc_to_a<E>(s, pa);
        fence_regs(dv);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
          const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                                 pa[4 * kk + 3]};
          wgmma_rs<E, N>(dv, a, desc_mnmajor(do_addr + c_off + kk * 2048,
                                             kQBox));
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = acc_col(i, t);
          dp[i] = s[i] * (dp[i] - dl_s[c]) * scale;
        }
        acc_to_a<E>(dp, da);
        fence_regs(dk);
        fence_regs(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
          const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                                 da[4 * kk + 3]};
          wgmma_rs<E, N>(dk, a, desc_mnmajor(q_addr + c_off + kk * 2048,
                                             kQBox));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(pa);
        fence_regs(da);
      }
      mbar_arrive(&empty[st]);
    }

    // fp32, per query head: row `key` of head h in the [B, S, H, D]
    // layout, this warpgroup's N columns from column c0
    const int c0 = kSplit ? 128 * wg : 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= S) continue;
      const long long at = (((long long)b * S + key) * H + h) * D + c0;
      float2* dk_row = reinterpret_cast<float2*>(p.dk + at);
      float2* dv_row = reinterpret_cast<float2*>(p.dv + at);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int c2 = (8 * j + 2 * (t % 4)) / 2;
        dk_row[c2] = make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        dv_row[c2] = make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <typename T>
constexpr int dkv_threads() {
  return std::is_same<T, float>::value ? kThreads : tc::kThreads;
}

template <typename T, bool SLOPE, bool WINDOW, int D>
__global__ void __launch_bounds__(dkv_threads<T>(), 1)
flash_bwd_dkv_kernel(const __grid_constant__ DkvParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (std::is_same<T, float>::value)
    dkv_cuda_cores<SLOPE, WINDOW, D>(p, reinterpret_cast<float*>(smem_raw));
  else
    dkv_tensor_cores<T, SLOPE, WINDOW, D>(p, smem_raw);
}

template <typename T, bool SLOPE, bool WINDOW, int D>
int launch_dq(const DqParams& p, int B, cudaStream_t stream) {
  constexpr bool fp32 = std::is_same<T, float>::value;
  const size_t smem =
      fp32 ? dq_smem_floats<D>() * sizeof(float) : tcq::Smem<D>::kBytes;
  // once per instantiation, before any graph capture can be running
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, SLOPE, WINDOW, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  constexpr int R = bwd_rows<D>();
  const dim3 grid = fp32 ? dim3((p.S + R - 1) / R, B * p.H)
                         : dim3(B * p.H, (p.S + tcq::BM - 1) / tcq::BM);
  flash_bwd_dq_kernel<T, SLOPE, WINDOW, D>
      <<<grid, dq_threads<T>(), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool SLOPE, bool WINDOW, int D>
int launch_dkv(const DkvParams& p, int B, cudaStream_t stream) {
  constexpr bool fp32 = std::is_same<T, float>::value;
  const size_t smem =
      fp32 ? dkv_smem_floats<D>() * sizeof(float) : tc::Smem<D>::kBytes;
  // once per instantiation, before any graph capture can be running
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, SLOPE, WINDOW, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  constexpr int R = fp32 ? bwd_rows<D>() : tc::Smem<D>::kKeys;
  const dim3 grid = fp32 ? dim3((p.S + R - 1) / R, B * p.H)
                         : dim3(B * p.H, (p.S + R - 1) / R);
  flash_bwd_dkv_kernel<T, SLOPE, WINDOW, D>
      <<<grid, dkv_threads<T>(), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq_biased(const DqParams& p, int B, cudaStream_t stream) {
  return with_bias(p.slopes, p.window, [&](auto slope, auto win) {
    return launch_dq<T, decltype(slope)::value, decltype(win)::value, D>(
        p, B, stream);
  });
}

template <typename T, int D>
int launch_dkv_biased(const DkvParams& p, int B, cudaStream_t stream) {
  return with_bias(p.slopes, p.window, [&](auto slope, auto win) {
    return launch_dkv<T, decltype(slope)::value, decltype(win)::value, D>(
        p, B, stream);
  });
}

// The tensor-core kernels: their tensor maps (Q and dO at H heads, K and V
// at Hkv, each kernel's own tile rows), then the launch.
template <typename E, int Q_ROWS, int KV_ROWS, int D, typename P>
int make_maps(P& p, int B) {
  using hopper::make_head_map;
  const int S = p.S, H = p.H, Hkv = p.Hkv;
  int rc = make_head_map<E>(&p.q_map, p.q, B, S, H, Q_ROWS, D);
  if (!rc) rc = make_head_map<E>(&p.do_map, p.dout, B, S, H, Q_ROWS, D);
  if (!rc) rc = make_head_map<E>(&p.k_map, p.k, B, S, Hkv, KV_ROWS, D);
  if (!rc) rc = make_head_map<E>(&p.v_map, p.v, B, S, Hkv, KV_ROWS, D);
  return rc;
}

template <typename E, int D>
int launch_dq_tensor_cores(DqParams& p, int B, cudaStream_t stream) {
  const int rc = make_maps<E, tcq::BM, tcq::BN, D>(p, B);
  return rc ? rc : launch_dq_biased<E, D>(p, B, stream);
}

template <typename E, int D>
int launch_dkv_tensor_cores(DkvParams& p, int B, cudaStream_t stream) {
  const int rc = make_maps<E, tc::BM, tc::Smem<D>::kKeys, D>(p, B);
  return rc ? rc : launch_dkv_biased<E, D>(p, B, stream);
}

}  // namespace

// q/dout/dq: [B, S, H, D]; k/v: [B, S, Hkv, D] (one dtype: 0 = float32,
// 1 = bfloat16, 2 = float16); lse/delta: fp32 [B, H, S].  slopes: fp32 [H]
// ALiBi slopes or null; window: the sliding window, <= 0 for none.  D is 64,
// 80, 96, 128 or 256.  Return cudaGetLastError().
extern "C" int ds_flash_attention_bwd_dq(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq, const void* slopes, int B,
                                         int S, int H, int Hkv, int D,
                                         int causal, int dtype, int window,
                                         float scale, void* stream) {
  const int bad = dsflash::check_shape(B, S, H, Hkv, D);
  if (bad) return bad;
  DqParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.slopes = static_cast<const float*>(slopes);
  p.window = window;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dsflash::with_head_dim(D, [&](auto d) {
    constexpr int Dc = decltype(d)::value;
    if (dtype == 0) return launch_dq_biased<float, Dc>(p, B, s);
    if (dtype == 1) return launch_dq_tensor_cores<__nv_bfloat16, Dc>(p, B, s);
    if (dtype == 2) return launch_dq_tensor_cores<__half, Dc>(p, B, s);
    return (int)cudaErrorInvalidValue;
  });
}

// dk/dv: fp32 [B, S, H, D], one row block per QUERY head (summed over the
// GQA group by the caller).
extern "C" int ds_flash_attention_bwd_dkv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dk, void* dv,
                                          const void* slopes, int B, int S,
                                          int H, int Hkv, int D, int causal,
                                          int dtype, int window, float scale,
                                          void* stream) {
  const int bad = dsflash::check_shape(B, S, H, Hkv, D);
  if (bad) return bad;
  DkvParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.slopes = static_cast<const float*>(slopes);
  p.window = window;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dsflash::with_head_dim(D, [&](auto d) {
    constexpr int Dc = decltype(d)::value;
    if (dtype == 0) return launch_dkv_biased<float, Dc>(p, B, s);
    if (dtype == 1) return launch_dkv_tensor_cores<__nv_bfloat16, Dc>(p, B, s);
    if (dtype == 2) return launch_dkv_tensor_cores<__half, Dc>(p, B, s);
    return (int)cudaErrorInvalidValue;
  });
}
