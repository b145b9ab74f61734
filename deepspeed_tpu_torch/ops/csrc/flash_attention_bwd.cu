// Flash attention backward for Hopper (sm_90a): two kernels, as on the TPU.
//
// Replaces deepspeed_tpu/ops/pallas/flash_attention.py: _bwd_dq_kernel
// and _bwd_dq_kernel_biased (body _bwd_dq_impl), _bwd_dkv_kernel and
// _bwd_dkv_kernel_biased (body _bwd_dkv_impl); host side
// _flash_bwd_pallas.  Both recompute P = exp(scale * Q K^T - LSE) tile by
// tile from the forward's fp32 LSE, zeroing it where the score is masked
// (so a masked entry contributes exactly 0), and use delta = sum_d dO * O
// (fp32 [B, H, S], the delta kernel at the end of this file):
//   dS = P * (dO V^T - delta) * scale
//   dQ = sum over key tiles of dS K          (items of 128 query rows)
//   dK = sum over q tiles of dS^T Q,  dV = sum over q tiles of P^T dO
//                                            (items of 128 keys)
// dQ is stored in q's dtype.  dK and dV are stored in k's dtype at [B, S,
// Hkv, D], as the function returns them, when the GQA group is 1 and, in
// bf16 / fp16 at head dim 256, at every group (the group summed on the
// card, in a thread-block cluster); otherwise at a larger group in fp32
// per QUERY head ([B, S, H, D]), which the wrapper sums over the group
// and casts, as _flash_bwd_pallas does.  No atomics either way, so runs
// repeat bit for bit.  The biased
// instantiations add slope[h] * key after the scale and mask keys outside
// the sliding window, as the TPU kernels do; the dQ kernel's key loop
// starts at the first tile the window reaches, and the dK/dV kernel's q
// loop ends after the last q tile that can see its keys.  Any S is taken:
// ragged last tiles are masked.
//
// What bounds them on the H100: at gpt_1b's training shape (B=2, S=1024,
// 16 heads of 128, causal, bf16) dQ does 3*B*H*S^2*D = 12.9 GFLOP on 42 MB,
// 307 flop per byte, over the ~295 flop/byte ridge: the tensor cores bound
// it (13.0 us).  dK/dV does 4*B*H*S^2*D = 17.2 GFLOP on 51 MB (dK and dV
// counted in k's dtype at Hkv heads, as the function returns them), 340
// flop per byte: the tensor cores bound it too (17.4 us).  At group 1 it
// writes dK and dV in k's dtype, as counted; at a larger group its fp32
// per-query-head outputs write 2 x group x as many bytes (not at head dim
// 256 in bf16 / fp16, which sums the group on the card).  BLOOM's ALiBi layers
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
// dK/dV at head dim 128: tensor cores fed by TMA.  One block of three
// warpgroups per (128-key tile, b * h), the key tiles with the longest
// causal q loops first.  K and V (32 KB each) stay in shared memory for
// the block; a producer warp streams 64-row Q and dO tiles through a two-stage ring
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
// dQ at head dim 128, bf16/fp16: the same shape as the forward with two
// score products, dS in P's place.  One block of three
// warpgroups per (128-row q tile, b * h), the q tiles with the longest
// causal key loops first.  A producer warp
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
// Head dims 64 (gpt_350m), 80 (gpt_2_7b) and 96 (gpt_760m), bf16 / fp16:
// bodies of their own (pb:: below).  At gpt_2_7b's training shape (B=8,
// S=1024, 32 heads of 80, causal) dQ does 64.4 GFLOP and dK/dV 85.9, at
// gpt_760m's (16 heads of 96) 38.7 and 51.5, at gpt_350m's (16 of 64)
// 25.8 and 34.4: all bound by the tensor cores (dQ 65.1, 39.1, 26.1 us;
// dK/dV 86.9, 52.1, 34.7 us).  The D = 128 bodies above ran them at 4.0,
// 3.6 and 4.4x (dQ) and 5.0, 4.2 and 4.6x (dK/dV) those bounds: each
// warpgroup ran its score products, then the exponentials and dS on the
// accumulators, then the accumulating products, in series and in step
// with the other; a 64-key (or 64-row) tile's products at these D are
// 1/2 to 3/4 as long as at 128, and the elementwise work a score is not;
// and every block paid its own start (barriers, the resident tiles, the
// ring's fill) for 2-16 tiles.  What the bodies do about it:
//   * persistent: one block an SM walks items -- dQ a 128-row q tile, dK/dV
//     a 128-key tile -- in pairs of equal causal work, head by head
//     (pb::Pairs), the producer streaming every item's 64-row tiles
//     through one ring, so a block's start is paid once;
//   * fewer FP32 operations a score: scale * log2(e) folded into the FFMA
//     that feeds ex2 (ALiBi's slope * key * log2(e) into the same chain),
//     dS = P * fma(dP, scale, -delta * scale) with delta * scale formed once
//     a row (dS keeps its magnitude: in fp16 it is rounded to an A operand
//     while the loss scale rides in dO), masks only on tiles that cross a
//     row's bounds, as two compares;
//   * the tensor cores kept busy through the elementwise work
//     (pb::walk_tiles): dQ in FA3's order within a warpgroup -- S and dP
//     of the next key tile issued with dQ += dS K of this one, its P and
//     dS formed while that product runs; dK/dV with the two warpgroups
//     taking turns to issue (ping-pong on named barriers 1 and 2), so one
//     warpgroup's products run under the other's exponentials;
//   * a deeper ring: at 80 and 96 one resident buffer and 4 stages of
//     32 KB (192 KB; the producer loads an item's resident tiles after its
//     first streamed one), at 64 two buffers and 6 stages of 16 KB;
//   * dK/dV's producer in two warps, one issuing TMA, one writing the
//     stages' LSE and delta rows, whose global loads had held up the ring
//     when one warp did both;
//   * dQ, dK and dV stored 16 bytes a lane (store_rows).
// A tile is two 64-column TMA boxes at 80 and 96, whose columns past D
// TMA fills with zeros without reading HBM; the score products walk D / 16
// slices and the products whose N is D are m64nD.  Registers: dQ's
// consumers hold S, dP (32 + 32), dS as A operands (16) and dQ (D / 2) of
// setmaxnreg's 240; dK/dV's hold S^T, dP^T (32 + 32), P^T and dS^T (16 +
// 16, not while S^T and dP^T are), dK and dV (D) of 232, its producer
// warps 40 (at 24 they spilled; at D = 96 the consumers spill unless the
// walk's constants and the item's indices are formed anew where used).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W by
// scripts/flash_kernel_ab.py (parent, this body, parent; bf16), dQ / dK/dV
// ms: gpt_2_7b's shape 0.2623 / 0.4297 -> 0.1601 / 0.2413, gpt_760m's
// 0.1389 / 0.2254 -> 0.0909 / 0.1337, gpt_350m's 0.1146 / 0.1596 ->
// 0.0691 / 0.1087: the pair 0.79x, 0.79x and 0.87x SDPA's backward (was
// 1.34x, 1.27x and 1.32x), 2.5, 2.3 and 2.6x (dQ) and 2.8, 2.6 and 3.1x
// (dK/dV) their bounds.  PERF.md has every plan tried.
//
// Head dim 256 (Gemma): a tile is four 64-column boxes, and every
// accumulator whose N is D is 128 fp32 registers a thread.  At Gemma-2B's
// training shape (B=2, S=2048, 8 heads of 256 over one kv head, causal)
// dQ does 51.5 GFLOP and dK/dV 68.7: bound by the tensor cores (52.1 and
// 69.5 us).
//   * dQ: the persistent body of 64-96 (dq_persistent, DqBody).  Q and dO
//     take 64 KB each, so a K/V stage of 64-key tiles (64 KB) left room
//     for one: on the D = 128 body each tile's loads waited for both
//     warpgroups to finish the tile before, in a grid of two uneven waves
//     (0.1373 ms, 0.38 of the bound).  Here the ring is three 32 KB slots
//     (pb::SlotRing): K in two, a tile ahead, and V in the third, which
//     the score products free -- V of the next tile streams in while this
//     tile's dS and dQ += dS K run, and S = Q K^T is issued before the
//     body waits for V.  The warpgroups run each tile in series, in step:
//     ping-pong turns read 1.6x slower, and FA3's order (the next tile's
//     score products under this tile's dQ) spilled 664-700 bytes and, on
//     a first slot order that put V of the next tile in K's slot,
//     deadlocked.  Registers: dQ 128 + S, dP 64 + dS 16 of setmaxnreg's
//     232 (the producer thread takes 40); the walk's state and Q's
//     descriptors are formed anew where used (held, they spilled 108-140
//     bytes).  Measured on an NVIDIA H100 80GB HBM3 at 700 W by
//     scripts/flash_kernel_ab.py (parent, this body, parent): 0.1353 /
//     0.1376 -> 0.1000 ms bf16, 0.1366 / 0.1381 -> 0.1013 fp16 (0.52 of
//     the bound); the backward as called 0.2903 ms, 0.88x SDPA's.
//   * dK/dV (dkv_cluster): a block owns 64 keys (K, V 64 KB) and streams
//     64-row Q and dO tiles through two stages (128 KB).  The body before
//     had both consumer warpgroups compute S^T and dP^T, each then owning
//     128 of dK's and dV's columns (1.5x the useful tensor-core work), and
//     wrote fp32 per query head at a GQA group, which the wrapper summed
//     and cast: 0.1936-0.1944 ms and, as called, 0.3830-0.3864 at Gemma-2B's
//     shape (1.15x SDPA's backward).  Now the warpgroups split the products
//     (DkvClusterBody, pb::walk_tiles in series, kDkvOrder256): warpgroup 0
//     forms S^T and P^T and runs dV += P^T dO, warpgroup 1 forms dP^T,
//     takes P^T in fp32 through shared memory (two 16 KB buffers, named
//     barriers 1-4) and runs dK += dS^T Q; each holds one m64n256
//     accumulator (FA3's order within a warpgroup spilled 4-72 bytes and
//     ran 1.37x slower).  The producer issues a tile's TMA before it loads
//     the tile's LSE and delta rows (expect_tx first, its arrival after the
//     rows): with the rows' loads first, dK/dV at group 1 (ALiBi, 8 heads)
//     read 0.1917 ms, after 0.1807.  At a GQA group the blocks of one key
//     tile form a thread-block cluster of C = the largest divisor of the
//     group up to 4 (cl::cluster_of), each walking group / C query heads; after the q loop they stage dK and dV in fp32 over K, V
//     and the ring and each block sums a fixed share of the rows over the
//     cluster's ranks in rank order through distributed shared memory,
//     storing k's dtype.  At group 1 dK and dV go straight from the
//     registers.  Clusters of 8 (one head a block) read 0.2349 ms, of 4
//     0.1913: the card holds 15 clusters of 8 of these blocks at once (120
//     SMs; 30 of 4), and the 8-way sum costs more.  The removed
//     doubled products bought little on their own: the block streams 64 KB
//     of Q and dO for every 8.4 MFLOP, and the L2-to-SM stream, not the
//     tensor cores, sets its pace (about 3 TB/s here; 32-row tiles in 4
//     stages ran 8% slower).  Measured on an NVIDIA H100 80GB HBM3 at 700
//     W by scripts/flash_kernel_ab.py: 0.1826 ms (fp16 0.1836), and the
//     backward as called 0.3273 (0.99x SDPA's 0.3322; fp16 0.3270, 0.97x);
//     PERF.md has every plan.
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
#include "wgmma_attention.cuh"

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
  int window, B, S, H, Hkv, causal;
  float scale, scale_log2e;   // the latter scale * log2(e), as the card
                              // rounds it
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
// The shared-memory plan at head dim D (128; 64, 80, 96 and 256 run the
// persistent body): Q, dO, then kStages x (K, V), then the barriers:
// Q/dO's, full[], empty[].  Tiles are whole 64-column boxes.
template <int D>
struct Smem {
  // 32 and 16 KB
  static constexpr int kQTile = BM * hopper::box_cols<D>() * 2;
  static constexpr int kKvTile = BN * hopper::box_cols<D>() * 2;
  static constexpr int kStages = 2;
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
  void* dk;   // k's dtype at [B, S, Hkv, D] when H == Hkv or in the
  void* dv;   // bf16 / fp16 forms at D = 256 (dkv_cluster sums the GQA
              // group), else fp32 at [B, S, H, D] (a row block per query
              // head)
  const float* slopes;
  int window, B, S, H, Hkv, causal;
  float scale, scale_log2e;   // the latter scale * log2(e), as the card
                              // rounds it
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
        static_cast<float*>(p.dk)[at + tx + 16 * j] = dk_acc[i][j];
        static_cast<float*>(p.dv)[at + tx + 16 * j] = dv_acc[i][j];
      }
    }
  }
}

// ---- dK/dV, bf16 / fp16: tensor cores -------------------------------------

// Rows row0 and row0 + 8 (r = 0, 1) of a warpgroup's m64nN fp32
// accumulator ``acc``, rounded to E, to rows[r] (N columns; a null row is
// not written).  The 4 lanes of a quad hold a row's column pairs 8 j + 2
// (t % 4); for each 4 groups j they transpose them by two shuffles, so
// that a lane writes the 8 columns of one group as one 16-byte store.
// Groups past a multiple of 4 (N = 80: 2) go a pair a lane.  Every lane of
// the warp must call it.
template <typename E, int N>
__device__ __forceinline__ void store_rows(E* const (&rows)[2],
                                           const float (&acc)[N / 2],
                                           int t) {
  using hopper::pack2;
  constexpr int kGroups = N / 8, kWide = kGroups / 4 * 4;
  const int q = t % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int m = 0; m < kWide; m += 4) {
      uint32_t v[4];   // v[k]: this lane's pair of group m + k
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = pack2<E>(acc[4 * (m + k) + 2 * r], acc[4 * (m + k) + 2 * r + 1]);
      uint32_t a0 = q & 1 ? v[0] : v[1], a1 = q & 1 ? v[2] : v[3];
      a0 = __shfl_xor_sync(0xffffffffu, a0, 1);
      a1 = __shfl_xor_sync(0xffffffffu, a1, 1);
      if (q & 1) {
        v[0] = a0;
        v[2] = a1;
      } else {
        v[1] = a0;
        v[3] = a1;
      }
      a0 = q & 2 ? v[0] : v[2];
      a1 = q & 2 ? v[1] : v[3];
      a0 = __shfl_xor_sync(0xffffffffu, a0, 2);
      a1 = __shfl_xor_sync(0xffffffffu, a1, 2);
      if (q & 2) {
        v[0] = a0;
        v[1] = a1;
      } else {
        v[2] = a0;
        v[3] = a1;
      }
      // v[k] is now lane k's pair of group m + q: its 8 columns in order
      if (rows[r] != nullptr)
        *reinterpret_cast<uint4*>(rows[r] + 8 * (m + q)) =
            make_uint4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (int j = kWide; j < kGroups; ++j)
      if (rows[r] != nullptr)
        *reinterpret_cast<uint32_t*>(rows[r] + 8 * j + 2 * q) =
            pack2<E>(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// A consumer thread's rows of dK and dV (keys key0 and key0 + 8 of head
// h; rows past S are not stored): in E at [B, S, Hkv, D] when the group is
// 1 (H == Hkv), the function's own output, 16 bytes a lane (store_rows; a
// column pair a lane measured 11% slower at gpt_2_7b's shape); else in
// fp32 at [B, S, H, D], one row block per query head, which the wrapper
// sums over the group and casts.
template <typename E, int D>
__device__ __forceinline__ void store_dkv(const DkvParams& p,
                                          const float (&dk)[D / 2],
                                          const float (&dv)[D / 2], int b,
                                          int h, int key0, int t) {
  const int S = p.S, H = p.H;
  if (H == p.Hkv) {
    E* rk[2];
    E* rv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      const long long at = (((long long)b * S + key) * H + h) * D;
      rk[r] = key < S ? static_cast<E*>(p.dk) + at : nullptr;
      rv[r] = key < S ? static_cast<E*>(p.dv) + at : nullptr;
    }
    store_rows<E, D>(rk, dk, t);
    store_rows<E, D>(rv, dv, t);
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= S) continue;
    const long long at = (((long long)b * S + key) * H + h) * D;
    float2* dk_row = reinterpret_cast<float2*>(static_cast<float*>(p.dk) + at);
    float2* dv_row = reinterpret_cast<float2*>(static_cast<float*>(p.dv) + at);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c2 = (8 * j + 2 * (t % 4)) / 2;
      dk_row[c2] = make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      dv_row[c2] = make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

namespace tc {
constexpr int BN = 128;                      // keys of a block
constexpr int BM = 64;                       // query rows of a Q/dO tile
constexpr int kThreads = 384;                // 2 consumer + 1 producer WG
constexpr int kQBox = BM * hopper::kBoxCols * 2;   // one 64-column box
// The shared-memory plan at head dim 128 (64, 80 and 96 run the
// persistent body, 256 the cluster body): K, V, then kStages x (Q, dO),
// kStages x (lse, delta) rows, the barriers: K/V's, full[], empty[].
// Tiles are whole 64-column boxes.
template <int D>
struct Smem {
  static constexpr int kKeys = BN;           // keys of a block
  // K, V: 32 KB; Q, dO: 16 KB
  static constexpr int kKvTile = kKeys * hopper::box_cols<D>() * 2;
  static constexpr int kKvBox = kKeys * hopper::kBoxCols * 2;
  static constexpr int kQTile = BM * hopper::box_cols<D>() * 2;
  static constexpr int kStages = 2;
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
  static_assert(D == 128, "one block per key tile: head dim 128");
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
  } else {  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63
    regs_alloc<240>();
    const int kw = k0 + 64 * wg;
    const int key0 = kw + acc_row(0, t);              // and key0 + 8
    const float scale = p.scale;
    const float slope = SLOPE ? __ldg(p.slopes + h) : 0.f;
    const uint32_t k_addr = smem_u32(k_s) + 64 * wg * 128;
    const uint32_t v_addr = smem_u32(v_s) + 64 * wg * 128;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

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
        // S^T = K Q^T and dP^T = V dO^T: keys are the rows
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
        // depth) while dS^T is formed; then dK += dS^T Q the same way
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
          wgmma_rs<E, D>(dv, a, desc_mnmajor(do_addr + kk * 2048, kQBox));
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
          wgmma_rs<E, D>(dk, a, desc_mnmajor(q_addr + kk * 2048, kQBox));
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

    store_dkv<E, D>(p, dk, dv, b, h, key0, t);
  }
}

// ---- dQ and dK/dV, bf16 / fp16, head dims 64, 80, 96: persistent ---------

namespace pb {
constexpr int BM = 128;     // rows of an item: q rows (dQ), keys (dK/dV)
constexpr int BN = 64;      // rows of a streamed tile: keys (dQ), q rows
                            // (dK/dV)
constexpr int kFar = 1 << 30;   // a bound no tile reaches
// The resident buffers (an item's Q and dO for dQ, its K and V for dK/dV)
// and the stages of the ring of streamed tiles (K and V, or Q and dO),
// each kernel at D = 64 and at D = 80 and 96.  With one resident buffer
// the producer loads an item's after its first streamed tile, once the
// consumers are done with the one before.
constexpr int kDqBufs64 = 2, kDqStages64 = 6;
constexpr int kDqBufs8096 = 1, kDqStages8096 = 4;
constexpr int kDkvBufs64 = 2, kDkvStages64 = 6;
constexpr int kDkvBufs8096 = 1, kDkvStages8096 = 4;
// The consumers' order within a warpgroup (walk_tiles): kSeries -- a
// tile's score products, its elementwise work, its accumulating products,
// each waited for; kFa3 -- FA3's order, the next tile's score products
// issued with this tile's accumulating ones and its elementwise work run
// under them.  kTurns: the two warpgroups take turns to issue their
// products (ping-pong on named barriers 1 and 2).
enum Order { kSeries, kFa3 };
constexpr Order kDqOrder = kFa3, kDkvOrder = kSeries;
constexpr bool kDqTurns = false, kDkvTurns = true;
// setmaxnreg's split of the launch's 168 registers a thread (384 x 168 =
// 128 x producer + 256 x consumer): the dK/dV producer warp walks the
// items and writes each stage's LSE and delta rows, which 24 registers do
// not hold without a spill.
constexpr int kDqProducerRegs = 24, kDqConsumerRegs = 240;
constexpr int kDkvProducerRegs = 40, kDkvConsumerRegs = 232;
// dQ at head dim 256: Q and dO take 128 KB, so the ring holds single
// 32 KB tiles -- kDqSlots256 slots, K in all but the last, V in the last
// (SlotRing) -- and the warpgroups' order and turns are their own.
constexpr int kDqSlots256 = 3;
constexpr Order kDqOrder256 = kSeries;
constexpr bool kDqTurns256 = false;
constexpr int kDqProducerRegs256 = 40, kDqConsumerRegs256 = 232;
__host__ __device__ constexpr bool persistent(int D) { return D <= 96; }
// whether the dQ kernel at head dim D is persistent (pb::Plan<D, true>)
__host__ __device__ constexpr bool persistent_dq(int D) {
  return persistent(D) || D == 256;
}

// The shared-memory plan of the dQ (DQ) or dK/dV kernel at head dim D:
// kBufs resident buffers of two BM-row tiles, kStages stages of two BN-row
// tiles (kSplit, dQ at 256: kStages slots of one), the dK/dV kernel's LSE
// and delta rows of each stage, then the barriers r_full[kBufs],
// r_empty[kBufs], full[kStages], empty[kStages].  A tile is whole
// 64-column boxes (one at D = 64, two at 80 and 96, four at 256).
template <int D, bool DQ>
struct Plan {
  static constexpr bool kSplit = DQ && D == 256;
  static constexpr int kResTile = BM * hopper::box_cols<D>() * 2;
  static constexpr int kTile = BN * hopper::box_cols<D>() * 2;
  static constexpr int kResBox = BM * hopper::kBoxCols * 2;
  static constexpr int kBox = BN * hopper::kBoxCols * 2;
  static constexpr int kBufs = DQ ? (D == 64 ? kDqBufs64 : kDqBufs8096)
                                  : (D == 64 ? kDkvBufs64 : kDkvBufs8096);
  static constexpr int kStages = kSplit ? kDqSlots256
                                 : DQ   ? (D == 64 ? kDqStages64
                                                   : kDqStages8096)
                                        : (D == 64 ? kDkvStages64
                                                   : kDkvStages8096);
  static constexpr Order kOrder =
      kSplit ? kDqOrder256 : DQ ? kDqOrder : kDkvOrder;
  static constexpr bool kTurns =
      kSplit ? kDqTurns256 : DQ ? kDqTurns : kDkvTurns;
  static constexpr int kProducerRegs =
      kSplit ? kDqProducerRegs256 : DQ ? kDqProducerRegs : kDkvProducerRegs;
  static constexpr int kConsumerRegs =
      kSplit ? kDqConsumerRegs256 : DQ ? kDqConsumerRegs : kDkvConsumerRegs;
  static constexpr int kStageOffset = kBufs * 2 * kResTile;
  static constexpr int kRowsOffset =
      kStageOffset + kStages * (kSplit ? 1 : 2) * kTile;
  static constexpr int kBarOffset =
      kRowsOffset + (DQ ? 0 : kStages * 2 * BN * 4);
  static constexpr int kFullOffset = kBarOffset + 16 * kBufs;   // full[]
  static constexpr size_t kBytes =
      1024 + kBarOffset + 8 * (2 * kBufs + 2 * kStages);
  static_assert(kBytes <= 232448, "a block has 227 KB of shared memory");
};

// The items a block walks, as the persistent forward walks its q tiles:
// unit u is tiles n_t - 1 - k and k (k = u % per_head; one tile where they
// meet) of (batch, head) u / per_head.  Under the causal mask a dQ q tile
// i has 2 (i + 1) key tiles and a dK/dV key tile i 2 (n_t - i) q tiles,
// so every unit but a middle one has 2 n_t + 2: equal shares of units are
// equal shares of work.  A block takes units blockIdx.x, then round by
// round one per gridDim.x, forward in even rounds and backward in odd
// ones; the units running at once belong to ~gridDim.x / per_head heads,
// whose streamed tiles stay in L2 while their items read them.
struct Pairs {
  int n_t, per_head, n_units;
  __device__ __forceinline__ int unit(int r) const {   // round r's unit
    const int G = gridDim.x, b = blockIdx.x;
    return r * G + (r & 1 ? G - 1 - b : b);
  }
  // tile i (0 or 1) of unit u, or -1
  __device__ __forceinline__ int tile(int u, int i) const {
    const int k = u % per_head;
    const int x = i ? k : n_t - 1 - k;
    return i && x == n_t - 1 - k ? -1 : x;
  }
};

// x, as a value the compiler cannot see through: what is computed from it
// is computed again where it is used, not held in a register.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// A work item: one BM-row tile (x0: its first q row, or key) of (b, h),
// and the BN-row tiles it streams from lo (n of them).
struct Item {
  int b, h, hk, x0, lo, n;
};

// The ring a producer streams tiles through, as the consumers see it:
// ready(g) waits for streamed tile g, release_a(g) frees what only its
// score products read, release(g) the rest (full[] / empty[] as the
// producers use them, empty[] counting both consumer warpgroups).
// StageRing: a stage holds a tile pair (K and V, or Q and dO), stage g %
// kStages, freed at once.
template <int kStages>
struct StageRing {
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ void ready(int g) const {
    hopper::mbar_wait(&full[g % kStages], (g / kStages) & 1);
  }
  __device__ __forceinline__ void release_a(int) const {}
  __device__ __forceinline__ void release(int g) const {
    hopper::mbar_arrive(&empty[g % kStages]);
  }
};
// SlotRing: slots of one tile, tile g's K in slot g % kK (kK = kSlots -
// 1) and every V in the last slot.  V, which only dP = dO V^T reads, is
// freed after the score products, K after dQ += dS K: so the next tile's
// K streams in a tile ahead and its V while this tile's dS and dQ run, and
// ready() waits only for K -- the body waits for V (ready_v) between its
// S and dP products.  It holds full[]'s shared-memory address (empty[]
// follows it): one register.
template <int kSlots>
struct SlotRing {
  static constexpr int kK = kSlots - 1;
  uint32_t full;
  __device__ __forceinline__ void ready(int g) const {
    hopper::mbar_wait(full + 8 * (g % kK), (g / kK) & 1);
  }
  __device__ __forceinline__ void release_a(int g) const {
    // V has landed (a tile the warpgroup skips has not waited for it)
    hopper::mbar_wait(full + 8 * kK, g & 1);
    hopper::mbar_arrive(full + 8 * (kSlots + kK));
  }
  __device__ __forceinline__ void release(int g) const {
    hopper::mbar_arrive(full + 8 * (kSlots + g % kK));
  }
};

// The consumers' walk over one item's tiles, ring slots g0 .. g0 + n_tiles
// - 1 of ``ring``.  This warpgroup sees tiles [first, last); the others it
// waits for, takes its turns for (kTurns) and releases.  Body supplies the
// products and the elementwise work:
//   issue_a(g): the score products of slot g (S and dP, or their
//               transposes), one commit group;
//   score(i, g): P and dS of tile i from them, in fp32 registers;
//   pack():     the next products' A operands from those registers;
//   issue_b(g): the accumulating products of slot g, one commit group;
//   fence_a(), fence_b(): the registers of each group.
// With kTurns every item gives each warpgroup the same number of turns --
// 2 n_tiles in kSeries, n_tiles + 1 otherwise, tiles it does not see
// included -- so the turns stay paired whatever the masks skip.  Returns
// with every product retired.
template <Order kOrder, bool kTurns, class Ring, class Body>
__device__ __forceinline__ void walk_tiles(Body& body, const Ring& ring,
                                           int g0, int n_tiles, int first,
                                           int last) {
  using namespace hopper;
  const int wg = threadIdx.x / 128;
  const auto ready = [&](int g) { ring.ready(g); };
  const auto release_a = [&](int g) { ring.release_a(g); };
  const auto release = [&](int g) { ring.release(g); };
  const auto turn = [&] {
    if constexpr (kTurns) dswg::turn_wait(wg);
  };
  const auto pass = [&] {
    if constexpr (kTurns) dswg::turn_pass(wg);
  };
  const auto skip = [&](int g) {
    ready(g);
#pragma unroll
    for (int i = 0; i < (kOrder == kSeries ? 2 : 1); ++i) {
      turn();
      pass();
    }
    release_a(g);
    release(g);
  };
  last = max(first, last);
  for (int it = 0; it < first; ++it) skip(g0 + it);
  if constexpr (kOrder == kFa3) {
    if (first < last) {
      int g = g0 + first;
      ready(g);
      turn();
      body.issue_a(g);
      pass();
      wgmma_wait<0>();
      body.fence_a();
      release_a(g);
      body.score(first, g);
      body.pack();
      for (int it = first; it + 1 < last; ++it, ++g) {
        ready(g + 1);
        turn();
        body.issue_a(g + 1);
        body.issue_b(g);
        pass();
        wgmma_wait<1>();              // the next tile's scores complete
        body.fence_a();
        release_a(g + 1);
        body.score(it + 1, g + 1);
        wgmma_wait<0>();              // this tile's accumulating products
        body.fence_b();
        release(g);
        body.pack();
      }
      turn();
      body.issue_b(g);
      pass();
      wgmma_wait<0>();
      body.fence_b();
      release(g);
    } else {                          // the turn of the last products
      turn();
      pass();
    }
  } else {
    for (int it = first; it < last; ++it) {
      const int g = g0 + it;
      ready(g);
      turn();
      body.issue_a(g);
      pass();
      wgmma_wait<0>();
      body.fence_a();
      release_a(g);
      body.score(it, g);
      body.pack();
      turn();
      body.issue_b(g);
      pass();
      wgmma_wait<0>();
      body.fence_b();
      release(g);
    }
  }
  for (int it = last; it < n_tiles; ++it) skip(g0 + it);
}

// The first and last + 1 of an item's tiles a warpgroup sees: the seen
// tiles are contiguous (the causal rule cuts one end, the window the
// other).
template <class Unseen>
__device__ __forceinline__ void seen_range(int n, Unseen unseen, int& first,
                                           int& last) {
  first = 0;
  while (first < n && unseen(first)) ++first;
  last = first;
  while (last < n && !unseen(last)) ++last;
}
}  // namespace pb

// dQ: a consumer warpgroup's registers and work over one item.  Rows row0
// and row0 + 8 of the warpgroup's 64 see keys lo[r] < key <= hi[r]; a key
// tile at k0 needs the mask if k0 > e_hi (it crosses the diagonal or S) or
// k0 <= e_lo (the window's edge).  P = 2^(S c - LSE log2 e) with c = scale
// log2 e, ALiBi's slope * key log2 e folded into the same FFMA chain; dS =
// P (dP scale - delta scale), delta scale formed once a row.
template <typename E, bool SLOPE, bool WINDOW, int D>
struct DqBody {
  using P = pb::Plan<D, true>;
  const DqParams& p;
  float s[32], dp[32], dq[D / 2];
  uint32_t da[16];
  uint32_t q_addr, ring;   // the warpgroup's rows of Q (dO follows); K / V
  float slope2, lse2[2], dls[2];
  int hi[2], lo[2], e_hi, e_lo, k_lo;

  // tile g's K and V: stage g's pair, or (kSplit: pb::SlotRing) K in slot
  // g % (kStages - 1), V in the last
  __device__ __forceinline__ uint32_t k_addr(int g) const {
    if constexpr (P::kSplit)
      return ring + (uint32_t)((g % (P::kStages - 1)) * P::kTile);
    else
      return ring + (uint32_t)((g % P::kStages) * 2 * P::kTile);
  }
  __device__ __forceinline__ uint32_t v_addr(int g) const {
    if constexpr (P::kSplit)
      return ring + (uint32_t)((P::kStages - 1) * P::kTile);
    else
      return k_addr(g) + P::kTile;
  }
  __device__ __forceinline__ void issue_a(int g) {
    using namespace hopper;
    const uint32_t k = k_addr(g), v = v_addr(g);
    // (kSplit) Q's and dO's descriptors formed anew for every tile: held
    // across the walk, the 2 D / 16 of them took registers dQ needs at 256
    const uint32_t q_at = P::kSplit ? pb::opaque(q_addr) : q_addr;
    const uint32_t do_addr = q_at + P::kResTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<E>(s, desc_kmajor(q_at + kslice(kk, P::kResBox)),
                      desc_kmajor(k + kslice(kk, P::kBox)), kk > 0);
    // (kSplit) V's slot, full[kStages - 1], lies at a fixed offset from
    // the ring: S's products run while V lands
    if constexpr (P::kSplit)
      mbar_wait(ring + (uint32_t)(P::kFullOffset + 8 * (P::kStages - 1) -
                                  P::kStageOffset),
                g & 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<E>(dp, desc_kmajor(do_addr + kslice(kk, P::kResBox)),
                      desc_kmajor(v + kslice(kk, P::kBox)), kk > 0);
    wgmma_commit();
  }
  // dQ += dS K: K read transposed (its keys are the depth)
  __device__ __forceinline__ void issue_b(int g) {
    using namespace hopper;
    const uint32_t k = k_addr(g);
    fence_regs(dq);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < pb::BN / 16; ++kk) {
      const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                             da[4 * kk + 3]};
      wgmma_rs<E, D>(dq, a, desc_mnmajor(k + kk * 2048, P::kBox));
    }
    wgmma_commit();
  }
  __device__ __forceinline__ void fence_a() {
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
  }
  __device__ __forceinline__ void fence_b() {
    hopper::fence_regs(dq);
    hopper::fence_regs(da);
  }
  __device__ __forceinline__ void score(int i, int) {
    using hopper::ex2;
    const float c = p.scale_log2e, scale = p.scale;
    const int kt = 2 * (threadIdx.x % 4);
    const int k0 = k_lo + i * pb::BN;
    const bool edge = k0 > e_hi || (WINDOW && k0 <= e_lo);
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      base[r] = SLOPE ? fmaf(slope2, (float)(k0 + kt), -lse2[r]) : -lse2[r];
#pragma unroll
    for (int i2 = 0; i2 < 32; ++i2) {
      const int r = (i2 / 2) % 2, col = 8 * (i2 / 4) + i2 % 2;
      const float b = SLOPE ? fmaf(slope2, (float)col, base[r]) : base[r];
      float pr = ex2(fmaf(s[i2], c, b));
      if (edge) {
        const int key = k0 + kt + col;
        if (!(key <= hi[r] && (!WINDOW || key > lo[r]))) pr = 0.f;
      }
      dp[i2] = pr * fmaf(dp[i2], scale, -dls[r]);
    }
  }
  __device__ __forceinline__ void pack() { hopper::acc_to_a<E>(dp, da); }
};

// dK/dV: a consumer warpgroup's registers and work over one item, keys as
// the rows of the products.  Keys key0 and key0 + 8 are seen by q rows
// lo[r] <= q <= hi[r]; a q tile at q0 needs the mask if q0 < e_lo or q0 >
// e_hi.  S^T's logits are scaled as dQ's, with slope * key log2 e a
// constant of the thread's two keys; the rows' LSE (times log2 e) and
// delta scale come from the stage's rows, which the producer wrote.  The
// scales are read from the kernel's parameters where they are used.
template <typename E, bool SLOPE, bool WINDOW, int D>
struct DkvBody {
  using P = pb::Plan<D, false>;
  const DkvParams& p;
  float s[32], dp[32], dk[D / 2], dv[D / 2];
  uint32_t pa[16], da[16];
  uint32_t k_addr, ring;
  const float* rows;
  float sk[2];
  int hi[2], lo[2], e_lo, e_hi, q_lo;

  __device__ __forceinline__ uint32_t q_addr(int g) const {
    return ring + (uint32_t)((g % P::kStages) * 2 * P::kTile);
  }
  __device__ __forceinline__ void issue_a(int g) {
    using namespace hopper;
    const uint32_t q = q_addr(g), o = q + P::kTile;
    const uint32_t v_addr = k_addr + P::kResTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<E>(s, desc_kmajor(k_addr + kslice(kk, P::kResBox)),
                      desc_kmajor(q + kslice(kk, P::kBox)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<E>(dp, desc_kmajor(v_addr + kslice(kk, P::kResBox)),
                      desc_kmajor(o + kslice(kk, P::kBox)), kk > 0);
    wgmma_commit();
  }
  // dV += P^T dO and dK += dS^T Q: dO and Q read transposed
  __device__ __forceinline__ void issue_b(int g) {
    using namespace hopper;
    const uint32_t q = q_addr(g), o = q + P::kTile;
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < pb::BN / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
      wgmma_rs<E, D>(dv, a, desc_mnmajor(o + kk * 2048, P::kBox));
    }
#pragma unroll
    for (int kk = 0; kk < pb::BN / 16; ++kk) {
      const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                             da[4 * kk + 3]};
      wgmma_rs<E, D>(dk, a, desc_mnmajor(q + kk * 2048, P::kBox));
    }
    wgmma_commit();
  }
  __device__ __forceinline__ void fence_a() {
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
  }
  __device__ __forceinline__ void fence_b() {
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    hopper::fence_regs(pa);
    hopper::fence_regs(da);
  }
  __device__ __forceinline__ void score(int i, int g) {
    using hopper::acc_col;
    using hopper::ex2;
    const int q0 = q_lo + i * pb::BN, t = threadIdx.x % 128;
    const float* lse_s = rows + (g % P::kStages) * 2 * pb::BN;
    const float* dl_s = lse_s + pb::BN;
    const float c = p.scale_log2e, scale = p.scale;
    const bool edge = q0 < e_lo || q0 > e_hi;
#pragma unroll
    for (int i2 = 0; i2 < 32; ++i2) {
      const int r = (i2 / 2) % 2, col = acc_col(i2, t);
      float pr = ex2(fmaf(s[i2], c, SLOPE ? sk[r] - lse_s[col] : -lse_s[col]));
      if (edge) {
        const int q = q0 + col;
        if (!(q >= lo[r] && q <= hi[r])) pr = 0.f;
      }
      s[i2] = pr;
      dp[i2] = pr * fmaf(dp[i2], scale, -dl_s[col]);
    }
  }
  __device__ __forceinline__ void pack() {
    hopper::acc_to_a<E>(s, pa);
    hopper::acc_to_a<E>(dp, da);
  }
};

// The Pairs of a launch, from its parameters, formed where they are used.
template <class Params>
__device__ __forceinline__ pb::Pairs pairs_of(const Params& p) {
  const int n_t = (pb::opaque(p.S) + pb::BM - 1) / pb::BM;
  return {n_t, (n_t + 1) / 2, p.B * pb::opaque(p.H) * ((n_t + 1) / 2)};
}

// The Pairs of a dQ launch, as the compiler may hold them.
__device__ __forceinline__ pb::Pairs dq_pairs(const DqParams& p) {
  const int n_t = (p.S + pb::BM - 1) / pb::BM;
  return {n_t, (n_t + 1) / 2, p.B * p.H * ((n_t + 1) / 2)};
}

__device__ __forceinline__ pb::Item dq_item(const DqParams& p, int bh, int qi,
                                            int window) {
  pb::Item it;
  it.b = bh / p.H;
  it.h = bh % p.H;
  it.hk = it.h / (p.H / p.Hkv);
  it.x0 = qi * pb::BM;
  it.lo = 0;                              // _k_range: the window's first tile
  if (window > 0 && it.x0 - (window - 1) > 0)
    it.lo = (it.x0 - (window - 1)) / pb::BN * pb::BN;
  const int hi = p.causal ? min(p.S, it.x0 + pb::BM) : p.S;
  it.n = (hi - it.lo + pb::BN - 1) / pb::BN;
  return it;
}

// dQ at head dims 64, 80, 96 and 256, bf16 / fp16: one block an SM walks
// its share of the q tiles (pb::Pairs).  A producer thread loads each
// item's Q and dO into a resident buffer and streams its 64-key K and V
// tiles through one ring (at 256 a SlotRing: K and V a 32 KB slot each);
// two consumer warpgroups own 64 of the item's rows each and run
// pb::walk_tiles over DqBody, then store dQ.
template <typename E, bool SLOPE, bool WINDOW, int D>
__device__ __forceinline__ void dq_persistent(const DqParams& p,
                                              unsigned char* raw) {
  using namespace hopper;
  using P = pb::Plan<D, true>;
  constexpr int kBufs = P::kBufs, kStages = P::kStages;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  unsigned char* res_s = base;                   // [buf][Q, dO]
  unsigned char* ring_s = base + P::kStageOffset;   // [stage][K, V]
  uint64_t* r_full = reinterpret_cast<uint64_t*>(base + P::kBarOffset);
  uint64_t* r_empty = r_full + kBufs;
  uint64_t* full = r_empty + kBufs;
  uint64_t* empty = full + kStages;

  const int S = p.S, H = p.H;
  const int window = WINDOW ? p.window : 0;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBufs; ++i) {
      mbar_init(&r_full[i], 1);
      mbar_init(&r_empty[i], 256);   // every consumer thread
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    regs_dealloc<P::kProducerRegs>();
    if (t == 0) {
      const int n_t = (S + pb::BM - 1) / pb::BM;
      const pb::Pairs walk{n_t, (n_t + 1) / 2, p.B * H * ((n_t + 1) / 2)};
      int g = 0, j = 0;   // streamed tiles and items so far
      for (int r = 0, u = walk.unit(0); u < walk.n_units;
           u = walk.unit(++r)) {
        for (int i = 0; i < 2; ++i, ++j) {
          const int qi = walk.tile(u, i);
          if (qi < 0) break;
          const pb::Item it = dq_item(p, u / walk.per_head, qi, window);
          const int rb = j % kBufs;
          const auto load_res = [&] {
            mbar_wait(&r_empty[rb], ((j / kBufs) & 1) ^ 1);
            unsigned char* q_t = res_s + rb * 2 * P::kResTile;
            mbar_arrive_expect_tx(&r_full[rb], 2 * P::kResTile);
            tma_load_rows<D>(q_t, &p.q_map, &r_full[rb], pb::BM, it.h, it.x0,
                             it.b);
            tma_load_rows<D>(q_t + P::kResTile, &p.do_map, &r_full[rb],
                             pb::BM, it.h, it.x0, it.b);
          };
          if (kBufs > 1) load_res();
          for (int c = 0; c < it.n; ++c, ++g) {
            const int k0 = it.lo + c * pb::BN;
            if constexpr (P::kSplit) {
              // K into slot g % kK once it is empty, then V into the last
              constexpr int kK = kStages - 1;
#pragma unroll
              for (int x = 0; x < 2; ++x) {
                const int st = x ? kK : g % kK;
                const int use = x ? g : g / kK;   // the slot's use count
                mbar_wait(&empty[st], (use & 1) ^ 1);
                mbar_arrive_expect_tx(&full[st], P::kTile);
                tma_load_rows<D>(ring_s + st * P::kTile,
                                 x ? &p.v_map : &p.k_map, &full[st], pb::BN,
                                 it.hk, k0, it.b);
              }
            } else {
              const int st = g % kStages;
              mbar_wait(&empty[st], ((g / kStages) & 1) ^ 1);
              unsigned char* k_t = ring_s + st * 2 * P::kTile;
              mbar_arrive_expect_tx(&full[st], 2 * P::kTile);
              tma_load_rows<D>(k_t, &p.k_map, &full[st], pb::BN, it.hk, k0,
                               it.b);
              tma_load_rows<D>(k_t + P::kTile, &p.v_map, &full[st], pb::BN,
                               it.hk, k0, it.b);
            }
            if (kBufs == 1 && c == 0) load_res();
          }
        }
      }
    }
  } else {  // consumers: warpgroup wg owns rows x0 + 64 wg .. + 63 of each
    regs_alloc<P::kConsumerRegs>();
    if constexpr (P::kTurns) dswg::first_turn(wg);
    DqBody<E, SLOPE, WINDOW, D> body{p};
    body.slope2 = 0.f;
    body.ring = smem_u32(ring_s);
    int g = 0, j = 0;
    for (int r = 0;; ++r) {
      // the walk and the item are formed anew where they are used, not
      // held across an item's tiles: at D = 256 dQ takes 128 of the
      // consumers' registers
      const pb::Pairs walk = P::kSplit ? pairs_of(p) : dq_pairs(p);
      const int u = walk.unit(r);
      if (u >= walk.n_units) break;
      for (int i = 0; i < 2; ++i, ++j) {
        const int qi = walk.tile(u, i);
        if (qi < 0) break;
        const pb::Item it = dq_item(p, u / walk.per_head, qi, window);
        const int r_first = it.x0 + 64 * wg, r_last = r_first + 63;
        const int row0 = r_first + acc_row(0, t);   // and row0 + 8
        const int bh = it.b * H + it.h;
        if (SLOPE) body.slope2 = __ldg(p.slopes + it.h) * kLog2e;
        body.k_lo = it.lo;
        body.e_hi = min(p.causal ? r_first - pb::BN + 1 : pb::kFar,
                        S - pb::BN);
        body.e_lo = WINDOW && window > 0 ? r_last - window : -pb::kFar;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = row0 + 8 * rr;
          const long long at = (long long)bh * S + row;
          body.lse2[rr] = row < S ? __ldg(p.lse + at) * kLog2e : 0.f;
          body.dls[rr] = row < S ? __ldg(p.delta + at) * p.scale : 0.f;
          body.hi[rr] = p.causal ? min(S - 1, row) : S - 1;
          body.lo[rr] = WINDOW && window > 0 ? row - window : -pb::kFar;
        }
#pragma unroll
        for (int d = 0; d < D / 2; ++d) body.dq[d] = 0.f;
        int first, last;
        pb::seen_range(it.n, [&](int x) {
          const int k0 = it.lo + x * pb::BN;
          return (p.causal && k0 > r_last) || r_first >= S ||
                 (WINDOW && window > 0 &&
                  r_first - (k0 + pb::BN - 1) >= window);
        }, first, last);
        const int rb = j % kBufs;
        body.q_addr = smem_u32(res_s + rb * 2 * P::kResTile) + 64 * wg * 128;
        mbar_wait(&r_full[rb], (j / kBufs) & 1);
        if constexpr (P::kSplit)
          pb::walk_tiles<P::kOrder, P::kTurns>(
              body, pb::SlotRing<kStages>{smem_u32(full)}, g, it.n, first,
              last);
        else
          pb::walk_tiles<P::kOrder, P::kTurns>(
              body, pb::StageRing<kStages>{full, empty}, g, it.n, first,
              last);
        mbar_arrive(&r_empty[rb]);   // every product that read Q, dO retired
        const pb::Pairs w = P::kSplit ? pairs_of(p) : walk;
        const int un = P::kSplit ? pb::opaque(u) : u;
        const pb::Item done = dq_item(p, un / w.per_head, w.tile(un, i),
                                      window);
        g += done.n;
        E* out = static_cast<E*>(p.dq);
        E* rows[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = done.x0 + 64 * wg + acc_row(0, t) + 8 * rr;
          rows[rr] = row < S ? out + (((long long)done.b * S + row) * H +
                                      done.h) * D
                             : nullptr;
        }
        store_rows<E, D>(rows, body.dq, t);
      }
    }
  }
}

__device__ __forceinline__ pb::Item dkv_item(const DkvParams& p, int bh,
                                             int ki, int window) {
  pb::Item it;
  it.b = bh / p.H;
  it.h = bh % p.H;
  it.hk = it.h / (p.H / p.Hkv);
  it.x0 = ki * pb::BM;
  // the q loop: from the diagonal to the last row that sees key x0 + BM - 1
  it.lo = p.causal ? it.x0 : 0;
  const int hi =
      window > 0
          ? (int)min((long long)p.S, (long long)it.x0 + pb::BM - 1 + window)
          : p.S;
  it.n = (hi - it.lo + pb::BN - 1) / pb::BN;
  return it;
}

// dK/dV at head dims 64, 80 and 96, bf16 / fp16: one block an SM walks its
// share of the key tiles (pb::Pairs).  A producer thread loads each item's
// K and V into a resident buffer and streams its 64-row Q and dO tiles
// through one ring; a second producer warp writes each tile's rows' LSE
// (times log2 e) and delta (times the scale) beside it, its 32 lanes and
// the TMA thread completing the stage's barrier together (one warp doing
// both waited out the rows' loads before each tile's TMA: 12-15% slower).
// Two consumer warpgroups own 64 of the item's keys each and run
// pb::walk_tiles over DkvBody, then store dK and dV (store_dkv).
template <typename E, bool SLOPE, bool WINDOW, int D>
__device__ __forceinline__ void dkv_persistent(const DkvParams& p,
                                               unsigned char* raw) {
  using namespace hopper;
  using P = pb::Plan<D, false>;
  constexpr int kBufs = P::kBufs, kStages = P::kStages;
  constexpr int BN = pb::BN;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  unsigned char* res_s = base;                   // [buf][K, V]
  unsigned char* ring_s = base + P::kStageOffset;   // [stage][Q, dO]
  float* rows_s = reinterpret_cast<float*>(base + P::kRowsOffset);
  uint64_t* r_full = reinterpret_cast<uint64_t*>(base + P::kBarOffset);
  uint64_t* r_empty = r_full + kBufs;
  uint64_t* full = r_empty + kBufs;
  uint64_t* empty = full + kStages;

  const int S = p.S, H = p.H;
  const int n_t = (S + pb::BM - 1) / pb::BM;
  const pb::Pairs walk{n_t, (n_t + 1) / 2, p.B * H * ((n_t + 1) / 2)};
  const int window = WINDOW ? p.window : 0;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBufs; ++i) {
      mbar_init(&r_full[i], 1);
      mbar_init(&r_empty[i], 256);   // every consumer thread
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 33);      // the TMA thread, the rows warp's lanes
      mbar_init(&empty[st], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: warps 0 (TMA) and 1 (rows) of the last WG
    regs_dealloc<pb::kDkvProducerRegs>();
    const int warp = t / 32, lane = t % 32;
    if (warp > 1 || (warp == 0 && lane > 0)) return;
    int g = 0, j = 0;   // streamed tiles and items so far
    for (int r = 0, u = walk.unit(0); u < walk.n_units; u = walk.unit(++r)) {
      for (int i = 0; i < 2; ++i, ++j) {
        const int ki = walk.tile(u, i);
        if (ki < 0) break;
        const pb::Item it = dkv_item(p, u / walk.per_head, ki, window);
        const int rb = j % kBufs;
        const auto load_res = [&] {
          mbar_wait(&r_empty[rb], ((j / kBufs) & 1) ^ 1);
          unsigned char* k_t = res_s + rb * 2 * P::kResTile;
          mbar_arrive_expect_tx(&r_full[rb], 2 * P::kResTile);
          tma_load_rows<D>(k_t, &p.k_map, &r_full[rb], pb::BM, it.hk, it.x0,
                           it.b);
          tma_load_rows<D>(k_t + P::kResTile, &p.v_map, &r_full[rb],
                           pb::BM, it.hk, it.x0, it.b);
        };
        if (warp == 0 && kBufs > 1) load_res();
        // the rows' LSE and delta: this (batch, head)'s
        const float* lse = p.lse + (long long)(it.b * H + it.h) * S;
        const float* delta = p.delta + (long long)(it.b * H + it.h) * S;
        for (int c = 0; c < it.n; ++c, ++g) {
          const int st = g % kStages, q0 = it.lo + c * BN;
          mbar_wait(&empty[st], ((g / kStages) & 1) ^ 1);
          if (warp == 0) {
            unsigned char* q_t = ring_s + st * 2 * P::kTile;
            mbar_arrive_expect_tx(&full[st], 2 * P::kTile);
            tma_load_rows<D>(q_t, &p.q_map, &full[st], BN, it.h, q0, it.b);
            tma_load_rows<D>(q_t + P::kTile, &p.do_map, &full[st], BN, it.h,
                             q0, it.b);
            if (kBufs == 1 && c == 0) load_res();
          } else {
            // LSE (times log2 e) and delta (times the scale), 0 past S
            float* lse_s = rows_s + st * 2 * BN;
#pragma unroll
            for (int x = lane; x < BN; x += 32) {
              const int q = q0 + x;
              lse_s[x] = q < S ? lse[q] * kLog2e : 0.f;
              lse_s[BN + x] = q < S ? delta[q] * p.scale : 0.f;
            }
            mbar_arrive(&full[st]);
          }
        }
      }
    }
  } else {  // consumers: warpgroup wg owns keys x0 + 64 wg .. + 63 of each
    regs_alloc<pb::kDkvConsumerRegs>();
    if constexpr (P::kTurns) dswg::first_turn(wg);
    DkvBody<E, SLOPE, WINDOW, D> body{p};
    body.ring = smem_u32(ring_s);
    body.rows = rows_s;
    int g = 0, j = 0;
    for (int r = 0;; ++r) {
      // the walk and the item are formed anew where they are used, not
      // held across an item's tiles: at D = 96 dK and dV take 96 of the
      // consumers' 232 registers
      const pb::Pairs walk = pairs_of(p);
      const int u = walk.unit(r);
      if (u >= walk.n_units) break;
      for (int i = 0; i < 2; ++i, ++j) {
        const int ki = walk.tile(u, i);
        if (ki < 0) break;
        const pb::Item it = dkv_item(p, u / walk.per_head, ki, window);
        const int kw = it.x0 + 64 * wg;
        const int key0 = kw + acc_row(0, t);   // and key0 + 8
        const float slope2 = SLOPE ? __ldg(p.slopes + it.h) * kLog2e : 0.f;
        body.q_lo = it.lo;
        // a q tile needs the mask where it reaches past S, crosses the
        // diagonal or the window's edge, or the keys reach past S
        body.e_lo = kw + 64 > S ? pb::kFar : p.causal ? kw + 63 : -pb::kFar;
        body.e_hi = S - BN;
        if (WINDOW && window > 0)
          body.e_hi = (int)min((long long)body.e_hi,
                               (long long)kw + window - BN);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int key = key0 + 8 * rr;
          body.sk[rr] = slope2 * (float)key;
          body.lo[rr] = p.causal ? key : 0;
          body.hi[rr] =
              key >= S ? -1
                       : (int)min((long long)S - 1,
                                  WINDOW && window > 0
                                      ? (long long)key + window - 1
                                      : (long long)S - 1);
        }
#pragma unroll
        for (int d = 0; d < D / 2; ++d) body.dk[d] = body.dv[d] = 0.f;
        int first, last;
        pb::seen_range(it.n, [&](int x) {
          const int q0 = it.lo + x * BN;
          return (p.causal && q0 + BN - 1 < kw) || kw >= S ||
                 (WINDOW && window > 0 && q0 - (kw + 63) >= window);
        }, first, last);
        const int rb = j % kBufs;
        body.k_addr = smem_u32(res_s + rb * 2 * P::kResTile) + 64 * wg * 128;
        mbar_wait(&r_full[rb], (j / kBufs) & 1);
        pb::walk_tiles<P::kOrder, P::kTurns>(
            body, pb::StageRing<kStages>{full, empty}, g, it.n, first, last);
        mbar_arrive(&r_empty[rb]);   // every product that read K, V retired
        g += it.n;
        const pb::Pairs w = pairs_of(p);
        const int un = pb::opaque(u);
        const pb::Item done = dkv_item(p, un / w.per_head, w.tile(un, i),
                                       window);
        store_dkv<E, D>(p, body.dk, body.dv, done.b, done.h,
                        done.x0 + 64 * wg + acc_row(0, t), t);
      }
    }
  }
}

// ---- dK/dV, bf16 / fp16, head dim 256: the GQA group summed in a cluster --

namespace cl {
constexpr int kKeys = 64;                    // keys of a block
constexpr int D = 256;
constexpr int kKvBox = kKeys * hopper::kBoxCols * 2;   // a K or V box: 8 KB
constexpr int kKvTile = kKeys * D * 2;       // K or V: 32 KB
// q rows of a Q/dO tile, and the ring's stages of Q and dO tiles (128 KB;
// 32-row tiles in 4 stages ran 8% slower)
constexpr int BM = 64;
constexpr int kBox = BM * hopper::kBoxCols * 2;   // a Q or dO box
constexpr int kTile = BM * D * 2;            // a Q or dO tile
constexpr int kStages = 2;
constexpr int kS = BM / 2;                   // S^T / dP^T accumulators
constexpr int kPBufs = 2;                    // P^T exchange buffers
// the largest cluster: at 8 (one query head a block at a group of 8) the
// cluster's scheduling and sum cost more than they save (PERF.md)
constexpr int kMaxCluster = 4;
constexpr int kPitch = D + 8;                // staged rows, in floats
// setmaxnreg's split of the launch's 168 registers a thread; the producer
// warp walks the group's heads and writes each stage's LSE and delta rows
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// each warpgroup's order over its tiles (pb::walk_tiles): its score product,
// elementwise work and accumulating product in series, or FA3's order (the
// next tile's score product issued with this tile's accumulating one)
constexpr pb::Order kDkvOrder256 = pb::kSeries;
// named barriers: P^T buffer b full (1 + b) and empty (1 + kPBufs + b);
// both consumer warpgroups done with the ring (1 + 2 kPBufs)
constexpr int kBarFull = 1, kBarEmpty = 1 + kPBufs, kBarDone = 1 + 2 * kPBufs;
// K, V, kStages x (Q, dO), kPBufs P^T buffers (fp32, element i of thread
// t at i * 128 + t), kStages x (LSE, delta) rows, the barriers: K/V's,
// full[], empty[].  After the q loop dK and dV are staged in fp32 over K,
// V and the ring, kPitch floats a row (a float2 store of a quad's columns
// then touches each bank at most twice a warp).
constexpr int kStageOffset = 2 * kKvTile;
constexpr int kXOffset = kStageOffset + kStages * 2 * kTile;
constexpr int kXBytes = kS * 128 * 4;
constexpr int kRowsOffset = kXOffset + kPBufs * kXBytes;
constexpr int kBarOffset = kRowsOffset + kStages * 2 * BM * 4;
constexpr size_t kBytes = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
static_assert(kBytes <= 232448, "a block has 227 KB of shared memory");
static_assert(2 * kKeys * kPitch * 4 <= kXOffset,
              "dK and dV are staged over K, V and the ring");

// The blocks of a cluster at a GQA group: the largest divisor of the group
// that a portable cluster holds.
__host__ __device__ constexpr int cluster_of(int group) {
  int c = group < kMaxCluster ? group : kMaxCluster;
  while (group % c) --c;
  return c;
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
}  // namespace cl

// dK/dV at head dim 256: a consumer warpgroup's registers and work over
// one query head's q tiles (pb::walk_tiles), keys as the rows of the
// products.  Warpgroup 0 forms S^T = K Q^T and P^T and runs dV += P^T dO;
// warpgroup 1 forms dP^T = V dO^T, takes P^T from warpgroup 0 through
// shared memory (buffer m % kPBufs for the m-th tile both see), forms
// dS^T = P^T (dP^T - delta) scale and runs dK += dS^T Q.  acc is dV or
// dK.
template <typename E, bool SLOPE, bool WINDOW>
struct DkvClusterBody {
  float acc[cl::D / 2], sc[cl::kS];
  uint32_t a_op[cl::kS / 2];
  uint32_t kv_addr, ring;          // K or V; the Q/dO ring
  const float* rows;               // the stages' LSE and delta rows
  float* xs;                       // the P^T buffers
  float scale, slope;
  int wg, t, key0, k0, q_lo, S, causal, window, m;

  __device__ __forceinline__ uint32_t q_addr(int g) const {
    return ring + (uint32_t)((g % cl::kStages) * 2 * cl::kTile);
  }
  // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1)
  __device__ __forceinline__ void issue_a(int g) {
    using namespace hopper;
    const uint32_t x = q_addr(g) + (wg == 0 ? 0 : cl::kTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < cl::D / 16; ++kk) {
      const uint64_t kd = desc_kmajor(kv_addr + kslice(kk, cl::kKvBox));
      wgmma_ss_n64<E>(sc, kd, desc_kmajor(x + kslice(kk, cl::kBox)),
                      kk > 0);
    }
    wgmma_commit();
  }
  // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1): the A operand from
  // registers, dO or Q read transposed (its rows are the depth)
  __device__ __forceinline__ void issue_b(int g) {
    using namespace hopper;
    const uint32_t x = q_addr(g) + (wg == 0 ? cl::kTile : 0);
    fence_regs(acc);
    fence_regs(a_op);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < cl::BM / 16; ++kk) {
      const uint32_t a[4] = {a_op[4 * kk], a_op[4 * kk + 1],
                             a_op[4 * kk + 2], a_op[4 * kk + 3]};
      wgmma_rs<E, cl::D>(acc, a, desc_mnmajor(x + kk * 2048, cl::kBox));
    }
    wgmma_commit();
  }
  __device__ __forceinline__ void fence_a() { hopper::fence_regs(sc); }
  __device__ __forceinline__ void fence_b() {
    hopper::fence_regs(acc);
    hopper::fence_regs(a_op);
  }
  __device__ __forceinline__ void score(int i, int g) {
    using namespace hopper;
    using namespace cl;
    const int q0 = q_lo + i * BM;
    const float* lse_s = rows + (g % kStages) * 2 * BM;
    const float* dl_s = lse_s + BM;
    const int xi = m++ % kPBufs;
    float* xb = xs + xi * kS * 128;
    if (wg == 0) {
      const bool edge = q0 + BM > S || k0 + kKeys > S ||
                        (causal && q0 < k0 + 63) ||
                        (WINDOW && window > 0 && q0 + BM - 1 - k0 >= window);
#pragma unroll
      for (int x = 0; x < kS; ++x) {
        const int col = acc_col(x, t), qrow = q0 + col;
        const int key = key0 + 8 * ((x / 2) % 2);
        float y = __fmul_rn(sc[x], scale);
        if (SLOPE) y = __fadd_rn(y, __fmul_rn(slope, (float)key));
        if (edge) {
          bool ok = qrow < S && key < S && (!causal || key <= qrow);
          if (WINDOW) ok = ok && (window <= 0 || qrow - key < window);
          if (!ok) y = kNeg;
        }
        sc[x] = ex2(fmaf(y, kLog2e, -lse_s[col]));   // 0 where masked
      }
      bar_sync(kBarEmpty + xi);      // warpgroup 1 read the last P^T here
#pragma unroll
      for (int x = 0; x < kS; ++x) xb[x * 128 + t] = sc[x];
      bar_arrive(kBarFull + xi);
    } else {
      bar_sync(kBarFull + xi);
#pragma unroll
      for (int x = 0; x < kS; ++x) {
        const int col = acc_col(x, t);
        sc[x] = xb[x * 128 + t] * (sc[x] - dl_s[col]) * scale;
      }
      bar_arrive(kBarEmpty + xi);
    }
  }
  __device__ __forceinline__ void pack() { hopper::acc_to_a<E>(sc, a_op); }
};

// dK/dV at head dim 256, bf16 / fp16.  A block owns 64 keys of kv head hk
// and walks group / C of its query heads (C: the cluster's blocks,
// cl::cluster_of(group)): rank r takes heads hk * group + r + C j, j = 0,
// 1, ..., each over its q tiles from the diagonal to the window's end.  A
// producer warp loads K and V once and streams 64-row Q and dO tiles
// (with their rows' LSE and delta) through two stages.  The consumer
// warpgroups split the products, not the columns (DkvClusterBody), in
// kDkvOrder256.  At group 1 each stores its accumulator in k's dtype.  At
// a larger group the two stage dK and dV in shared memory; after a
// cluster barrier each block sums a fixed share of the rows (row r of the
// 64 in the block of rank r % C) over the cluster's ranks in rank order,
// through distributed shared memory, and stores k's dtype at [B, S, Hkv,
// D]; a second cluster barrier keeps every block's staging alive until
// the others have read it.  No atomics, no fp32 in HBM: runs repeat bit
// for bit.
template <typename E, bool SLOPE, bool WINDOW>
__device__ __forceinline__ void dkv_cluster(const DkvParams& p,
                                            unsigned char* raw) {
  using namespace hopper;
  using namespace cl;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  unsigned char* k_s = base;
  unsigned char* v_s = base + kKvTile;
  unsigned char* qdo_s = base + kStageOffset;   // [stage][Q, dO]
  float* rows_s = reinterpret_cast<float*>(base + kRowsOffset);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(base + kBarOffset);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + kStages;

  const int S = p.S, H = p.H, Hkv = p.Hkv, group = H / Hkv;
  const int C = (int)cluster_size(), rank = (int)cluster_rank();
  const int heads = group / C;
  const int b = blockIdx.x / C / Hkv, hk = blockIdx.x / C % Hkv;
  const int k0 = blockIdx.y * kKeys;       // causal: longest q loops first
  const int window = WINDOW ? p.window : 0;
  // the q loop: from the diagonal to the last row that sees key k0 + 63
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi =
      WINDOW && window > 0
          ? (int)min((long long)S, (long long)k0 + kKeys - 1 + window)
          : S;
  const int n_tiles = (q_hi - q_lo + BM - 1) / BM;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 32);     // the producer warp's lanes
      mbar_init(&empty[st], 256);   // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: warp 0 of the last warpgroup
    regs_dealloc<kProducerRegs>();
    if (t < 32) {
      if (t == 0) {
        mbar_arrive_expect_tx(kv_bar, 2 * kKvTile);
        tma_load_rows<D>(k_s, &p.k_map, kv_bar, kKeys, hk, k0, b);
        tma_load_rows<D>(v_s, &p.v_map, kv_bar, kKeys, hk, k0, b);
      }
      for (int j = 0, n = 0; j < heads; ++j) {
        const int h = hk * group + rank + C * j;
        const float* lse = p.lse + (long long)(b * H + h) * S;
        const float* delta = p.delta + (long long)(b * H + h) * S;
        for (int it = 0; it < n_tiles; ++it, ++n) {
          const int st = n % kStages, q0 = q_lo + it * BM;
          mbar_wait(&empty[st], ((n / kStages) & 1) ^ 1);
          if (t == 0) {   // the tiles first: the rows' loads do not delay them
            unsigned char* q_t = qdo_s + st * 2 * kTile;
            mbar_expect_tx(&full[st], 2 * kTile);
            tma_load_rows<D>(q_t, &p.q_map, &full[st], BM, h, q0, b);
            tma_load_rows<D>(q_t + kTile, &p.do_map, &full[st], BM, h, q0,
                             b);
          }
          // LSE (times log2 e) and delta of the tile's rows (0 past S)
          float* lse_s = rows_s + st * 2 * BM;
#pragma unroll
          for (int r = t; r < BM; r += 32) {
            lse_s[r] = q0 + r < S ? lse[q0 + r] * kLog2e : 0.f;
            lse_s[BM + r] = q0 + r < S ? delta[q0 + r] : 0.f;
          }
          mbar_arrive(&full[st]);
        }
      }
    }
    if (C > 1) {
      cluster_sync();                // every block's dK and dV staged
      cluster_sync();                // and summed
    }
    return;
  }
  // consumers: warpgroup 0 S^T, P^T and dV; warpgroup 1 dP^T, dS^T and dK
  // -- both over all 64 keys and D columns
  regs_alloc<kConsumerRegs>();
  DkvClusterBody<E, SLOPE, WINDOW> body;
  body.wg = wg;
  body.t = t;
  body.k0 = k0;
  body.key0 = k0 + acc_row(0, t);                  // and key0 + 8
  body.q_lo = q_lo;
  body.S = S;
  body.causal = p.causal;
  body.window = window;
  body.scale = p.scale;
  body.m = 0;
  body.kv_addr = smem_u32(wg == 0 ? k_s : v_s);    // K, or V
  body.ring = smem_u32(qdo_s);
  body.rows = rows_s;
  body.xs = reinterpret_cast<float*>(base + kXOffset);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) body.acc[i] = 0.f;
  if (wg == 1)                       // every P^T buffer starts empty
    for (int x = 0; x < kPBufs; ++x) bar_arrive(kBarEmpty + x);
  // both warpgroups see the same tiles (the P^T handoff pairs them)
  int first, last;
  pb::seen_range(n_tiles, [&](int x) {
    const int q0 = q_lo + x * BM;
    return (p.causal && q0 + BM - 1 < k0) ||
           (WINDOW && window > 0 && q0 - (k0 + 63) >= window);
  }, first, last);
  mbar_wait(kv_bar, 0);
  for (int j = 0; j < heads; ++j) {
    body.slope = SLOPE ? __ldg(p.slopes + hk * group + rank + C * j) : 0.f;
    pb::walk_tiles<kDkvOrder256, false>(body,
                                        pb::StageRing<kStages>{full, empty},
                                        j * n_tiles, n_tiles, first, last);
  }
  if (wg == 0)                       // warpgroup 1's last arrivals
    for (int x = 0; x < kPBufs; ++x) bar_sync(kBarEmpty + x);
  const int key0 = body.key0;
  if (C == 1) {   // no group to sum: k's dtype from the registers
    E* rows[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      rows[r] = key < S ? static_cast<E*>(wg == 0 ? p.dv : p.dk) +
                              (((long long)b * S + key) * Hkv + hk) * D
                        : nullptr;
    }
    store_rows<E, D>(rows, body.acc, t);
    return;
  }
  bar_sync(kBarDone);                // K, V and the ring read for the last time
  // stage this warpgroup's accumulator: rows of dK (matrix 0) or dV (1).
  // The sum runs here, in the consumers' registers: code after the
  // producer's and consumers' branches join is held to the producer's
  // register budget (there it spilled ~500 bytes)
  float* mat = reinterpret_cast<float*>(base) +
               (wg == 0 ? 1 : 0) * kKeys * kPitch;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = acc_row(i, t), col = acc_col(i, t);
    *reinterpret_cast<float2*>(mat + row * kPitch + col) =
        make_float2(body.acc[i], body.acc[i + 1]);
  }
  cluster_sync();                    // every block's dK and dV staged
  // rows rank, rank + C, ... of dK and dV: 8 columns a thread a step,
  // summed over the cluster's blocks in rank order
  const int n_rows = (kKeys - rank + C - 1) / C;
  const uint32_t stage0 = smem_u32(base);
  for (int x = threadIdx.x; x < n_rows * 64; x += 256) {
    const int row = rank + C * (x / 64), key = k0 + row;
    const int mi = x % 64 / 32, col = x % 32 * 8;
    if (key >= S) continue;
    const uint32_t at = stage0 + ((mi * kKeys + row) * kPitch + col) * 4;
    // every rank's 8 columns loaded before any is summed: the remote loads'
    // latencies overlap
    float4 lo[kMaxCluster], hi[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < C) {
        const uint32_t remote = cluster_addr(at, q);
        lo[q] = ld_cluster_f4(remote);
        hi[q] = ld_cluster_f4(remote + 16);
      }
    }
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < C) {
        v[0] += lo[q].x; v[1] += lo[q].y; v[2] += lo[q].z; v[3] += lo[q].w;
        v[4] += hi[q].x; v[5] += hi[q].y; v[6] += hi[q].z; v[7] += hi[q].w;
      }
    }
    E* out = static_cast<E*>(mi ? p.dv : p.dk) +
             (((long long)b * S + key) * Hkv + hk) * D + col;
    *reinterpret_cast<uint4*>(out) =
        make_uint4(pack2<E>(v[0], v[1]), pack2<E>(v[2], v[3]),
                   pack2<E>(v[4], v[5]), pack2<E>(v[6], v[7]));
  }
  cluster_sync();                    // the others are done reading ours
}

template <typename T>
constexpr int bwd_threads() {
  return std::is_same<T, float>::value ? kThreads : tc::kThreads;
}

template <typename T, bool SLOPE, bool WINDOW, int D>
__global__ void __launch_bounds__(bwd_threads<T>(), 1)
flash_bwd_dq_kernel(const __grid_constant__ DqParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (std::is_same<T, float>::value)
    dq_cuda_cores<SLOPE, WINDOW, D>(p, reinterpret_cast<float*>(smem_raw));
  else if constexpr (pb::persistent_dq(D))
    dq_persistent<T, SLOPE, WINDOW, D>(p, smem_raw);
  else
    dq_tensor_cores<T, SLOPE, WINDOW, D>(p, smem_raw);
}

template <typename T, bool SLOPE, bool WINDOW, int D>
__global__ void __launch_bounds__(bwd_threads<T>(), 1)
flash_bwd_dkv_kernel(const __grid_constant__ DkvParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (std::is_same<T, float>::value)
    dkv_cuda_cores<SLOPE, WINDOW, D>(p, reinterpret_cast<float*>(smem_raw));
  else if constexpr (pb::persistent(D))
    dkv_persistent<T, SLOPE, WINDOW, D>(p, smem_raw);
  else if constexpr (D == 256)
    dkv_cluster<T, SLOPE, WINDOW>(p, smem_raw);
  else
    dkv_tensor_cores<T, SLOPE, WINDOW, D>(p, smem_raw);
}

// The grid of a tensor-core launch: the persistent bodies (head dims 64,
// 80, 96; dQ at 256 too) take one block an SM at most, as many as
// pb::Pairs has units; the others one block per (b * h, BM-row tile).
inline int tensor_core_grid(bool persistent, int B, int H, int S, int rows,
                            dim3* grid) {
  const unsigned tiles = (S + rows - 1) / rows;
  *grid = dim3(B * H, tiles);
  if (!persistent) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned units = B * H * ((tiles + 1) / 2);
  *grid = dim3(units < (unsigned)sms ? units : (unsigned)sms);
  return 0;
}

// Dynamic shared memory of the dQ (DQ) or dK/dV kernel's body for T, D.
template <typename T, int D, bool DQ>
constexpr size_t bwd_smem() {
  if constexpr (std::is_same<T, float>::value)
    return (DQ ? dq_smem_floats<D>() : dkv_smem_floats<D>()) * sizeof(float);
  else if constexpr (DQ ? pb::persistent_dq(D) : pb::persistent(D))
    return pb::Plan<D, DQ>::kBytes;
  else if constexpr (DQ)
    return tcq::Smem<D>::kBytes;
  else if constexpr (D == 256)
    return cl::kBytes;
  else
    return tc::Smem<D>::kBytes;
}

template <typename T, bool SLOPE, bool WINDOW, int D>
int launch_dq(const DqParams& p, int B, cudaStream_t stream) {
  constexpr bool fp32 = std::is_same<T, float>::value;
  constexpr size_t smem = bwd_smem<T, D, true>();
  // once per instantiation, before any graph capture can be running
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, SLOPE, WINDOW, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  constexpr int R = bwd_rows<D>();
  dim3 grid((p.S + R - 1) / R, B * p.H);
  if (!fp32) {
    const int rc =
        tensor_core_grid(pb::persistent_dq(D), B, p.H, p.S, tcq::BM, &grid);
    if (rc) return rc;
  }
  flash_bwd_dq_kernel<T, SLOPE, WINDOW, D>
      <<<grid, bwd_threads<T>(), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool SLOPE, bool WINDOW, int D>
int launch_dkv(const DkvParams& p, int B, cudaStream_t stream) {
  constexpr bool fp32 = std::is_same<T, float>::value;
  constexpr size_t smem = bwd_smem<T, D, false>();
  // once per instantiation, before any graph capture can be running
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, SLOPE, WINDOW, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  constexpr int R = bwd_rows<D>();
  dim3 grid((p.S + R - 1) / R, B * p.H);
  if constexpr (!fp32 && D == 256) {
    // a cluster of C blocks per (batch, kv head, 64-key tile): C of the
    // group's query heads at once, summed on the card (dkv_cluster); a
    // cluster the card cannot place fails the launch.  (A persistent walk
    // of key-tile pairs ran 1.6x slower: the card holds 30 clusters of 4
    // at once, Gemma-2B's shape has 32 pairs.)
    const int C = cl::cluster_of(p.H / p.Hkv);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * p.Hkv * C, (p.S + cl::kKeys - 1) / cl::kKeys);
    cfg.blockDim = dim3(bwd_threads<T>());
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attrs[1];
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = C;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, flash_bwd_dkv_kernel<T, SLOPE, WINDOW, D>, p);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  if (!fp32) {
    const int rc =
        tensor_core_grid(pb::persistent(D), B, p.H, p.S, tc::BN, &grid);
    if (rc) return rc;
  }
  flash_bwd_dkv_kernel<T, SLOPE, WINDOW, D>
      <<<grid, bwd_threads<T>(), smem, stream>>>(p);
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
  // Q/dO and K/V tile rows
  constexpr int kRows = D == 256 ? cl::BM : tc::BM;
  constexpr int kKeys = D == 256 ? cl::kKeys : tc::BN;
  const int rc = make_maps<E, kRows, kKeys, D>(p, B);
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
  p.B = B;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2e = scale * hopper::kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dsflash::with_head_dim(D, [&](auto d) {
    constexpr int Dc = decltype(d)::value;
    if (dtype == 0) return launch_dq_biased<float, Dc>(p, B, s);
    if (dtype == 1) return launch_dq_tensor_cores<__nv_bfloat16, Dc>(p, B, s);
    if (dtype == 2) return launch_dq_tensor_cores<__half, Dc>(p, B, s);
    return (int)cudaErrorInvalidValue;
  });
}

// dk/dv: in k's dtype at [B, S, Hkv, D] when H == Hkv, and at every group
// in bf16 / fp16 at D = 256 (the group summed on the card); else fp32 [B,
// S, H, D], one row block per QUERY head (summed over the GQA group by the
// caller).
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
  p.dk = dk;
  p.dv = dv;
  p.slopes = static_cast<const float*>(slopes);
  p.window = window;
  p.B = B;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2e = scale * hopper::kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dsflash::with_head_dim(D, [&](auto d) {
    constexpr int Dc = decltype(d)::value;
    if (dtype == 0) return launch_dkv_biased<float, Dc>(p, B, s);
    if (dtype == 1) return launch_dkv_tensor_cores<__nv_bfloat16, Dc>(p, B, s);
    if (dtype == 2) return launch_dkv_tensor_cores<__half, Dc>(p, B, s);
    return (int)cudaErrorInvalidValue;
  });
}

// How many clusters of the bf16 (dtype 1) or fp16 (2) dK/dV kernel at head
// dim 256 the card holds at once at a GQA group (cudaOccupancyMaxActive-
// Clusters, cl::cluster_of(group) blocks a cluster), or minus a CUDA
// error code: a reading for scripts/flash_kernel_ab.py.
extern "C" int ds_flash_attention_bwd_dkv_clusters(int group, int dtype) {
  const auto held = [&](auto kernel) {
    constexpr size_t smem = cl::kBytes;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return -(int)e;
    const int C = cl::cluster_of(group);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(tc::kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attrs[1];
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = C;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    return e != cudaSuccess ? -(int)e : n;
  };
  if (dtype == 1)
    return held(flash_bwd_dkv_kernel<__nv_bfloat16, false, false, 256>);
  if (dtype == 2) return held(flash_bwd_dkv_kernel<__half, false, false, 256>);
  return -(int)cudaErrorInvalidValue;
}

// ---- delta = sum_d dO * O: the backward's row term -------------------------
//
// Replaces no Pallas kernel: _flash_bwd_pallas forms delta on the host side
// of the TPU kernels (deepspeed_tpu/ops/pallas/flash_attention.py), and XLA
// fuses it into its neighbours; the port formed it as four eager passes
// (two fp32 copies, a product and a sum).  One pass here: each row of D
// elements (16-byte vectors of O and dO in their own dtype) is read by 8
// lanes, summed in fp32 and reduced by three shuffles; a block takes 32
// neighbouring positions of one (batch, head), so its sums are stored
// next to each other in delta's [B, H, S] layout.  Bound by
// bytes: 2 x 42 MB read and 1 MB written at gpt_2_7b's training shape
// (B=8, S=1024, 32 heads of 80, bf16), 25.4 us at 3.35 TB/s.
namespace {

// The two elements of a 32-bit word of T pairs as floats (lo, hi); for
// float the word itself.
template <typename T>
__device__ __forceinline__ float lo_f(uint32_t w) {
  if constexpr (std::is_same<T, float>::value) return __uint_as_float(w);
  else if constexpr (std::is_same<T, __half>::value)
    return __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
  else return __uint_as_float(w << 16);
}
template <typename T>
__device__ __forceinline__ float hi_f(uint32_t w) {
  if constexpr (std::is_same<T, __half>::value)
    return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  else return __uint_as_float(w & 0xffff0000u);
}

// sum of the elementwise products of two 16-byte vectors of T, in fp32
template <typename T>
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(lo_f<T>(x[i]), lo_f<T>(y[i]), acc);
    if constexpr (!std::is_same<T, float>::value)
      acc = fmaf(hi_f<T>(x[i]), hi_f<T>(y[i]), acc);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int S, int H, int D) {
  constexpr int kLanes = 8;                   // lanes of a row
  const int vecs = D * (int)sizeof(T) / 16;   // 16-byte vectors of a row
  // block (x, bh): positions 32 x .. + 31 of (batch, head) bh
  const int s = blockIdx.x * (256 / kLanes) + threadIdx.x / kLanes;
  const int bh = blockIdx.y, lane = threadIdx.x % kLanes;
  float acc = 0.f;
  if (s < S) {
    const long long at =
        (((long long)(bh / H) * S + s) * H + bh % H) * D;
    const uint4* ov = reinterpret_cast<const uint4*>(o + at);
    const uint4* dv = reinterpret_cast<const uint4*>(dout + at);
    for (int v = lane; v < vecs; v += kLanes)
      acc += dot16<T>(__ldg(ov + v), __ldg(dv + v));
  }
#pragma unroll
  for (int m = kLanes / 2; m > 0; m /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (s < S && lane == 0) delta[(long long)bh * S + s] = acc;
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B, int S,
                 int H, int D, cudaStream_t stream) {
  const dim3 grid((S + 31) / 32, B * H);
  delta_kernel<T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, S, H, D);
  return (int)cudaGetLastError();
}

}  // namespace

// o/dout: [B, S, H, D] (dtype 0 = float32, 1 = bfloat16, 2 = float16);
// delta: fp32 [B, H, S].  D is 64, 80, 96, 128 or 256.  Returns
// cudaGetLastError().
extern "C" int ds_flash_attention_bwd_delta(const void* o, const void* dout,
                                            void* delta, int B, int S, int H,
                                            int D, int dtype, void* stream) {
  const int bad = dsflash::check_shape(B, S, H, H, D);
  if (bad) return bad;
  float* out = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_delta<float>(o, dout, out, B, S, H, D, s);
  if (dtype == 1)
    return launch_delta<__nv_bfloat16>(o, dout, out, B, S, H, D, s);
  if (dtype == 2) return launch_delta<__half>(o, dout, out, B, S, H, D, s);
  return (int)cudaErrorInvalidValue;
}
