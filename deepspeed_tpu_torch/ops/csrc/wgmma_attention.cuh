// The consumer warpgroup of the tensor-core attention kernels at head dims
// 64, 80, 96 and 256: the flash forward (flash_attention_fwd.cu) and the
// ragged paged prefill tiles (ragged_paged_attention.cu) run it over their
// K/V rings at all four.
//
// Why a body of its own at these head dims.  A 64-row warpgroup's share of
// a 128 x 128 tile is two products of 2 * 64 * 128 * D flops each (S = Q
// K^T, O += P V) and a softmax of 8,192 scores: an exponential each on the
// SFU (16 a clock an SM) and a handful of FP32 operations, whatever D is.
// At D = 128 the products are long enough to hide much of the softmax; at
// D = 64, 80 and 96 they are 1/2, 5/8 and 3/4 as long and the softmax is
// not, so the D = 128 body -- S, softmax, P V in series in each
// warpgroup, the two warpgroups in step -- leaves the tensor cores idle
// through every softmax and the SFUs idle through every product.  At D =
// 256 the products are long, but O takes 128 registers a thread, so a K/V
// tile holds 64 keys (kKeys) and each key tile's products are again short
// beside the fixed costs around them; run in series they left the tensor
// cores at 0.42 of their bound.
//
// What this body does about it (each step timed on its own at gpt_350m's
// training shape by scripts/flash_kernel_ab.py, and at gpt_760m's and
// gpt_2_7b's for D = 96 and 80, Gemma-2B's for 256; for the prefill tiles
// by scripts/decode_kernel_ab.py --prefill at the serving phases' shapes,
// where it read 0.85-0.89 of the in-step body's time at 80 and 96 and
// 0.91-0.96 at 256 (bf16) on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md
// has the numbers):
//   * fewer FP32 operations a score: the row max is taken on the raw
//     product (the softmax scale is positive, so the max commutes with
//     it) and scale * log2(e) is folded into the one FFMA that feeds ex2;
//     the mask runs only on tiles that cross a row's edge, as two
//     compares against bounds the kernel computes once; maxima and sums
//     are kept as two partials a row, so no chain of 32 dependent
//     operations stalls a warp.
//   * FA3's order within a warpgroup: S_{j+1} = Q K_{j+1}^T and O +=
//     P_j V_j are issued together, then softmax(S_{j+1}) runs while
//     P_j V_j is still in the tensor cores; O is rescaled once that
//     product retired.  S, P and O take kKeys / 2 + kKeys / 4 + D / 2
//     registers a thread (128, 136, 144; 176 at 256, where this order
//     spilled: there each tile runs in series, kFa3 false).
//   * ping-pong between the two consumer warpgroups: each issues its
//     products only on its turn (two named barriers), so one warpgroup's
//     products run under the other's softmax instead of beside it.  Every
//     work item gives each warpgroup n_tiles + 1 turns, tiles it does not
//     see included, so the turns stay paired whatever the masks skip.
//   * a K/V stage is released once the product that read it retired.
//
// In fp16 P enters P V rounded once, as in SDPA.  (Two fp16 terms, the
// rounded value and the rest, kept O one rounding of an fp32 value at
// twice the P V products: 1.19-1.27x the time of B4's prefill tiles at
// 256, whose fp16 outputs hold the fp16 rule with P rounded once.)
//
// Tiles: Q is 128 rows and K and V kKeys rows (128; 64 at D = 256) of
// boxes<D>() 64-column boxes (one at D = 64, two at 80 and 96, whose
// columns past D TMA fills with zeros, four at 256); S = Q K^T walks D /
// 16 slices across them (m64n128, or m64n64 at 256), O += P V is one m64nD
// product a 16-key slice, which reads V's first D columns only.
//
// The kernel supplies a Rows policy: what its rows see and how a raw
// score becomes a logit --
//   float c;                          // exponent multiplier: logit units
//                                     // -> log2 units
//   bool edge(int k0) const;          // the tile at key k0 needs the mask
//   bool keep(int key, int r) const;  // row r (0: row0, 1: row0 + 8) of
//                                     // this thread sees key (edge tiles)
//   float key_base(int k0) const;     // per tile, for logit()
//   float logit(float s, int i, float kb) const;  // score i, raw product s
// m (the running max, in logit units) and l (this lane's share of the row
// sum) come back to the kernel, which writes O and, for the flash forward,
// LSE.
#pragma once

#include "attention_tile.cuh"
#include "hopper.cuh"

namespace dswg {

using namespace hopper;
using dsattn::kNeg;               // masked score
constexpr int kBox = 128 * kBoxCols * 2;   // one 64-column box of 128 rows

// Keys of a K/V tile at head dim D: 128, but 64 at 256, where O alone is
// 128 registers a thread.
__host__ __device__ constexpr int tile_keys(int D) {
  return D == 256 ? 64 : 128;
}

// S = Q K^T over depth D (D / 16 16-column slices: four a box, the second
// box's from slice 4 on), kKeys keys wide; committed, not waited for.
template <typename E, int D>
__device__ __forceinline__ void issue_s(float (&s)[tile_keys(D) / 2],
                                        uint32_t q_addr, uint32_t k_addr) {
  constexpr int kKeys = tile_keys(D), kKvBox = kKeys * kBoxCols * 2;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t qd = desc_kmajor(q_addr + kslice(kk, kBox));
    const uint64_t kd = desc_kmajor(k_addr + kslice(kk, kKvBox));
    if constexpr (kKeys == 128)
      wgmma_ss_n128<E>(s, qd, kd, kk > 0);
    else
      wgmma_ss_n64<E>(s, qd, kd, kk > 0);
  }
  wgmma_commit();
}

// O += P V: P from registers, V read transposed from the stage's tile
// (m64nD, its columns across V's boxes); committed, not waited for.
template <typename E, int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[tile_keys(D) / 4],
                                         uint32_t v_addr) {
  constexpr int kKeys = tile_keys(D), kKvBox = kKeys * kBoxCols * 2;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                           pa[4 * kk + 3]};
    wgmma_rs<E, D>(o, a, desc_mnmajor(v_addr + kk * 2048, kKvBox));
  }
  wgmma_commit();
}

// The online softmax of one tile's scores s (in place: raw products in,
// probabilities out), updating m and l; corr[r] is row r's rescale of O.
// A row that has seen no key yet keeps m = -1e30; its exponents are taken
// from 0, so its masked scores give exactly 0.
template <class Rows, int kS>
__device__ __forceinline__ void softmax_tile(const Rows& rows, float (&s)[kS],
                                             int k0, int t, float (&m)[2],
                                             float (&l)[2], float (&corr)[2]) {
  const float kb = rows.key_base(k0);
#pragma unroll
  for (int i = 0; i < kS; ++i) s[i] = rows.logit(s[i], i, kb);
  if (rows.edge(k0)) {
#pragma unroll
    for (int i = 0; i < kS; ++i)
      if (!rows.keep(k0 + acc_col(i, t), (i / 2) % 2)) s[i] = kNeg;
  }
  float mx[2][2] = {{kNeg, kNeg}, {kNeg, kNeg}};   // [row][column parity]
#pragma unroll
  for (int i = 0; i < kS; ++i)
    mx[(i / 2) % 2][i % 2] = fmaxf(mx[(i / 2) % 2][i % 2], s[i]);
  const float c = rows.c;
  float mc[2];   // m * c: the exponents' offset
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(mx[r][0], mx[r][1]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[r], x);
    mc[r] = m_new <= kNeg / 2 ? 0.f : m_new * c;
    corr[r] = ex2(fmaf(m[r], c, -mc[r]));
    m[r] = m_new;
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    const int r = (i / 2) % 2;
    s[i] = ex2(fmaf(s[i], c, -mc[r]));
    sum[r][i % 2] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = fmaf(l[r], corr[r], sum[r][0] + sum[r][1]);
}

// Rescale O by the step's corr, then P (E pairs) from the probabilities.
template <typename E, int D, int kS>
__device__ __forceinline__ void rescale_pack(float (&o)[D / 2],
                                             const float (&corr)[2],
                                             const float (&s)[kS],
                                             uint32_t (&pa)[kS / 2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];
  acc_to_a<E>(s, pa);
}

// The two consumer warpgroups' turns to issue products: warpgroup w
// waits on named barrier 1 + w (its own 128 threads and the other's 128
// arrivals), issues, then arrives on the other's.  Warpgroup 1 calls
// first_turn() once, before its first wait, to give warpgroup 0 the first
// turn; the turns then alternate for the rest of the kernel.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}
__device__ __forceinline__ void first_turn(int wg) {
  if (wg == 1) turn_pass(1);
}

// The consumer's walk over one work item's tiles in the ring.  Tile it <
// n_tiles is ring slot g0 + it: stage (g0 + it) % kStages (K at kv0 +
// stage * 2 * kTile, V kTile after it), full[] / empty[] as in the
// kernels' producers (empty[] counts 256 arrivals: both consumer
// warpgroups).  This warpgroup sees tiles [first, last) (keys
// k_lo + it * tile_keys(D)); the others it only waits for, passes its
// turns on and releases.  Returns with every product retired.  D is the
// head dim (64, 80, 96 or 256).  kFa3: FA3's order (n_tiles + 1 turns an
// item);
// else each tile's S, softmax and P V in series, a turn for each product
// (2 n_tiles turns), which keeps S and P out of registers at once.
template <typename E, int D, int kStages, int kTile, bool kFa3 = true,
          class Rows>
__device__ __forceinline__ void attend_tiles(
    const Rows& rows, uint32_t q_addr, uint32_t kv0, uint64_t* full,
    uint64_t* empty, int g0, int n_tiles, int first, int last, int k_lo,
    int t, float (&o)[D / 2], float (&m)[2], float (&l)[2]) {
  static_assert(D == 64 || D == 80 || D == 96 || D == 256,
                "the shared consumer takes head dims 64, 80, 96 and 256");
  constexpr int kKeys = tile_keys(D), kS = kKeys / 2;
  const int wg = threadIdx.x / 128;
  const auto k_at = [&](int g) {
    return kv0 + (uint32_t)((g % kStages) * 2 * kTile);
  };
  const auto release = [&](int g) { mbar_arrive(&empty[g % kStages]); };
  const auto skip = [&](int g) {   // a slot this warpgroup does not see
    mbar_wait(&full[g % kStages], (g / kStages) & 1);
#pragma unroll
    for (int i = 0; i < (kFa3 ? 1 : 2); ++i) {
      turn_wait(wg);
      turn_pass(wg);
    }
    release(g);
  };
  last = max(first, last);
  for (int it = 0; it < first; ++it) skip(g0 + it);
  if constexpr (!kFa3) {
    for (int it = first; it < last; ++it) {
      const int g = g0 + it;
      float s[kS], corr[2];
      uint32_t pa[kS / 2];
      mbar_wait(&full[g % kStages], (g / kStages) & 1);
      turn_wait(wg);
      issue_s<E, D>(s, q_addr, k_at(g));
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(rows, s, k_lo + it * kKeys, t, m, l, corr);
      rescale_pack<E, D>(o, corr, s, pa);
      turn_wait(wg);
      fence_regs(o);
      fence_regs(pa);
      issue_pv<E, D>(o, pa, k_at(g) + kTile);
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release(g);
    }
  } else if (first < last) {
    float s[kS], corr[2];
    uint32_t pa[kS / 2];
    int g = g0 + first;
    mbar_wait(&full[g % kStages], (g / kStages) & 1);
    turn_wait(wg);
    issue_s<E, D>(s, q_addr, k_at(g));
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(rows, s, k_lo + first * kKeys, t, m, l, corr);
    acc_to_a<E>(s, pa);                 // O is 0: nothing to rescale
    for (int it = first; it + 1 < last; ++it, ++g) {
      mbar_wait(&full[(g + 1) % kStages], ((g + 1) / kStages) & 1);
      turn_wait(wg);
      issue_s<E, D>(s, q_addr, k_at(g + 1));
      fence_regs(o);
      fence_regs(pa);
      issue_pv<E, D>(o, pa, k_at(g) + kTile);
      turn_pass(wg);
      wgmma_wait<1>();                  // S of the next tile complete
      fence_regs(s);
      softmax_tile(rows, s, k_lo + (it + 1) * kKeys, t, m, l, corr);
      wgmma_wait<0>();                  // this tile's P V complete
      fence_regs(o);
      fence_regs(pa);
      release(g);
      rescale_pack<E, D>(o, corr, s, pa);
    }
    turn_wait(wg);                      // the last tile's P V
    fence_regs(o);
    fence_regs(pa);
    issue_pv<E, D>(o, pa, k_at(g) + kTile);
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(g);
  } else {                              // the turn of the last P V
    turn_wait(wg);
    turn_pass(wg);
  }
  for (int it = last; it < n_tiles; ++it) skip(g0 + it);
}

}  // namespace dswg
