// Split-key decode attention, shared by the two serving kernels that read
// a KV cache one query token at a time: the contiguous cache's decode
// (decode_attention.cu) and the paged cache's decode rows
// (ragged_paged_attention.cu).  They differ only in where a sequence's
// query rows and keys live, which the caller's ``Seqs`` functor says.
//
// Computes, for each sequence z and kv head hk, the attention of ROWS <= 8
// query rows (a GQA group folded in: row r is token r / group of head
// hk * group + r % group) over keys [0, kv_hi) with the causal-ragged mask
// key < lim(r), an fp32 online softmax, and 0 for a row that sees no key.
// Head dim D is 16, 64, 80, 96, 128 or 256, the element type fp32, bf16 or
// fp16.  D = 16 (the ``tiny`` model of the benches) takes the CUDA-core
// body at every row count and dtype: its key row is 2 (bf16 / fp16) or 4
// (fp32) 16-byte vectors, so LPR = LD and a warp load covers 16 or 8 keys.
//
// What bounds it on the H100: every cached K/V byte is read once for 4*D
// flops per key per row -- at most 8 flops per byte at 8 rows, far under
// the card's ~295 flop/byte ridge, so HBM bandwidth (3.35 TB/s) is the
// bound, and a decode step is short enough that the memory system has to
// be kept busy from the first cycle: memory-level parallelism is the
// design.  What it must not become is bound by instructions: a CUDA-core
// dot product costs a lane its FMAs, log2(lanes) shuffles and the softmax
// per row and key, which at 5-8 rows outruns the bytes.
//
// One block per (key chunk, kv head, sequence): grid (n_split, Hkv, Z).
// The keys of a sequence go to one block, or are split into chunks of
// ``chunk`` keys, one block each (flash-decoding), when Z * Hkv blocks
// would leave the card's block slots idle -- the wrapper sizes the split
// from the occupancy query (split_slots) and the body's shortest chunk
// that pays for the merge (ops/cuda/decode_attention.py min_chunk).  Two
// block bodies:
//
// * CUDA cores (1-4 rows, but one row at 80, 96 and 256 in bf16 / fp16
//   only over short chunks, below; fp32 at any row count): each lane
//   holds 16 bytes of a key row's dims (8 bf16 / fp16, 4 fp32), LPR lanes
//   a row slice; the warp's other lane groups take other keys, and every
//   lane holds every row's q and accumulator in registers.  LPR is D / VEC rounded
//   up to a power of two, so that a row's lanes sum by shuffles and a warp
//   holds whole rows: at D = 80 and 96 the lanes past D / VEC (6 and 4 of
//   16 in bf16 / fp16, 12 and 8 of 32 in fp32) load nothing and add 0, so
//   a warp load moves 10/16 or 12/16 of the bytes it moves at D = 64 and
//   128, in the same 16-byte loads.  At D = 256 a key row is a whole
//   warp's: 32 lanes of one 16-byte vector in bf16 / fp16, of two in fp32
//   (its groups hold half as many keys, so that a lane's loads in flight
//   stay 64 registers).  A block has 16, 8 or 4
//   warps for 1, 2 or 3-8 rows (as many as one SM's registers hold), and
//   each warp takes every n-th group of KEYS keys of the block's keys.  A
//   warp issues all of a group's 16-byte K and V loads into registers
//   before it uses any (kept out of L1: each byte is read once), so some
//   128 KB are in flight on every SM; nothing is staged in shared memory.
//   (fp32 at 5-8 rows keeps 1 load a lane in flight, not 8, so that
//   nothing spills: it serves the 1e-4 checks, not a main path's speed.)
//   A score is a dot product over a row slice's LPR lanes, summed by
//   log2(LPR) shuffles.  The online softmax is fp32 in base 2 (q
//   prescaled by scale * log2 e); each lane accumulates P V for its own
//   keys' V slices.
// * Tensor cores (5-8 rows, bf16 / fp16, at 64 and 128, and at 80 and 96
//   over chunks under kStagedRowsKeys keys): mma.sync.m16n8k16, the rows as
//   the 8 columns of an n8 tile, so nothing is padded.  A block has 8
//   warps, and a warp takes 16 keys at a time: S^T = K Q^T (16 keys x 8
//   rows, fp32) from K rows loaded straight into A-operand registers -- a
//   lane's 16-byte loads give it the same dims of two keys as of its q
//   row, and a dot product does not care which dims a k step holds, so no
//   shuffle is needed -- then the online softmax on the accumulators
//   (each lane owns 2 rows of 2 keys; a row's max is three shuffles), P^T
//   moved to the B-operand layout by movmatrix, and O^T += V^T P^T (16
//   dims x 8 rows a tile) with V's key pairs packed by prmt.  P enters the
//   product as two terms of the element type, the rounded value and the
//   rest, so P V keeps ~16 bits of P and the result is one rounding of an
//   fp32 value, as on the CUDA cores.  Each warp keeps two 16-key tiles
//   in registers, the next one's loads in flight while it uses the
//   current one, and reads a tile's page once (``run``), a tile earlier.
//   Instructions per key fall ~10x below the CUDA-core body's at 5 rows.
//   At D = 80 and 96 the head's last 16 or 32 dims are a tail: a lane's
//   K, q and V loads that would start past D are not issued and read as
//   zeros, so the products run 6 k steps of S^T at both (at 80 the last
//   one half zero) and D = 128's 8 output tiles of O^T (3 or 2 of them on
//   zero rows, never stored): tensor-core work the body has to spare, for
//   loads that stay 16 bytes and registers no more than D = 128's.
// * Tensor cores at D = 256 (5-8 rows, bf16 / fp16; Gemma's heads): the
//   staged body, split_staged_kernel, which replaces the TPU kernels
//   deepspeed_tpu/ops/pallas/decode_attention.py:45 _decode_kernel
//   (pallas_call at :138) and ragged_paged_attention.py:57 _ragged_kernel
//   (:160) for these rows.  Its bound on the H100 is the K/V bytes over
//   3.35 TB/s (Gemma-2B's B=4 step over 144 keys, 590 KB: 0.18 us; over
//   4096 keys, 16.8 MB: 5.0 us), and what kept the register body from it
//   was latency: a 16-key tile's K and V are 128 registers a lane at this
//   head dim, so a warp held one tile, 4 warps a block 64 KB in flight,
//   and every round of 64 keys waited on HBM.  Here K and V go through
//   shared memory instead: one producer warp streams 64-key K and V tiles
//   by TMA (2-d tensor maps over the cache's rows, four swizzled 64-column
//   boxes a tile, hopper.cuh) into a ring of kStages stages of 64 KB with
//   mbarriers, so up to 192 KB of a chunk are in flight from the first
//   cycle, and the registers hold only O^T (64), q's fragments (32) and
//   the operands.  Eight consumer warps in two groups of four take the
//   tiles in turn, 16 keys a warp: S^T = K Q^T with K read by ldmatrix
//   from the swizzled tile (the 8 rows of a fragment in 8 bank groups;
//   unswizzled 512-byte rows would put them in one), the online softmax
//   and P^T as above, O^T += V^T P^T with V read by ldmatrix.trans, V's
//   keys past the chunk's end read as 0 (their rows hold whatever the
//   stage held: 0 P times a stale NaN would not be 0).  The warps' (acc,
//   m, l) merge through 64 KB of dynamic shared memory laid over the
//   ring, the warps' weights formed once a row.  A sequence's keys split
//   into chunks of 128 keys and up (ops/cuda/decode_attention.py
//   min_chunk), so a few (sequence, kv head) pairs still fill the card,
//   and the combine's row blocks load their chunks at once; the block's
//   first tile's page is read beside the sequence's metadata, not after
//   it.
// * One row at D = 80, 96 and 256 (bf16 / fp16: the MHA decode steps of
//   gpt_2_7b, Phi-3-mini and Gemma-7B) over chunks of kStagedOneRowKeys
//   keys and up, and 5-8 rows at 80 and 96 (gpt_2_7b's speculative verify
//   window of 5) over chunks of kStagedRowsKeys keys and up: the staged
//   body too, templated on D (Staged<D>: two 64-column boxes a tile at 80
//   and 96, whose columns past D TMA fills with zeros, and two blocks an
//   SM), the rows past the real ones zero and masked.  On the CUDA-core
//   body the serve run's 8-slot step took as long as its longest
//   sequences' blocks: a block of 16 warps held its loads in registers
//   and moved some 25-40 GB/s, and at 80 and 96 its 256 (sequence, kv
//   head) pairs took two waves of one block an SM.
//   Neither finer chunks (their empty blocks and the combine) nor one
//   wave of short units balanced over the step (each unit a chain of
//   dependent loads) beat it; streaming through shared memory did:
//   0.0175 / 0.0178 / 0.0222 -> 0.0159 / 0.0165 / 0.0190 ms at 80 / 96 /
//   256 (NVIDIA H100 80GB HBM3, 700 W; scripts/decode_kernel_ab.py,
//   PERF.md).  Over shorter chunks -- a generate step's 160-key cache --
//   the CUDA-core body keeps the row: the staged body's fixed cost read
//   3-10% slower there.  At 5 rows and 80 / 96 the register tensor-core
//   body held one 256-thread block an SM, so the verify window's 256
//   (sequence, kv head) pairs took two waves: 0.0188-0.0190 ms, against
//   0.0165-0.0171 staged in one wave of two blocks an SM; it keeps chunks
//   under 512 keys (0.0068 against 0.0070 over a 160-key cache), and a
//   split plan's chunks of 512 keys read best there (B=1 over 2048 keys:
//   0.0132 ms; 0.0138 at 256, 0.0165 at 128).
//
// Only real rows are computed.  Merges run in a fixed order, so runs
// repeat bit for bit: the warps in shared memory by warp index, and, when
// a sequence spans several chunks, the chunks' (m, l, acc) by a second
// small kernel in chunk order, launched early (programmatic dependent
// launch) so that its launch latency hides under the chunks' tail.  The
// caller gives the partial buffer (fp32, from torch's caching allocator
// on the launch stream); nothing is allocated here, so the launch can be
// captured in a CUDA graph.  A sequence whose keys fit one chunk is
// finished by that chunk's block and the combine skips it.
//
// ``Seqs`` has ``kDim`` (the head dim) and provides ``seq(z, hk)``, a
// per-block view with ``kv_hi`` (keys of the sequence), ``rows`` (its real
// query rows, <= ROWS), ``row(r)`` (element offset of query row r in q and
// o), ``lim(r)`` (keys below it are visible to row r), ``key(k)`` (element
// offset of key k's K and V row) and ``run(k)`` (how many keys from k on
// are stored D elements apart); for the staged body, ``page_of(k)`` (what
// locates key k's rows: its page, a table read) and ``box_row(k, page)``
// (the row of key k in the [rows, D] view of K and V that the tensor maps
// cover).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"
#include "hopper.cuh"

namespace dsdecode {

using dsattn::from_f;
using dsattn::kNeg;
using dsattn::to_f;

constexpr int kMaxRows = 8;         // query rows per kv head of the form
constexpr float kLog2e = 1.4426950408889634f;

// Whether ROWS rows of element type T at head dim D take the tensor-core
// body: 5-8 rows in bf16 / fp16, but never at D = 16, where a key row is
// one k step and the CUDA-core body's two-lane rows cost less.
template <typename T, int ROWS, int D>
constexpr bool kTensorCores =
    ROWS > 4 && !std::is_same<T, float>::value && D != 16;

// Whether ROWS rows of T at head dim D take the staged tensor-core body:
// 5-8 rows and one row (the MHA decode step) at 80, 96 and 256, in bf16 /
// fp16 -- one row only where the launch's chunks hold at least
// kStagedOneRowKeys keys, 5-8 rows at 80 and 96 only where they hold at
// least kStagedRowsKeys (launch_split; ops/cuda/decode_attention.py
// staged() mirrors both): over shorter ones (a generate step's 160-key
// cache) the CUDA-core body's and the register tensor-core body's smaller
// fixed costs win.
template <typename T, int ROWS, int D>
constexpr bool kStaged =
    !std::is_same<T, float>::value &&
    (ROWS > 4 || ROWS == 1) && (D == 80 || D == 96 || D == 256);
constexpr int kStagedOneRowKeys = 512;
constexpr int kStagedRowsKeys = 512;

// Blocks of the combine kernel a sequence's rows take: one a row after the
// staged body, whose short chunks leave the combine a larger share of a
// step (8 rows one after another added 7.3 us to Gemma-2B's step split in
// two: PERF.md §6), else one for every row.
template <typename T, int ROWS, int D>
constexpr int kCombineRowBlocks = kStaged<T, ROWS, D> ? ROWS : 1;

// Lane layout of the CUDA-core body for element type T, head dim D and
// ROWS query rows: a key row is DL vectors of VEC elements (16 bytes), NV
// of them a lane's (2 in fp32 at D = 256, where a row is 64 vectors: more
// than a warp's lanes), so LD lanes hold its dims, LPR lanes a row slice; a
// warp load covers KPL keys, a group is LOADS loads a lane, KEYS keys;
// WARPS warps a block (the registers of one SM hold 2-4 blocks: a row's q,
// accumulator and scores cost a lane 2 * NV * VEC + LOADS registers beside
// the 8 * NV * LOADS of a group's loads, which stay 64 at NV = 2 by halving
// LOADS, and are halved again at D = 256 for 3-4 rows, where 8 loads
// spilled).  The tensor-core body has WARPS = 8 warps (4 measured slower,
// PERF.md) at D <= 128; the staged body at D = 256 has 8 consumer warps
// and a producer warp (Staged).  At D = 16 a row's LD lanes are its slice
// (LPR = LD: 2 in bf16 / fp16, 4 in fp32), so no lane idles and a score
// sums in one or two shuffles.
template <typename T, int D, int ROWS>
struct Layout {
  static_assert(D == 16 || D == 64 || D == 80 || D == 96 || D == 128 ||
                    D == 256,
                "head dim 16, 64, 80, 96, 128 or 256");
  static_assert(ROWS >= 1 && ROWS <= kMaxRows, "1-8 rows");
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int DL = D / VEC;   // vectors of a key row
  static constexpr int NV = DL > 32 ? DL / 32 : 1;   // of them a lane's
  static constexpr int LD = DL / NV;   // lanes that hold a key row's dims
  static constexpr int LPR = D == 16 ? LD : LD <= 8 ? 8 : LD <= 16 ? 16 : 32;
  static constexpr int KPL = 32 / LPR;
  static constexpr int LOADS =
      ROWS > 4 ? 1 : (D > 128 && ROWS > 2 ? 4 : 8) / NV;
  static constexpr int KEYS = LOADS * KPL;
  static constexpr int WARPS = kTensorCores<T, ROWS, D> ? 8
                               : ROWS == 1 ? 16 : ROWS == 2 ? 8 : 4;
};

// One 16-byte load of a K/V row slice, which is read once: kept out of L1.
__device__ __forceinline__ uint4 load16(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u,
                                       float (&f)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int x = 0; x < 16 / (int)sizeof(T); ++x) f[x] = to_f(e[x]);
}

template <typename Seqs>
struct SplitParams {
  // the staged body's K and V (a [kv_rows, D] view, boxes of box_rows rows
  // by 64 columns): made by launch_split from k, v, kv_rows and box_rows
  CUtensorMap k_map, v_map;
  long long kv_rows;
  int box_rows;
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part;          // [Z * Hkv * n_split * ROWS] x (D acc, then m, l)
  Seqs seqs;
  int Hkv, n_split, chunk;
  float scale;
};

// Chunks the keys [0, kv_hi) of a sequence take.
__device__ __forceinline__ int active_chunks(int kv_hi, int chunk) {
  return max(1, (kv_hi + chunk - 1) / chunk);
}

// The end of the register bodies: the block's warps, whose (acc, m, l) per
// row are in shared memory, merged in warp order; thread i owns dims i, i +
// the block's threads, .. of every row and writes the row's output at
// off[r] (one chunk) or the chunk's partial.
template <typename T, int ROWS, int WARPS, typename Seqs, typename Seq>
__device__ __forceinline__ void finish(
    const SplitParams<Seqs>& p, const Seq& seq, int n_chunks, int split,
    int z, int hk, const long long (&off)[ROWS],
    const float (&acc_s)[WARPS][ROWS][Seqs::kDim],
    const float (&m_s)[WARPS][ROWS], const float (&l_s)[WARPS][ROWS]) {
  constexpr int D = Seqs::kDim;
  constexpr int kThreads = WARPS * 32;
  const long long zhk = (long long)z * p.Hkv + hk;
  // one dim a thread where the block's threads cover D (every D <= 128:
  // the form measured before D = 256 came), a loop over dims otherwise
  const auto merge = [&](int d) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= seq.rows) break;
      float mm = kNeg;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, m_s[w][r]);
      float ll = 0.f, aa = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float c = ex2(m_s[w][r] - mm);
        ll = fmaf(l_s[w][r], c, ll);
        aa = fmaf(acc_s[w][r][d], c, aa);
      }
      if (n_chunks == 1) {
        static_cast<T*>(p.o)[off[r] + d] = from_f<T>(aa / fmaxf(ll, 1e-30f));
      } else {
        const long long at = (zhk * p.n_split + split) * ROWS + r;
        p.part[at * (D + 2) + d] = aa;
        if (d == 0) {
          p.part[at * (D + 2) + D] = mm;
          p.part[at * (D + 2) + D + 1] = ll;
        }
      }
    }
  };
  if constexpr (kThreads >= D) {
    const int d = threadIdx.x;
    if (d >= D) return;
    merge(d);
  } else {
    for (int d = threadIdx.x; d < D; d += kThreads) merge(d);
  }
}

// ---- the CUDA-core body --------------------------------------------------

template <typename T, int ROWS, typename Seqs>
__global__ void __launch_bounds__(Layout<T, Seqs::kDim, ROWS>::WARPS * 32)
split_kernel(const __grid_constant__ SplitParams<Seqs> p) {
  constexpr int D = Seqs::kDim;
  using L = Layout<T, D, ROWS>;
  constexpr int VEC = L::VEC, NV = L::NV, LD = L::LD, LPR = L::LPR;
  constexpr int KPL = L::KPL, LOADS = L::LOADS, KEYS = L::KEYS;
  constexpr int kWarps = L::WARPS;
  constexpr int E = NV * VEC;          // a lane's elements of a key row
  constexpr int kVecStride = LPR * VEC;   // between a lane's vectors
  // NV = 1 (every head dim but fp32 at 256) keeps its own statements
  // below: the loops over a lane's vectors, with the same registers,
  // compiled to a B4 decode step 6% slower at D = 128 (PERF.md §6)
  __shared__ float acc_s[kWarps][ROWS][D];
  __shared__ float m_s[kWarps][ROWS], l_s[kWarps][ROWS];

  const int split = blockIdx.x, hk = blockIdx.y, z = blockIdx.z;
  // the combine kernel may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;");
  const auto seq = p.seqs.seq(z, hk);
  const int n_active = active_chunks(seq.kv_hi, p.chunk);
  if (split >= n_active) return;
  const int k_begin = split * p.chunk;
  const int k_end = min(seq.kv_hi, k_begin + p.chunk);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = (lane % LPR) * VEC, kl = lane / LPR;
  const bool dims = LD == LPR || lane % LPR < LD;   // lanes past D idle
  const T* q = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.k) + d0;
  const T* vp = static_cast<const T*>(p.v) + d0;

  // the rows' q slices (prescaled to base 2), key limits and offsets
  const float qscale = p.scale * kLog2e;
  float qr[ROWS][E];
  int lim[ROWS];
  long long off[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const bool real = r < seq.rows;
    off[r] = real ? seq.row(r) : 0;
    lim[r] = real ? min(seq.lim(r), k_end) : k_begin;   // keys < lim
    if constexpr (NV == 1) {
      const uint4 u = real && dims
                          ? *reinterpret_cast<const uint4*>(q + off[r] + d0)
                          : make_uint4(0u, 0u, 0u, 0u);
      unpack<T>(u, qr[r]);
#pragma unroll
      for (int x = 0; x < VEC; ++x) qr[r][x] *= qscale;
    } else {
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const uint4 u = real && dims ? *reinterpret_cast<const uint4*>(
                                           q + off[r] + d0 + n * kVecStride)
                                     : make_uint4(0u, 0u, 0u, 0u);
        float f[VEC];
        unpack<T>(u, f);
#pragma unroll
        for (int x = 0; x < VEC; ++x) qr[r][n * VEC + x] = f[x] * qscale;
      }
    }
  }

  float m[ROWS], l[ROWS], acc[ROWS][E];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int x = 0; x < E; ++x) acc[r][x] = 0.f;
  }

  for (int g0 = k_begin + warp * KEYS; g0 < k_end; g0 += kWarps * KEYS) {
    // every load of the group in flight before any is used
    uint4 kr[LOADS * NV], vr[LOADS * NV];   // load j's vector n: j * NV + n
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int key = g0 + j * KPL + kl;
      const bool in = key < k_end && dims;
      const long long at = in ? seq.key(key) : 0;
      if constexpr (NV == 1) {
        kr[j] = in ? load16(kp + at) : make_uint4(0u, 0u, 0u, 0u);
        vr[j] = in ? load16(vp + at) : make_uint4(0u, 0u, 0u, 0u);
      } else {
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          kr[j * NV + n] = in ? load16(kp + at + n * kVecStride)
                              : make_uint4(0u, 0u, 0u, 0u);
          vr[j * NV + n] = in ? load16(vp + at + n * kVecStride)
                              : make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    // scores: each lane's slice of key row j, summed over the row's lanes
    float s[ROWS][LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      float kf[E];
      if constexpr (NV == 1) {
        unpack<T>(kr[j], kf);
      } else {
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          float f[VEC];
          unpack<T>(kr[j * NV + n], f);
#pragma unroll
          for (int x = 0; x < VEC; ++x) kf[n * VEC + x] = f[x];
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float a = 0.f;
#pragma unroll
        for (int x = 0; x < E; ++x) a = fmaf(qr[r][x], kf[x], a);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, o);
        s[r][j] = a;
      }
    }
    // online softmax over the group, one shared max for the warp's lanes
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < LOADS; ++j) {
        if (g0 + j * KPL + kl >= lim[r]) s[r][j] = kNeg;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int o = 16; o >= LPR; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float corr = ex2(m[r] - m_new);   // 0 from kNeg, 1 if unchanged
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int x = 0; x < E; ++x) acc[r][x] *= corr;
#pragma unroll
      for (int j = 0; j < LOADS; ++j) {
        // a masked key is 0, also while the row has seen no key (m = kNeg)
        const float pr = s[r][j] <= kNeg / 2 ? 0.f : ex2(s[r][j] - m_new);
        s[r][j] = pr;
        l[r] += pr;
      }
    }
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      float vf[E];
      if constexpr (NV == 1) {
        unpack<T>(vr[j], vf);
      } else {
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          float f[VEC];
          unpack<T>(vr[j * NV + n], f);
#pragma unroll
          for (int x = 0; x < VEC; ++x) vf[n * VEC + x] = f[x];
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int x = 0; x < E; ++x)
          acc[r][x] = fmaf(s[r][j], vf[x], acc[r][x]);
    }
  }

  // the warp's key rows (bf16 and fp16 at D = 80, 96 and 128: lanes l and
  // l + 16 hold the same dims; fp32 at those and every dtype at 256: each
  // lane its own)
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int o = 16; o >= LPR; o >>= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int x = 0; x < E; ++x)
        acc[r][x] += __shfl_xor_sync(0xffffffffu, acc[r][x], o);
    }
    if (lane < LD) {
      if constexpr (NV == 1) {
#pragma unroll
        for (int x = 0; x < VEC; ++x) acc_s[warp][r][d0 + x] = acc[r][x];
      } else {
#pragma unroll
        for (int n = 0; n < NV; ++n)
#pragma unroll
          for (int x = 0; x < VEC; ++x)
            acc_s[warp][r][d0 + n * kVecStride + x] = acc[r][n * VEC + x];
      }
    }
    if (lane == 0) {
      m_s[warp][r] = m[r];
      l_s[warp][r] = l[r];
    }
  }
  __syncthreads();
  finish<T, ROWS, kWarps, Seqs>(p, seq, n_active, split, z, hk, off, acc_s,
                                m_s, l_s);
}

// ---- the tensor-core body (5-8 rows, bf16 / fp16) ------------------------

// D = C + A B, m16n8k16, fp32 accumulators, A and B of element type T.
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The transpose of the warp's 8x8 16-bit matrix (lane l holds row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1) in the same layout.
__device__ __forceinline__ uint32_t trans8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(y) : "r"(x));
  return y;
}

// Bytes of {b, a} picked by ``sel`` (prmt): 0x5410 gives (a.lo, b.lo),
// 0x7632 (a.hi, b.hi), the first in the low half.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Two fp32 values rounded to T and packed, lo in the low half; and back.
template <typename T>
__device__ __forceinline__ uint32_t pack_t2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}
template <typename T>
__device__ __forceinline__ float half_f(uint32_t x, int hi) {
  const T* e = reinterpret_cast<const T*>(&x);
  return to_f(e[hi]);
}

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// The online softmax of a warp's 16 keys kb.. kb + 15 from their S^T
// accumulators ``s`` (lane (g, t): s[0], s[2] row 2 t's keys g, g + 8;
// s[1], s[3] row 2 t + 1's), raw products: scaled by qscale (scale * log2
// e), masked past lim (rows 2 t, 2 t + 1), m, l and the MT output tiles o
// rescaled, and P^T as the B operands of O^T += V^T P^T: bh the rounded P,
// bl the rest rounded (keys 2 t, 2 t + 1 | 2 t + 8, 2 t + 9; row g).
template <typename T, int MT>
__device__ __forceinline__ void online_softmax(
    float (&s)[4], int kb, int g, const int (&lim)[2], float qscale,
    float (&m)[2], float (&l)[2], float (&o)[MT][4], uint32_t (&bh)[2],
    uint32_t (&bl)[2]) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    s[x] *= qscale;
    if (kb + g + 8 * (x / 2) >= lim[x % 2]) s[x] = kNeg;
  }
  // a row's keys are spread over the lanes of one t
  float corr[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float mx = fmaxf(s[j], s[j + 2]);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[j], mx);
    corr[j] = ex2(m[j] - m_new);    // 0 from kNeg, 1 if unchanged
    m[j] = m_new;
    l[j] *= corr[j];
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    // a masked key is 0, also while the row has seen no key (m = kNeg)
    s[x] = s[x] <= kNeg / 2 ? 0.f : ex2(s[x] - m[x % 2]);
    l[x % 2] += s[x];
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[i][x] *= corr[x % 2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const uint32_t hi = pack_t2<T>(s[2 * c], s[2 * c + 1]);
    const uint32_t lo = pack_t2<T>(s[2 * c] - half_f<T>(hi, 0),
                                   s[2 * c + 1] - half_f<T>(hi, 1));
    bh[c] = trans8x8(hi);
    bl[c] = trans8x8(lo);
  }
}

// Lane (g, t) = (lane / 4, lane % 4) of a warp's 16 keys kb.. kb + 15:
// * S^T = K Q^T, an m16n8 tile per 16 dims of the head (the k step): A is
//   keys g and g + 8, B is q row g, both from the lane's dims 32 j + 8 t ..
//   + 7 (j < KJ; zeros past D), whose 32-bit words 2 s and 2 s + 1 feed k
//   step 2 j + s; the accumulators are (key g, rows 2 t, 2 t + 1) and (key
//   g + 8, the same rows).
// * O^T += V^T P^T, an m16n8 tile per 16 dims of the output: A is V of
//   keys 2 t, 2 t + 1, 2 t + 8, 2 t + 9 at the lane's dims 64 h + 8 g .. +
//   7 (zeros past D), word e of load h feeding output tile 4 h + e with
//   dims (64 h + 8 g + 2 e, + 1) as its rows g and g + 8 (a row past D is
//   computed, and not stored); B is P^T, (keys 2 t, 2 t + 1 | 2 t + 8, 2 t
//   + 9; row g), the transpose of the S^T accumulators' pairs.
// Head dims 64-128; 256 takes split_staged_kernel.
template <typename T, int ROWS, typename Seqs>
__global__ void __launch_bounds__(Layout<T, Seqs::kDim, ROWS>::WARPS * 32)
split_tc_kernel(const __grid_constant__ SplitParams<Seqs> p) {
  constexpr int D = Seqs::kDim;
  constexpr int kWarps = Layout<T, D, ROWS>::WARPS;
  constexpr int KJ = (D + 31) / 32;   // 16-byte loads of a K / q slice
  constexpr int VH = (D + 63) / 64;   // 16-byte loads of a V slice
  constexpr int MT = 4 * VH;          // output tiles of O^T
  static_assert(kTensorCores<T, ROWS, D>, "5-8 rows, bf16 or fp16");
  static_assert(D <= 128, "head dim 256 takes split_staged_kernel");
  __shared__ float acc_s[kWarps][ROWS][D];
  __shared__ float m_s[kWarps][ROWS], l_s[kWarps][ROWS];

  const int split = blockIdx.x, hk = blockIdx.y, z = blockIdx.z;
  // the combine kernel may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;");
  const auto seq = p.seqs.seq(z, hk);
  const int n_active = active_chunks(seq.kv_hi, p.chunk);
  if (split >= n_active) return;
  const int k_begin = split * p.chunk;
  const int k_end = min(seq.kv_hi, k_begin + p.chunk);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const T* kp = static_cast<const T*>(p.k) + 8 * t;
  const T* vp = static_cast<const T*>(p.v) + 8 * g;
  // whether the lane's j-th K / q load and h-th V load lie inside the head
  const auto k_in = [&](int j) { return 32 * j + 8 * t < D; };
  const auto v_in = [&](int h) { return 64 * h + 8 * g < D; };

  // q row g's slice (the B operand of S^T)
  uint4 qf[KJ];
  {
    const bool real = g < seq.rows;
    const T* q = static_cast<const T*>(p.q) + (real ? seq.row(g) : 0) + 8 * t;
#pragma unroll
    for (int j = 0; j < KJ; ++j)
      qf[j] = real && k_in(j) ? *reinterpret_cast<const uint4*>(q + 32 * j)
                              : make_uint4(0u, 0u, 0u, 0u);
  }
  // rows 2 t and 2 t + 1's limits
  int lim[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    lim[j] = 2 * t + j < seq.rows ? min(seq.lim(2 * t + j), k_end) : k_begin;
  const float qscale = p.scale * kLog2e;

  float o[MT][4], m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[i][x] = 0.f;

  // the warp's K and V slices of the 16 keys from k0 on
  struct Tile {
    uint4 k[2][KJ], v[4][VH];
  };
  // where a tile's keys lie: the 16 keys usually lie in one page, so one
  // table read, a tile ahead of the loads, gives rows D apart
  struct Where {
    long long base;
    bool flat;
  };
  const auto where = [&](int k0) {
    return Where{seq.key(k0), seq.run(k0) >= 16};
  };
  const auto at = [&](int k0, const Where& w, int i) {
    return w.flat ? w.base + (long long)i * D : seq.key(k0 + i);
  };
  const auto issue = [&](Tile& tl, int k0, const Where& w) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = g + 8 * c;
      const bool in = k0 + i < k_end;
      const long long a = in ? at(k0, w, i) : 0;
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        tl.k[c][j] = in && k_in(j) ? load16(kp + a + 32 * j)
                                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 2 * t + (c & 1) + 8 * (c >> 1);
      const bool in = k0 + i < k_end;
      const long long a = in ? at(k0, w, i) : 0;
#pragma unroll
      for (int h = 0; h < VH; ++h)
        tl.v[c][h] = in && v_in(h) ? load16(vp + a + 64 * h)
                                   : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // S^T = K Q^T over the head's k steps, the softmax, O^T += V^T P^T with
  // V's key pairs packed per output tile
  const auto consume = [&](const Tile& tl, int k0) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
#pragma unroll
      for (int w = 0; w < 4; w += 2)
        mma16816<T>(s, word(tl.k[0][j], w), word(tl.k[1][j], w),
                    word(tl.k[0][j], w + 1), word(tl.k[1][j], w + 1),
                    word(qf[j], w), word(qf[j], w + 1));
    }
    uint32_t bh[2], bl[2];
    online_softmax<T, MT>(s, k0, g, lim, qscale, m, l, o, bh, bl);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int h = i / 4, e = i % 4;
      const uint32_t v0 = word(tl.v[0][h], e), v1 = word(tl.v[1][h], e);
      const uint32_t v2 = word(tl.v[2][h], e), v3 = word(tl.v[3][h], e);
      const uint32_t a0 = prmt(v0, v1, 0x5410), a1 = prmt(v0, v1, 0x7632);
      const uint32_t a2 = prmt(v2, v3, 0x5410), a3 = prmt(v2, v3, 0x7632);
      mma16816<T>(o[i], a0, a1, a2, a3, bh[0], bh[1]);
      mma16816<T>(o[i], a0, a1, a2, a3, bl[0], bl[1]);
    }
  };
  // two tiles in registers: the next one's loads are in flight while the
  // current one is used, and the one after's page is being read
  constexpr int kStride = kWarps * 16;
  int k0 = k_begin + warp * 16;
  Tile ta, tb;
  Where w = where(k0 + kStride);
  if (k0 < k_end) issue(ta, k0, where(k0));
  while (k0 < k_end) {
    if (k0 + kStride < k_end) issue(tb, k0 + kStride, w);
    w = where(k0 + 2 * kStride);
    consume(ta, k0);
    k0 += kStride;
    if (k0 >= k_end) break;
    if (k0 + kStride < k_end) issue(ta, k0 + kStride, w);
    w = where(k0 + 2 * kStride);
    consume(tb, k0);
    k0 += kStride;
  }

  // l: this lane's keys, summed over the lanes of its rows
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], off);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int d = 64 * (i / 4) + 8 * g + 2 * (i % 4);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (2 * t + j < ROWS && d < D) {
        acc_s[warp][2 * t + j][d] = o[i][j];
        acc_s[warp][2 * t + j][d + 1] = o[i][2 + j];
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (2 * t + j < ROWS) {
        m_s[warp][2 * t + j] = m[j];
        l_s[warp][2 * t + j] = l[j];
      }
    }
  }
  __syncthreads();
  long long off[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) off[r] = r < seq.rows ? seq.row(r) : 0;
  finish<T, ROWS, kWarps, Seqs>(p, seq, n_active, split, z, hk, off, acc_s,
                                m_s, l_s);
}

// ---- the staged tensor-core body (bf16 / fp16) ---------------------------

// Its shared-memory plan at head dim D: kStages stages of a 64-key K tile
// and V tile, each D / 64 (rounded up) 64-column boxes of 128-byte swizzle
// rows (8 KB a box: 32 KB a tile at 256, 16 KB at 80 and 96, whose
// columns past D TMA fills with zeros), then q's 8 rows (D rounded up to
// 32 elements and a 16-byte pad each), then the barriers, full[] and
// empty[]; the warps' merge (8 warps x 8 rows x D fp32, 64 KB at 256) is
// laid over the ring once every stage has been read.  At 80 and 96 a block
// takes ~100 KB, so two share an SM.
// kGroupWarps consumer warps take a stage, 16 keys each; the kGroups =
// kConsumerWarps / kGroupWarps groups take tiles in turn, tile i stage i %
// kStages.  A stage's tiles go to the groups in turn, so its full barrier
// is one per (stage, group): a group waits only for its own tiles' phases
// there, in order -- with one barrier a stage, a group could wait for a
// phase two ahead of the barrier's, which parity waits cannot tell from
// the phase before.
constexpr int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }
constexpr int kStagedBox = 64 * 128;   // a 64-column box of a 64-key tile
constexpr int kStagedKeys = 64;        // keys of a stage

template <int D>
struct Staged {
  static constexpr int kKeys = kStagedKeys;
  static constexpr int kStages = 3;
  static constexpr int kGroupWarps = kKeys / 16;
  static constexpr int kConsumerWarps = 8;
  static constexpr int kGroups = kConsumerWarps / kGroupWarps;
  static constexpr int kThreads = (kConsumerWarps + 1) * 32;
  static constexpr int kMinBlocks = D == 256 ? 1 : 2;   // blocks an SM
  static constexpr int kBox = kStagedBox;
  static constexpr int kTile = hopper::boxes<D>() * kBox;   // K or V
  static constexpr int kSteps = D / 16;          // k steps, output tiles
  static constexpr int kQPitch = (D + 31) / 32 * 64 + 16;
  static constexpr int kQOffset = kStages * 2 * kTile;
  static constexpr int kBarOffset = kQOffset + 8 * kQPitch;
  // a row of the merge: D floats and 4 of pad, so that a warp's stores
  // (rows 2 t + j, dims 16 i + g) fall in 32 banks
  static constexpr int kMergePitch = D + 4;
  static constexpr int kFull = kStages * kGroups;   // full barriers
  // tiles between two of one (stage, group): the lcm of the two counts
  static constexpr int kCycle = kStages / gcd(kStages, kGroups) * kGroups;
  static constexpr size_t kBytes = 1024 + kBarOffset + 8 * (kFull + kStages);
  static_assert(kConsumerWarps * kMaxRows * kMergePitch * 4 <= kQOffset,
                "the merge fits over the ring");
};

// Byte offset of 16-byte chunk c (dims 8 c .. 8 c + 7) of row r of a
// staged tile: box c / 8, its 128-byte row r, the chunk swizzled by r % 8
// (as TMA's 128-byte swizzle writes it).
__device__ __forceinline__ uint32_t staged_at(int r, int c) {
  return (c >> 3) * kStagedBox + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// ldmatrix: four 8x8 16-bit matrices, lane i giving row i % 8 of matrix i
// / 8; plain (lane (g, t) gets row g, columns 2 t, 2 t + 1) and transposed.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Lane (g, t) of consumer warp w, which takes keys kb = k0 + 16 (w %
// kGroupWarps) .. kb + 15 of each stage its group takes:
// * S^T = K Q^T, D / 16 k steps m16n8k16: A (keys x dims) by one ldmatrix
//   a step from the K tile, B (q row g's dims 16 k + 2 t, + 1 and + 8, +
//   9) in registers for the whole chunk; even and odd steps in two
//   accumulators, so the chain of dependent products is half as long.
// * O^T += V^T P^T, D / 16 output tiles of 16 dims: A (dims x keys) by one
//   ldmatrix.trans a tile from the V tile, output tile i's accumulators
//   (dim 16 i + g | + 8; rows 2 t, 2 t + 1).
// At one row (rows 1-7 of the n8 tile zero and masked) the tensor cores
// do 8x the work needed; they have it to spare, and a key costs a warp
// the same few instructions.  What the one-row steps needed was the
// stream: a block of the CUDA-core body kept its loads in registers, so a
// long sequence's block moved some 25-40 GB/s and set the step's time.
// The producer warp issues a stage's TMA boxes from all its lanes (row box
// b of a tile is lane b's, b + 32 too where pages of fewer than 2 rows
// make 64 boxes), each box's page read a tile ahead.  q's 8 rows go
// through shared memory once, into registers.
template <typename T, int ROWS, typename Seqs>
__global__ void __launch_bounds__(Staged<Seqs::kDim>::kThreads,
                                  Staged<Seqs::kDim>::kMinBlocks)
split_staged_kernel(const __grid_constant__ SplitParams<Seqs> p) {
  using hopper::mbar_arrive;
  using hopper::mbar_wait;
  using hopper::smem_u32;
  constexpr int D = Seqs::kDim;
  using S = Staged<D>;
  constexpr int kWarps = S::kConsumerWarps;
  constexpr int kSteps = S::kSteps;
  static_assert(kStaged<T, ROWS, D>,
                "5-8 rows or one row at head dims 80, 96 and 256; bf16 or "
                "fp16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // full[st * kGroups + g]: stage st's tiles of group g; empty[st]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBarOffset);
  uint64_t* empty = full + S::kFull;
  __shared__ float m_s[kWarps][ROWS], l_s[kWarps][ROWS];

  const int split = blockIdx.x, hk = blockIdx.y, z = blockIdx.z;
  // the combine kernel may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kWarps && lane == 0) {   // the maps, before the first load
    asm volatile("prefetch.tensormap [%0];" ::"l"(&p.k_map) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(&p.v_map) : "memory");
  }
  const auto seq = p.seqs.seq(z, hk);
  const int k_begin = split * p.chunk;
  const int box_rows = p.box_rows, n_boxes = S::kKeys / box_rows;
  // the producer's pages of the first tile, read beside the sequence's
  // metadata: they need the sequence, not its length
  int pg[2] = {0, 0};
  if (warp == kWarps) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (lane + 32 * j < n_boxes)
        pg[j] = seq.page_of(k_begin + (lane + 32 * j) * box_rows);
  }
  const int n_active = active_chunks(seq.kv_hi, p.chunk);
  if (split >= n_active) return;
  const int k_end = min(seq.kv_hi, k_begin + p.chunk);
  const int n_tiles = (k_end - k_begin + S::kKeys - 1) / S::kKeys;

  if (threadIdx.x == 0) {
    for (int b = 0; b < S::kFull; ++b) hopper::mbar_init(&full[b], 1);
    for (int st = 0; st < S::kStages; ++st)
      hopper::mbar_init(&empty[st], S::kGroupWarps * 32);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  float o[kSteps][4], m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int g = lane / 4, t = lane % 4;
  if (warp == kWarps) {  // producer
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % S::kStages, k0 = k_begin + it * S::kKeys;
      const int boxes = min(n_boxes, (k_end - k0 + box_rows - 1) / box_rows);
      // the next tile's pages, in flight while this one's boxes go out
      int nx[2] = {0, 0};
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (lane + 32 * j < n_boxes && it + 1 < n_tiles)
          nx[j] = seq.page_of(k0 + S::kKeys + (lane + 32 * j) * box_rows);
      uint64_t* bar = &full[st * S::kGroups + it % S::kGroups];
      mbar_wait(&empty[st], ((it / S::kStages) & 1) ^ 1);
      if (lane == 0)
        hopper::mbar_arrive_expect_tx(bar, boxes * 2 * S::kTile / n_boxes);
      __syncwarp();
      unsigned char* kt = base + st * 2 * S::kTile;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int b = lane + 32 * j;
        if (b < boxes) {
          const int row = seq.box_row(k0 + b * box_rows, pg[j]);
#pragma unroll
          for (int c = 0; c < hopper::boxes<D>(); ++c) {
            unsigned char* dst = kt + c * S::kBox + b * box_rows * 128;
            hopper::tma_load_2d(dst, &p.k_map, bar, 64 * c, row);
            hopper::tma_load_2d(dst + S::kTile, &p.v_map, bar, 64 * c, row);
          }
        }
        pg[j] = nx[j];
      }
    }
  } else {  // consumers
    const int wq = warp % S::kGroupWarps;
    // q's rows into shared memory (one 16-byte chunk a thread; zeros past
    // the real rows), then row g's fragments for every k step
    unsigned char* q_s = base + S::kQOffset;
    constexpr int kChunks = D / 8;   // 16-byte chunks of a q row
    for (int i = threadIdx.x; i < 8 * kChunks; i += kWarps * 32) {
      const int r = i / kChunks, c = i % kChunks;
      *reinterpret_cast<uint4*>(q_s + r * S::kQPitch + c * 16) =
          r < seq.rows ? *reinterpret_cast<const uint4*>(
                             static_cast<const T*>(p.q) + seq.row(r) + 8 * c)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kWarps * 32) : "memory");
    // two k steps an ldmatrix (at 80 the last one's second step reads the
    // row's pad, unused)
    uint32_t qf[(kSteps + 1) / 2 * 2][2];
#pragma unroll
    for (int j = 0; j < (kSteps + 1) / 2; ++j) {
      uint32_t r4[4];
      ldsm4(r4, smem_u32(q_s) + (lane % 8) * S::kQPitch +
                    (4 * j + lane / 8) * 16);
      qf[2 * j][0] = r4[0];
      qf[2 * j][1] = r4[1];
      qf[2 * j + 1][0] = r4[2];
      qf[2 * j + 1][1] = r4[3];
    }
    int lim[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      lim[j] = 2 * t + j < seq.rows ? min(seq.lim(2 * t + j), k_end)
                                    : k_begin;
    const float qscale = p.scale * kLog2e;
#pragma unroll
    for (int i = 0; i < kSteps; ++i)
#pragma unroll
      for (int x = 0; x < 4; ++x) o[i][x] = 0.f;

    const int grp = warp / S::kGroupWarps;
    for (int it = grp; it < n_tiles; it += S::kGroups) {
      const int st = it % S::kStages;
      const int r0 = 16 * wq, kb = k_begin + it * S::kKeys + r0;
      mbar_wait(&full[st * S::kGroups + grp], (it / S::kCycle) & 1);
      if (kb < k_end) {
        const uint32_t kt = smem_u32(base + st * 2 * S::kTile);
        const uint32_t vt = kt + S::kTile;
        float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
        // lane i's row of the fragment: K keys r0 + 8 ((i / 8) % 2) + i % 8
        // at chunk 2 k + i / 16; V keys r0 + 8 (i / 16) + i % 8 at chunk
        // 2 i' + (i / 8) % 2
        const int kr = r0 + 8 * ((lane / 8) % 2) + lane % 8;
        const int vr = r0 + 8 * (lane / 16) + lane % 8;
#pragma unroll
        for (int k = 0; k < kSteps; ++k) {
          uint32_t a[4];
          ldsm4(a, kt + staged_at(kr, 2 * k + lane / 16));
          if (k % 2)
            mma16816<T>(sb, a[0], a[1], a[2], a[3], qf[k][0], qf[k][1]);
          else
            mma16816<T>(sa, a[0], a[1], a[2], a[3], qf[k][0], qf[k][1]);
        }
        float s[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) s[x] = sa[x] + sb[x];
        uint32_t bh[2], bl[2];
        online_softmax<T, kSteps>(s, kb, g, lim, qscale, m, l, o, bh, bl);
        // V's keys past the chunk's end as 0: a register holds keys
        // kb + 2 t, + 1 (a[0], a[1]) or kb + 2 t + 8, + 9 (a[2], a[3])
        const uint32_t m01 = (kb + 2 * t < k_end ? 0xffffu : 0u) |
                             (kb + 2 * t + 1 < k_end ? 0xffff0000u : 0u);
        const uint32_t m23 = (kb + 2 * t + 8 < k_end ? 0xffffu : 0u) |
                             (kb + 2 * t + 9 < k_end ? 0xffff0000u : 0u);
#pragma unroll
        for (int i = 0; i < kSteps; ++i) {
          uint32_t a[4];
          ldsm4_t(a, vt + staged_at(vr, 2 * i + (lane / 8) % 2));
          a[0] &= m01;
          a[1] &= m01;
          a[2] &= m23;
          a[3] &= m23;
          mma16816<T>(o[i], a[0], a[1], a[2], a[3], bh[0], bh[1]);
          mma16816<T>(o[i], a[0], a[1], a[2], a[3], bl[0], bl[1]);
        }
      }
      mbar_arrive(&empty[st]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l[j] += __shfl_xor_sync(0xffffffffu, l[j], off);
  }
  // every stage has been read: the merge goes over the ring
  __syncthreads();
  auto& acc_s =
      *reinterpret_cast<float (*)[kWarps][ROWS][S::kMergePitch]>(base);
  if (warp == kWarps) return;   // the consumers' threads merge
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (2 * t + j < ROWS) {
        acc_s[warp][2 * t + j][16 * i + g] = o[i][j];
        acc_s[warp][2 * t + j][16 * i + g + 8] = o[i][2 + j];
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (2 * t + j < ROWS) {
        m_s[warp][2 * t + j] = m[j];
        l_s[warp][2 * t + j] = l[j];
      }
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kWarps * 32) : "memory");
  // the warps' weights 2^(m_w - m), one thread a row (every thread read
  // them all in the register bodies' merge: 2 loads and an ex2 per warp,
  // row and dim), then each thread's dims summed in warp order
  __shared__ float c_s[ROWS][kWarps], mm_s[ROWS], ll_s[ROWS];
  if (threadIdx.x < seq.rows) {
    const int r = threadIdx.x;
    float mm = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_s[w][r]);
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = ex2(m_s[w][r] - mm);
      c_s[r][w] = c;
      ll = fmaf(l_s[w][r], c, ll);
    }
    mm_s[r] = mm;
    ll_s[r] = ll;
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kWarps * 32) : "memory");
  const long long zhk = (long long)z * p.Hkv + hk;
  for (int d = threadIdx.x; d < D; d += kWarps * 32) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= seq.rows) break;
      float aa = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        aa = fmaf(acc_s[w][r][d], c_s[r][w], aa);
      if (n_active == 1) {
        static_cast<T*>(p.o)[seq.row(r) + d] =
            from_f<T>(aa / fmaxf(ll_s[r], 1e-30f));
      } else {
        const long long at = (zhk * p.n_split + split) * ROWS + r;
        p.part[at * (D + 2) + d] = aa;
        if (d == 0) {
          p.part[at * (D + 2) + D] = mm_s[r];
          p.part[at * (D + 2) + D + 1] = ll_s[r];
        }
      }
    }
  }
}

// Merges the chunks of every sequence that spans more than one, in chunk
// order: grid (Hkv, Z, kCombineRowBlocks), thread d owns dim d of every
// row of its block.  One block for all rows: the loops are unrolled so
// that a row's loads are in flight together.  One block a row (after the
// staged body): the sequence's metadata is read before the chunks' grid
// ends (it is the caller's, not theirs), and the row's (m, l, acc[d]) of
// up to kCombineBatch chunks are loaded at once, then summed in chunk
// order as in the other form -- one round trip to L2 where the loops took
// one a row per 8 chunks, twice.
constexpr int kCombineBatch = 32;

template <typename T, int ROWS, typename Seqs>
__global__ void __launch_bounds__(Seqs::kDim)
combine_kernel(const __grid_constant__ SplitParams<Seqs> p) {
  constexpr int D = Seqs::kDim;
  constexpr long long step = (long long)ROWS * (D + 2);   // chunk to chunk
  const int hk = blockIdx.x, z = blockIdx.y, d = threadIdx.x;
  const long long zhk = (long long)z * p.Hkv + hk;
  if constexpr (kCombineRowBlocks<T, ROWS, D> == 1) {
    asm volatile("griddepcontrol.wait;" ::: "memory");   // the chunks' results
    const auto seq = p.seqs.seq(z, hk);
    const int n_active = active_chunks(seq.kv_hi, p.chunk);
    if (n_active == 1) return;                     // finished by its block
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= seq.rows) break;
      const float* row = p.part + (zhk * p.n_split * ROWS + r) * (D + 2);
      float mm = kNeg;
#pragma unroll 8
      for (int c = 0; c < n_active; ++c) mm = fmaxf(mm, row[c * step + D]);
      float ll = 0.f, aa = 0.f;
#pragma unroll 8
      for (int c = 0; c < n_active; ++c) {
        const float w = ex2(row[c * step + D] - mm);
        ll = fmaf(row[c * step + D + 1], w, ll);
        aa = fmaf(row[c * step + d], w, aa);
      }
      static_cast<T*>(p.o)[seq.row(r) + d] =
          from_f<T>(aa / fmaxf(ll, 1e-30f));
    }
  } else {
    const auto seq = p.seqs.seq(z, hk);
    asm volatile("griddepcontrol.wait;" ::: "memory");   // the chunks' results
    const int n_active = active_chunks(seq.kv_hi, p.chunk);
    const int r = blockIdx.z;
    if (n_active == 1 || r >= seq.rows) return;
    const float* row = p.part + (zhk * p.n_split * ROWS + r) * (D + 2);
    float mm = kNeg, ll = 0.f, aa = 0.f;
    if (n_active <= kCombineBatch) {
      float mv[kCombineBatch], lv[kCombineBatch], av[kCombineBatch];
#pragma unroll
      for (int c = 0; c < kCombineBatch; ++c) {
        if (c < n_active) {
          mv[c] = row[c * step + D];
          lv[c] = row[c * step + D + 1];
          av[c] = row[c * step + d];
        }
      }
#pragma unroll
      for (int c = 0; c < kCombineBatch; ++c)
        if (c < n_active) mm = fmaxf(mm, mv[c]);
#pragma unroll
      for (int c = 0; c < kCombineBatch; ++c) {
        if (c < n_active) {
          const float w = ex2(mv[c] - mm);
          ll = fmaf(lv[c], w, ll);
          aa = fmaf(av[c], w, aa);
        }
      }
    } else {
#pragma unroll 8
      for (int c = 0; c < n_active; ++c) mm = fmaxf(mm, row[c * step + D]);
#pragma unroll 8
      for (int c = 0; c < n_active; ++c) {
        const float w = ex2(row[c * step + D] - mm);
        ll = fmaf(row[c * step + D + 1], w, ll);
        aa = fmaf(row[c * step + d], w, aa);
      }
    }
    static_cast<T*>(p.o)[seq.row(r) + d] = from_f<T>(aa / fmaxf(ll, 1e-30f));
  }
}

// The split kernel of ROWS rows of T, its threads and its dynamic shared
// memory: the staged body, the tensor-core body or the CUDA-core one.
template <typename T, int ROWS, typename Seqs>
constexpr auto split_form() {
  if constexpr (kStaged<T, ROWS, Seqs::kDim>)
    return split_staged_kernel<T, ROWS, Seqs>;
  else if constexpr (kTensorCores<T, ROWS, Seqs::kDim>)
    return split_tc_kernel<T, ROWS, Seqs>;
  else
    return split_kernel<T, ROWS, Seqs>;
}
// (Staged<D> is named only where the staged body runs: it has no D = 16.)
template <typename T, int ROWS, typename Seqs>
constexpr int split_threads() {
  if constexpr (kStaged<T, ROWS, Seqs::kDim>)
    return Staged<Seqs::kDim>::kThreads;
  else
    return Layout<T, Seqs::kDim, ROWS>::WARPS * 32;
}
template <typename T, int ROWS, typename Seqs>
constexpr size_t split_smem() {
  if constexpr (kStaged<T, ROWS, Seqs::kDim>)
    return Staged<Seqs::kDim>::kBytes;
  else
    return 0;
}

// Lets the split kernel take its dynamic shared memory: once per
// instantiation, at its first launch or occupancy query (before any graph
// capture can be running).
template <typename T, int ROWS, typename Seqs>
cudaError_t split_smem_attr() {
  if constexpr (split_smem<T, ROWS, Seqs>() == 0) {
    return cudaSuccess;
  } else {
    static const cudaError_t e = cudaFuncSetAttribute(
        split_form<T, ROWS, Seqs>(),
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)split_smem<T, ROWS, Seqs>());
    return e;
  }
}

// The split kernel over Z sequences, then, when a sequence may span
// several chunks, the combine kernel launched early.
template <typename T, int ROWS, typename Seqs>
int launch_split(const SplitParams<Seqs>& p, int Z, cudaStream_t stream) {
  const dim3 grid(p.n_split, p.Hkv, Z);
  // over short chunks (a generate step's cache) one row takes the
  // CUDA-core body, 5-8 rows at 80 and 96 the register tensor-core body
  bool cuda_cores = false, registers = false;
  if constexpr (kStaged<T, ROWS, Seqs::kDim> && ROWS == 1)
    cuda_cores = p.chunk < kStagedOneRowKeys;
  if constexpr (kStaged<T, ROWS, Seqs::kDim> && ROWS > 4 &&
                Seqs::kDim <= 128)
    registers = p.chunk < kStagedRowsKeys;
  if constexpr (kStaged<T, ROWS, Seqs::kDim>) {
    if (cuda_cores) {
      if constexpr (ROWS == 1)
        split_kernel<T, ROWS, Seqs>
            <<<grid, Layout<T, Seqs::kDim, ROWS>::WARPS * 32, 0, stream>>>(
                p);
    } else if (registers) {
      if constexpr (ROWS > 4 && Seqs::kDim <= 128)
        split_tc_kernel<T, ROWS, Seqs>
            <<<grid, Layout<T, Seqs::kDim, ROWS>::WARPS * 32, 0, stream>>>(
                p);
    } else {
      // the tensor maps of K and V, made at every launch (they travel by
      // value in the parameters, so a graph capture keeps them)
      SplitParams<Seqs> ps = p;
      const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Seqs::kDim),
                                  static_cast<cuuint64_t>(p.kv_rows)};
      const cuuint64_t strides[1] = {Seqs::kDim * sizeof(T)};
      const cuuint32_t box[2] = {hopper::kBoxCols,
                                 static_cast<cuuint32_t>(p.box_rows)};
      using S = Staged<Seqs::kDim>;
      if (p.box_rows < 1 || S::kKeys % p.box_rows != 0)
        return (int)cudaErrorInvalidValue;
      int rc = hopper::make_map<T>(&ps.k_map, p.k, 2, dims, strides, box);
      if (!rc)
        rc = hopper::make_map<T>(&ps.v_map, p.v, 2, dims, strides, box);
      if (rc) return rc;
      const cudaError_t attr = split_smem_attr<T, ROWS, Seqs>();
      if (attr != cudaSuccess) return (int)attr;
      split_staged_kernel<T, ROWS, Seqs>
          <<<grid, S::kThreads, S::kBytes, stream>>>(ps);
    }
  } else if constexpr (kTensorCores<T, ROWS, Seqs::kDim>) {
    split_tc_kernel<T, ROWS, Seqs>
        <<<grid, split_threads<T, ROWS, Seqs>(), 0, stream>>>(p);
  } else {
    split_kernel<T, ROWS, Seqs>
        <<<grid, split_threads<T, ROWS, Seqs>(), 0, stream>>>(p);
  }
  if (p.n_split > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    // programmatic dependent launch: the combine is scheduled while the
    // chunks' blocks run and waits for their results in griddepcontrol.wait
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.Hkv, Z, kCombineRowBlocks<T, ROWS, Seqs::kDim>);
    cfg.blockDim = dim3(Seqs::kDim);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t c =
        cudaLaunchKernelEx(&cfg, combine_kernel<T, ROWS, Seqs>, p);
    if (c != cudaSuccess) return (int)c;
  }
  return (int)cudaGetLastError();
}

// Runs ``f(std::integral_constant<int, rows>)`` for rows 1..kMaxRows.
template <typename F>
int with_rows(int rows, F&& f) {
  switch (rows) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
  }
  return -(int)cudaErrorInvalidValue;
}

template <typename T, typename Seqs>
int launch_rows(const SplitParams<Seqs>& p, int Z, int rows,
                cudaStream_t stream) {
  return with_rows(rows, [&](auto r) {
    return launch_split<T, decltype(r)::value, Seqs>(p, Z, stream);
  });
}

// Blocks of the split kernel the current card holds at once (SMs times
// blocks per SM), or a negative CUDA error.
template <typename T, typename Seqs>
int split_slots(int rows) {
  return with_rows(rows, [](auto r) {
    constexpr int R = decltype(r)::value;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = split_smem_attr<T, R, Seqs>();
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, split_form<T, R, Seqs>(), split_threads<T, R, Seqs>(),
          split_smem<T, R, Seqs>());
    return e == cudaSuccess ? sms * per_sm : -(int)e;
  });
}

// Runs ``f(std::integral_constant<int, D>)`` for head dims 16, 64, 80, 96,
// 128 and 256, the ones both serving kernels are instantiated at (16 on
// the CUDA-core bodies only); a negative CUDA error for any other.
template <typename F>
int with_head_dim(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
  }
  return -(int)cudaErrorInvalidValue;
}

// Whether with_head_dim has an instantiation at head dim D.
inline bool head_dim_taken(int D) {
  return with_head_dim(D, [](auto) { return 0; }) == 0;
}

}  // namespace dsdecode
