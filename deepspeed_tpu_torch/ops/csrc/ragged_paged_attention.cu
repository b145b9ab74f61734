// Ragged paged attention for Hopper (sm_90a): decode, prefill and mixed
// ragged batches over a paged KV cache, in one call.
//
// Replaces the TPU kernel
// deepspeed_tpu/ops/pallas/ragged_paged_attention.py: _ragged_kernel
// (host side _ragged_call / _pack_metadata).  Computes, for each sequence
// s, the causal attention of its last q_lens[s] tokens over its ctx_lens[s]
// cached tokens (queries included), with K/V pages [P, Hkv, page, D] read
// in place through block_tables[s].  The queries are a packed, unpadded
// [total_q, H, D] stack; sequence s's rows start at q_offs[s].  Rows that
// see no key give 0.
//
// What bounds it on the H100: a decode row reads its sequence's K/V pages
// once for ~1 flop per byte -- HBM bandwidth (3.35 TB/s) is the bound; a
// prefill tile of 128 query rows does 512 flops per K/V byte it reads and
// is bounded by the tensor cores, as the flash forward is.
//
// The TPU kernel serves both with one tile shape, q_tile tokens of one
// sequence by its kv head's group; here the host (ops/cuda/
// ragged_paged_attention.py plan_launch) splits a call's sequences by
// form, and one C call launches one kernel (or two) per form present:
//
// Decode rows (q_len * group <= 8 rows per kv head: every serving decode
// step, a speculative verify window of up to 8 tokens at group 1, a GQA
// group of up to 8 heads; head dim 16, 64, 80, 96, 128 or 256): the split-key,
// memory-parallel body of split_decode.cuh, shared with decode_attention.cu,
// over the decode sequences' list; a key's row is resolved through the
// block table as it is loaded (PagedSeqs), so shared prefix pages and
// partial last pages are read in place, at any page size.  A page of 128
// keys is 32 KB contiguous per kv head at D = 128, so at the serving
// engine's page a warp's key group lies in one page.
//
// Prefill tiles, bf16 or fp16, head dim 64, 80, 96, 128 or 256, a group
// dividing 64 and a page size that is a multiple of the K/V tile's keys
// (128; 64 at D = 256) or a multiple of 8 dividing them (the serving
// engine's page 128 among them; a tile is
// hopper::boxes<D>() 64-column boxes of 128-byte swizzle rows, so the same
// boxes hold at every head dim): the flash forward's pipeline
// (flash_attention_fwd.cu, hopper.cuh).  One block of three warpgroups per
// (128-row tile, kv head): the tile is 128 / group tokens of one sequence
// by the group's heads, so a kv head's group shares every K/V tile.  A
// producer warp loads the Q tile by TMA straight from the packed stack --
// a 3-d tensor map (column, head, token) with row stride H * D, a box of
// 64 rows (64 / group tokens by group heads) per consumer warpgroup and
// column box -- and streams K and V tiles through a ring (4 stages at D =
// 64, 3 at 80 and 96, 2 at 128 and 256), each tile's TMA row coordinate
// resolved through the block table, (page * Hkv + hk) * page_size +
// offset over k_pages viewed as [P * Hkv * page, D]: boxes<D>() column
// boxes per tile, or per page when pages are smaller than the tile.  At
// D = 80 and 96 (GPT-3 2.7B's and Phi-3-mini's heads) the second box
// reaches past D: TMA reads the D columns there are (rows of 160 or 192
// bytes) and zero-fills the rest, and every transaction count is of whole
// boxes, so a tile costs D = 128's 32 KB of shared memory but D columns of
// HBM traffic.  Two consumer warpgroups own 64 rows each: S = Q K^T by
// wgmma, the online softmax on the accumulators, P rounded to the tile's
// type as the A operand of O += P V (S over D / 16 slices, O += P V one
// m64nD product a 16-key slice, which reads V's first D columns only).
// At D = 128 each warpgroup runs the three in series, the two
// warpgroups in step.  At D = 64, 80, 96 and 256 the consumer is the
// flash forward's (wgmma_attention.cuh): at 64, 80 and 96 in FA3's order
// (each tile's softmax under the products of the tile before), at 256
// each tile in series; at all four the two warpgroups take turns to issue
// their products, so one's softmax runs under the other's products.  At
// D = 256 (Gemma's heads) a 128-row tile is 64 KB, so Q and two stages of
// 128-key K and V tiles would need 320 KB of the 227 KB a block has, and
// O alone is 128 fp32 registers a thread, which beside a 128-key S (64)
// and its P (32) exceeds the consumers' 240: the K/V tiles are 64 keys
// there (Q + 2 x (K, V) = 192 KB; S = Q K^T an m64n64 product over 16 k
// steps across Q's four boxes, 32 registers, P 16, O += P V one m64n256
// product a 16-key slice across V's four boxes).  Public FA3 takes 80-key
// tiles at this head dim, for the same reasons.  In fp16 P is rounded
// once at every head dim, as SDPA rounds it: the body before entered it
// as two fp16 terms at 256 (O one rounding of an fp32 value, at 1.19-1.27x
// the time on the consumer), and with P rounded once the fp16 rule holds
// within 1.09x SDPA's error at every case of chip_smoke.py.
// What bounds the tiles on the H100 (NVIDIA H100 80GB HBM3, 700 W;
// scripts/decode_kernel_ab.py --prefill, PERF.md): a block of the
// serving phases' prefills costs ~4-7 us before and after its walk and
// ~2 us a K/V tile in it, so a call lasts as long as its heaviest
// blocks (the causal tiles at the end of a prompt); the consumer took
// the serve run's bucket-512 prefill at D = 80 from 0.0138 to 0.0122 ms,
// and Gemma-7B's at 256 from 0.0221 to 0.0212 (fp16 0.0264 -> 0.0213).
// Splitting the longest walks over the idle SMs (their parts merged by a
// second kernel) did not pay: the blocks slowed as more of them streamed
// tiles at once (Gemma-7B's bucket 512 cut into 128 units of at most 3
// tiles took 21 us, 64 of those units alone 15 us, the 64 whole walks of
// up to 8 tiles 20 us), and the merge cost 3-15 us more.  A TinyLlama-shaped
// 256-token chunk (group 8) is 64 blocks of at most 6 K/V tiles each: it
// fills 64 of the 132 SMs; its bound is the tensor cores' 1.4 us.  bf16
// and fp16 run one body, templated on the element type E: every wgmma,
// tensor map and packing names E (hopper.cuh has no default), so no fp16
// tile is read as bf16.  The key loop stops at the tile's causal frontier
// ctx - qlen + min(qlen, (qt + 1) * tokens); only tiles that cross a
// row's position are masked, and a warpgroup skips a tile it cannot see.
// Rows past qlen may arrive in the Q box (TMA moves whole boxes; past the
// stack they are zero-filled) but feed no real row and are never
// written.  Tiles with the most keys are launched first (the host's
// order).
//
// Prefill tiles otherwise (fp32, other page sizes or groups, head dim 16
// in every dtype; every head dim above): the CUDA-core tile of
// attention_tile.cuh, grid (tiles, Hkv, 16-row chunks of the tile's
// q_tile * group rows), keys staged through fp32 shared
// memory, each key's page resolved through the block table as it is
// loaded.  fp32 keeps it for the 1e-4 checks; the selection is by dtype
// and shape.
#include "hopper.cuh"
#include "split_decode.cuh"
#include "wgmma_attention.cuh"

namespace {

using dsattn::kNeg;

// ---- decode rows: split_decode.cuh over the paged cache -----------------

template <int D>
struct PagedSeqs {
  static constexpr int kDim = D;
  const int* ctx;       // [B] tokens stored, queries included
  const int* q_lens;    // [B]
  const int* q_offs;    // [B] first row of each sequence in q
  const int* seqs;      // [Z] the sequences of the decode form
  const int* tables;    // [B, max_pages]
  int max_pages, page, H, Hkv;
  struct Seq {
    const int* table;
    long long q_base;
    int kv_hi, rows, first_q, H, group, hk, max_pages, page, Hkv;
    __device__ __forceinline__ long long row(int r) const {
      return q_base + ((long long)(r / group) * H + hk * group + r % group) *
                          D;
    }
    __device__ __forceinline__ int lim(int r) const {
      return first_q + r / group + 1;   // keys < lim: kpos <= qpos
    }
    __device__ __forceinline__ long long key(int k) const {
      const long long pg = __ldg(table + min(k / page, max_pages - 1));
      return ((pg * Hkv + hk) * page + k % page) * D;
    }
    __device__ __forceinline__ int run(int k) const { return page - k % page; }
    // the staged body's rows: key k of page pg is row (pg Hkv + hk) page +
    // k % page of [P Hkv page, D]; the page read needs only the sequence
    __device__ __forceinline__ int page_of(int k) const {
      return __ldg(table + min(k / page, max_pages - 1));
    }
    __device__ __forceinline__ int box_row(int k, int pg) const {
      return (pg * Hkv + hk) * page + k % page;
    }
  };
  __device__ __forceinline__ Seq seq(int z, int hk) const {
    const int s = seqs[z], c = ctx[s], ql = q_lens[s];
    const int group = H / Hkv;
    return Seq{tables + (long long)s * max_pages,
               (long long)q_offs[s] * H * D,
               max(0, min(c, max_pages * page)), ql * group, c - ql, H, group,
               hk, max_pages, page, Hkv};
  }
};

// The decode form's launches at head dim D.
template <int D>
int launch_decode(const void* q, const void* k_pages, const void* v_pages,
                  void* o, const int* c, const int* ql, const int* qo,
                  const int* tb, const void* dec_seqs, void* part, int n_dec,
                  int dec_rows, int n_split, int chunk, int max_pages,
                  int page_size, int P, int H, int Hkv, int dtype,
                  float scale, cudaStream_t s) {
  dsdecode::SplitParams<PagedSeqs<D>> p = {};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.o = o;
  p.part = static_cast<float*>(part);
  p.seqs = PagedSeqs<D>{c, ql, qo, static_cast<const int*>(dec_seqs), tb,
                        max_pages, page_size, H, Hkv};
  p.Hkv = Hkv;
  p.n_split = n_split;
  p.chunk = chunk;
  p.scale = scale;
  // the staged body's boxes: rows of one page, at most a tile's
  p.kv_rows = (long long)P * Hkv * page_size;
  const int low = page_size & -page_size;   // its largest power-of-2 factor
  constexpr int kTileKeys = dsdecode::kStagedKeys;
  p.box_rows = low < kTileKeys ? low : kTileKeys;
  return dtype == 0   ? dsdecode::launch_rows<float>(p, n_dec, dec_rows, s)
         : dtype == 1 ? dsdecode::launch_rows<__nv_bfloat16>(p, n_dec,
                                                             dec_rows, s)
                      : dsdecode::launch_rows<__half>(p, n_dec, dec_rows, s);
}

// ---- prefill tiles, bf16 / fp16: tensor cores fed by TMA ----------------

namespace tc {
constexpr int BM = 128;                              // rows of a tile
constexpr int kThreads = 384;                        // 2 consumer + 1 producer WG
// The ring at head dims 80 and 96: one Q tile and 3 stages of 32 KB K and
// V tiles (224 KB), as the flash forward's at those head dims.
constexpr int kStages8096 = 3;
// The shared-memory plan at head dim D: Q, then kStages x (K, V), then the
// barriers: Q's, full[], empty[].  A tile is whole 64-column boxes; the
// K/V tiles are dswg::tile_keys(D) keys: 128, 64 at D = 256 (the header
// says why).
template <int D>
struct Smem {
  static constexpr int kKeys = dswg::tile_keys(D);   // keys of a K/V tile
  // 16 KB at D = 64, 32 at 80, 96 and 128, 64 at 256
  static constexpr int kQTile = BM * hopper::box_cols<D>() * 2;
  static constexpr int kTile = kKeys * hopper::box_cols<D>() * 2;  // K or V
  static constexpr int kQBox = BM * 128;              // a box of Q
  static constexpr int kKVBox = kKeys * 128;          // a box of K or V
  static constexpr int kStages =
      D == 64 ? 4 : (D == 80 || D == 96) ? kStages8096 : 2;
  static constexpr int kBarOffset = kQTile + kStages * 2 * kTile;
  static constexpr size_t kBytes = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
  static_assert(kBytes <= 232448, "a block has 227 KB of shared memory");
};
}  // namespace tc

// What a consumer thread's two rows see, for the shared consumer of
// wgmma_attention.cuh: keys up to the row's position, masked only on tiles
// of kKeys keys that cross the warpgroup's first row's; logits are the raw
// products (the scale goes into c).
template <int kKeys>
struct PagedRows {
  float c;
  int qpos[2], front;   // front: the position of the warpgroup's first row
  __device__ __forceinline__ bool edge(int k0) const {
    return k0 + kKeys - 1 > front;
  }
  __device__ __forceinline__ bool keep(int key, int r) const {
    return key <= qpos[r];
  }
  __device__ __forceinline__ float key_base(int) const { return 0.f; }
  __device__ __forceinline__ float logit(float s, int, float) const {
    return s;
  }
};

struct PrefillParams {
  CUtensorMap q_map, k_map, v_map;
  void* o;                                        // E [total_q, H, D]
  const int* ctx;
  const int* q_lens;
  const int* q_offs;
  const int* tables;
  const int* seq_of_tile;
  const int* qtile_of_tile;
  int max_pages, page, box_rows, H, Hkv;
  float scale;
};

template <typename E, int D>
__global__ void __launch_bounds__(tc::kThreads, 1)
ragged_prefill_tc_kernel(const __grid_constant__ PrefillParams p) {
  using namespace hopper;
  using namespace tc;
  constexpr int kTile = Smem<D>::kTile, kStages = Smem<D>::kStages;
  constexpr int kQTile = Smem<D>::kQTile, kKeys = Smem<D>::kKeys;
  constexpr int kQBox = Smem<D>::kQBox, kKVBox = Smem<D>::kKVBox;
  constexpr int kBarOffset = Smem<D>::kBarOffset;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = base;
  unsigned char* kv_s = base + kQTile;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(base + kBarOffset);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kStages;

  const int tile = blockIdx.x, hk = blockIdx.y;
  const int group = p.H / p.Hkv, tokens = BM / group;
  const int s = p.seq_of_tile[tile], qt = p.qtile_of_tile[tile];
  const int ctx = p.ctx[s], qlen = p.q_lens[s], qoff = p.q_offs[s];
  const int t0 = qt * tokens;                     // the tile's first token
  const int first_q = ctx - qlen;                 // position of token 0
  int kv_hi = first_q + min(qlen, t0 + tokens);   // the causal frontier
  kv_hi = max(0, min(kv_hi, p.max_pages * p.page));
  const int n_tiles = (kv_hi + kKeys - 1) / kKeys;
  const int* table = p.tables + (long long)s * p.max_pages;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 256);   // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    regs_dealloc<24>();
    if (t == 0) {
      // Q: one box of 64 rows (64 / group tokens x group heads) per
      // consumer warpgroup and 64 columns; the transaction counts whole
      // boxes, the columns TMA zero-fills past D included
      mbar_arrive_expect_tx(q_bar, kQTile);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < boxes<D>(); ++c)
          tma_load_3d(q_s + c * kQBox + w * 64 * 128, &p.q_map, q_bar,
                      c * kBoxCols, hk * group, qoff + t0 + w * 64 / group);
      const int per = kKeys / p.box_rows;       // boxes per K or V tile
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        unsigned char* k_t = kv_s + st * 2 * kTile;
        mbar_arrive_expect_tx(&full[st], 2 * kTile);
        for (int j = 0; j < per; ++j) {
          const int key = it * kKeys + j * p.box_rows;
          const int pg = __ldg(table + min(key / p.page, p.max_pages - 1));
          const int row = (pg * p.Hkv + hk) * p.page + key % p.page;
          for (int c = 0; c < boxes<D>(); ++c) {
            unsigned char* dst = k_t + c * kKVBox + j * p.box_rows * 128;
            tma_load_2d(dst, &p.k_map, &full[st], c * kBoxCols, row);
            tma_load_2d(dst + kTile, &p.v_map, &full[st], c * kBoxCols, row);
          }
        }
      }
    }
  } else {  // consumers: warpgroup wg owns tile rows 64 wg .. 64 wg + 63
    regs_alloc<240>();
    // row r of the tile is token t0 + r / group, head hk * group + r % group
    const int tok_first = t0 + 64 * wg / group;
    const int tok_last = min(tok_first + 64 / group, qlen) - 1;
    const int row0 = acc_row(0, t);               // and row0 + 8
    int tok[2], qpos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tok[r] = t0 + (64 * wg + row0 + 8 * r) / group;
      qpos[r] = first_q + tok[r];
    }
    const float scale = p.scale;
    const uint32_t q_addr = smem_u32(q_s) + 64 * wg * 128;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};   // l: this lane's share

    mbar_wait(q_bar, 0);
    if constexpr (D == 128) {
      // S, the softmax and P V in series in each warpgroup, the two
      // warpgroups in step (the products are long enough at this head dim)
      constexpr int kS = kKeys / 2;
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages, k0 = it * kKeys;
        // no real row (tok_last < tok_first) or every key past the last one
        const bool unseen = tok_last < tok_first || k0 > first_q + tok_last;
        mbar_wait(&full[st], (it / kStages) & 1);
        if (!unseen) {
          const uint32_t k_addr = smem_u32(kv_s) + st * 2 * kTile;
          const uint32_t v_addr = k_addr + kTile;
          float sc[kS];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint64_t qd = desc_kmajor(q_addr + kslice(kk, kQBox));
            const uint64_t kd = desc_kmajor(k_addr + kslice(kk, kKVBox));
            wgmma_ss_n128<E>(sc, qd, kd, kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);

          const bool edge = k0 + kKeys - 1 > first_q + tok_first;
          float mx[2] = {kNeg, kNeg};
#pragma unroll
          for (int i = 0; i < kS; ++i) {
            const int r = (i / 2) % 2;
            float x = __fmul_rn(sc[i], scale);
            if (edge && k0 + acc_col(i, t) > qpos[r]) x = kNeg;
            sc[i] = x;
            mx[r] = fmaxf(mx[r], x);
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
            const float pr = ex2(fmaf(sc[i], kLog2e, -ml[r]));
            l[r] += pr;
            sc[i] = pr;
          }
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];
          uint32_t pa[kS / 2];
          acc_to_a<E>(sc, pa);
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
    } else {
      // the shared consumer: the tiles this warpgroup sees, every key up
      // to its last row's; at 64, 80 and 96 in FA3's order, at 256 each
      // tile in series (FA3's order spilled there in the flash forward),
      // turns for the products at every head dim
      const int last = tok_last < tok_first ? 0 :
          min(n_tiles, (first_q + tok_last) / kKeys + 1);
      const PagedRows<kKeys> rows{scale * kLog2e, {qpos[0], qpos[1]},
                                  first_q + tok_first};
      dswg::first_turn(wg);
      dswg::attend_tiles<E, D, kStages, kTile, D != 256>(
          rows, q_addr, smem_u32(kv_s), full, empty, 0, n_tiles, 0, last, 0,
          t, o, m, l);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (tok[r] >= qlen) continue;
      const int g = (64 * wg + row0 + 8 * r) % group;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      uint32_t* orow = reinterpret_cast<uint32_t*>(
          static_cast<E*>(p.o) +
          (((long long)qoff + tok[r]) * p.H + hk * group + g) * D);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        orow[(8 * j + 2 * (t % 4)) / 2] =
            pack2<E>(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <typename E, int D>
int launch_prefill_tc(PrefillParams& p, const void* q, const void* kp,
                      const void* vp, int n_tiles, int total_q, int P,
                      cudaStream_t stream) {
  const int group = p.H / p.Hkv;
  // q as (column, head, token); pages as (column, row of [P*Hkv*page])
  const cuuint64_t row = D * sizeof(E);
  const cuuint64_t q_dims[3] = {D, static_cast<cuuint64_t>(p.H),
                                static_cast<cuuint64_t>(total_q)};
  const cuuint64_t q_strides[2] = {row, row * p.H};
  const cuuint32_t q_box[3] = {hopper::kBoxCols,
                               static_cast<cuuint32_t>(group),
                               static_cast<cuuint32_t>(64 / group)};
  const cuuint64_t kv_dims[2] = {
      D, static_cast<cuuint64_t>(P) * p.Hkv * p.page};
  const cuuint64_t kv_strides[1] = {row};
  const cuuint32_t kv_box[2] = {hopper::kBoxCols,
                                static_cast<cuuint32_t>(p.box_rows)};
  const auto map = hopper::make_map<E>;
  int rc = map(&p.q_map, q, 3, q_dims, q_strides, q_box);
  if (!rc) rc = map(&p.k_map, kp, 2, kv_dims, kv_strides, kv_box);
  if (!rc) rc = map(&p.v_map, vp, 2, kv_dims, kv_strides, kv_box);
  if (rc) return rc;
  constexpr size_t smem = tc::Smem<D>::kBytes;
  // once per instantiation, before any graph capture can be running
  static const cudaError_t attr = cudaFuncSetAttribute(
      ragged_prefill_tc_kernel<E, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  ragged_prefill_tc_kernel<E, D><<<dim3(n_tiles, p.Hkv), tc::kThreads, smem,
                                   stream>>>(p);
  return (int)cudaGetLastError();
}

// ---- prefill tiles otherwise: CUDA cores --------------------------------

struct PagedKeys {
  const int* table;   // block_tables row of the sequence
  int max_pages, page_size, hk, Hkv, d;
  __device__ __forceinline__ long long operator()(int key) const {
    const int col = min(key / page_size, max_pages - 1);
    const long long page = table[col];
    return ((page * Hkv + hk) * page_size + key % page_size) * d;
  }
};

template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(dsattn::kThreads)
ragged_paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, T* __restrict__ o,
    const int* __restrict__ ctx_lens, const int* __restrict__ q_lens,
    const int* __restrict__ q_offs, const int* __restrict__ seq_of_tile,
    const int* __restrict__ qtile_of_tile, const int* __restrict__ tables,
    int max_pages, int H, int Hkv, int page_size, int q_tile, float scale) {
  using namespace dsattn;
  __shared__ RowMeta<ROWS> rm;
  const int tile = blockIdx.x, hk = blockIdx.y, chunk = blockIdx.z;
  const int group = H / Hkv;
  const int s = seq_of_tile[tile], qt = qtile_of_tile[tile];
  const int ctx = ctx_lens[s], qlen = q_lens[s], qoff = q_offs[s];
  const int tile_rows = q_tile * group;
  if (threadIdx.x < ROWS) {
    const int r = chunk * ROWS + threadIdx.x;
    const int local_t = qt * q_tile + r / group, g = r % group;
    const int valid = r < tile_rows && local_t < qlen;
    rm.valid[threadIdx.x] = valid;
    rm.qpos[threadIdx.x] = ctx - qlen + local_t;
    rm.off[threadIdx.x] =
        valid ? ((long long)(qoff + local_t) * H + hk * group + g) * D : 0;
  }
  const int first_t = qt * q_tile + (chunk * ROWS) / group;
  int kv_hi = ctx - qlen + min(qlen, (qt + 1) * q_tile);
  if (chunk * ROWS >= tile_rows || first_t >= qlen) kv_hi = 0;  // all padding
  kv_hi = max(0, min(kv_hi, max_pages * page_size));
  const PagedKeys keys{tables + (long long)s * max_pages, max_pages,
                       page_size, hk, Hkv, D};
  attend_rows<T, D, ROWS>(q, k_pages, v_pages, o, scale, kv_hi, keys, rm);
}

template <typename T>
struct Type {
  using type = T;
};

template <typename T, int D>
int launch_prefill_cores(const void* q, const void* kp, const void* vp,
                         void* o, const int* ctx, const int* qlens,
                         const int* qoffs, const int* sot, const int* qot,
                         const int* tables, int n_tiles, int max_pages, int H,
                         int Hkv, int page_size, int q_tile, float scale,
                         cudaStream_t stream) {
  constexpr int ROWS = 16;
  const int tile_rows = q_tile * (H / Hkv);
  dim3 grid(n_tiles, Hkv, (tile_rows + ROWS - 1) / ROWS);
  ragged_paged_attention_kernel<T, D, ROWS>
      <<<grid, dsattn::kThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(kp),
          static_cast<const T*>(vp), static_cast<T*>(o), ctx, qlens, qoffs,
          sot, qot, tables, max_pages, H, Hkv, page_size, q_tile, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// One call's launches.  q: packed [total_q, H, D]; pages [P, Hkv, page,
// D]; o like q; dtype: 0 = float32, 1 = bfloat16, 2 = float16; D is 64,
// 80, 96, 128 or 256 in every form, and 16 in the decode form and the
// CUDA-core prefill tiles (any other: cudaErrorInvalidValue).  All
// metadata arrays are int32 on the device: ctx_lens / q_lens / q_offs [B],
// block_tables [B, max_pages].  Decode form (n_dec > 0): dec_seqs [n_dec]
// sequences of at most dec_rows = q_len * group <= 8 rows, their keys
// split in n_split chunks of ``chunk`` keys (n_split * chunk >= max_pages *
// page); with n_split > 1 ``part`` is fp32 scratch of n_dec * Hkv *
// n_split * dec_rows * (D + 2) floats.  Prefill form (n_tiles > 0): tiles
// seq_of_tile / qtile_of_tile [n_tiles] of q_tile tokens; tensor_cores = 1
// takes the bf16 / fp16 wgmma kernel (q_tile = 128 / group), 0 the
// CUDA-core one.
// Returns cudaGetLastError().
extern "C" int ds_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages, void* o,
    const void* ctx_lens, const void* q_lens, const void* q_offs,
    const void* tables, const void* dec_seqs, void* part,
    const void* seq_of_tile, const void* qtile_of_tile, int n_dec,
    int dec_rows, int n_split, int chunk, int n_tiles, int q_tile,
    int tensor_cores, int max_pages, int total_q, int P, int H, int Hkv,
    int page_size, int D, int dtype, float scale, void* stream) {
  if (n_dec < 0 || n_tiles < 0 || n_dec + n_tiles == 0 || Hkv <= 0 ||
      H % Hkv != 0 || page_size <= 0 || max_pages <= 0 || Hkv > 65535 ||
      !dsdecode::head_dim_taken(D) || dtype < 0 || dtype > 2 ||
      n_dec > 65535)
    return (int)cudaErrorInvalidValue;
  const int group = H / Hkv;
  const int* c = static_cast<const int*>(ctx_lens);
  const int* ql = static_cast<const int*>(q_lens);
  const int* qo = static_cast<const int*>(q_offs);
  const int* tb = static_cast<const int*>(tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_dec > 0) {
    if (dec_rows < 1 || dec_rows > dsdecode::kMaxRows || n_split <= 0 ||
        n_split > 65535 || chunk <= 0 ||
        (long long)n_split * chunk < (long long)max_pages * page_size ||
        (n_split > 1 && part == nullptr))
      return (int)cudaErrorInvalidValue;
    const int rc = dsdecode::with_head_dim(D, [&](auto d) {
      return launch_decode<decltype(d)::value>(
          q, k_pages, v_pages, o, c, ql, qo, tb, dec_seqs, part, n_dec,
          dec_rows, n_split, chunk, max_pages, page_size, P, H, Hkv, dtype,
          scale, s);
    });
    if (rc != 0) return rc < 0 ? -rc : rc;
  }
  if (n_tiles == 0) return (int)cudaGetLastError();
  const int* sot = static_cast<const int*>(seq_of_tile);
  const int* qot = static_cast<const int*>(qtile_of_tile);
  if (tensor_cores) {
    const int keys = dswg::tile_keys(D);
    const int box_rows = page_size < keys ? page_size : keys;
    if (dtype == 0 || 64 % group != 0 || q_tile != tc::BM / group ||
        (page_size % keys != 0 &&
         (keys % page_size != 0 || page_size % 8 != 0)))
      return (int)cudaErrorInvalidValue;
    PrefillParams p = {};
    p.o = o;
    p.ctx = c;
    p.q_lens = ql;
    p.q_offs = qo;
    p.tables = tb;
    p.seq_of_tile = sot;
    p.qtile_of_tile = qot;
    p.max_pages = max_pages;
    p.page = page_size;
    p.box_rows = box_rows;
    p.H = H;
    p.Hkv = Hkv;
    p.scale = scale;
    return dsdecode::with_head_dim(D, [&](auto d) {
      constexpr int Dc = decltype(d)::value;
      // no tensor-core tile at 16: the wrapper sends it to the CUDA cores
      if constexpr (Dc == 16)
        return (int)cudaErrorInvalidValue;
      else
        return dtype == 1 ? launch_prefill_tc<__nv_bfloat16, Dc>(
                                p, q, k_pages, v_pages, n_tiles, total_q, P,
                                s)
                          : launch_prefill_tc<__half, Dc>(
                                p, q, k_pages, v_pages, n_tiles, total_q, P,
                                s);
    });
  }
  if (q_tile <= 0 || (q_tile * group + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  const auto cores = [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    return launch_prefill_cores<T, decltype(d)::value>(
        q, k_pages, v_pages, o, c, ql, qo, sot, qot, tb, n_tiles, max_pages,
        H, Hkv, page_size, q_tile, scale, s);
  };
  // one instantiation per head dim, each named (none falls to another)
  const int rc = dsdecode::with_head_dim(D, [&](auto d) {
    return dtype == 0   ? cores(Type<float>{}, d)
           : dtype == 1 ? cores(Type<__nv_bfloat16>{}, d)
                        : cores(Type<__half>{}, d);
  });
  return rc < 0 ? -rc : rc;
}

// Blocks of the decode form (rows <= 8 query rows per kv head) at head
// dim D that the current card holds at once; the wrapper sizes n_split by
// it.  Returns a negative CUDA error code on failure.
extern "C" int ds_ragged_decode_slots(int rows, int D, int dtype) {
  if (dtype < 0 || dtype > 2) return -(int)cudaErrorInvalidValue;
  return dsdecode::with_head_dim(D, [&](auto d) {
    using S = PagedSeqs<decltype(d)::value>;
    return dtype == 0   ? dsdecode::split_slots<float, S>(rows)
           : dtype == 1 ? dsdecode::split_slots<__nv_bfloat16, S>(rows)
                        : dsdecode::split_slots<__half, S>(rows);
  });
}
