// Block-sparse attention forward for Hopper (sm_90a): softmax(scale * Q
// K^T) V over the key blocks a static [H, nb, nb] layout sets, causal on
// the diagonal block when asked.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/sparse_attention.py:
// _sparse_kernel (host side sparse_attention_pallas and layout_tables).
// Same arithmetic: an fp32 online softmax (running max m, sum l,
// accumulator acc; masked scores -1e30) over the set key blocks of each
// query block, and a row that sees no key finalises to 0.  Forward only,
// as on the TPU.
//
// What bounds it on the H100: B * sparse_flops = 4 * set blocks * block^2
// * D operations per batch row, on q, k, v and o read or written once.  At
// S=4096, 16 heads, Fixed (block 16, unidirectional) sets 13% of all
// blocks (26% of the causal ones), BigBird (block 64, bidirectional) 12%:
// both are below the ~295 flop/byte ridge in bf16, so the bytes bound
// them, and the kernel's time should scale with the set blocks, not S^2.
//
// bf16 and fp16: tensor cores fed by TMA, one body templated on the
// element type E (wgmma .bf16 or .f16, the tensor maps' data type, P's
// and O's rounding; the TPU kernel too accumulates in fp32 and writes
// the input dtype, fp16 included).  The unit of work is a tile of 64
// query rows (wgmma's M): 64 / block q blocks at blocks 16 and 32, one q
// block at 64, half of one at 128.  Its keys come 64 at a time (wgmma's N):
// the host (ops/cuda/sparse_attention.py step_tables) takes the union of
// the key blocks the tile's q blocks set and cuts it into steps of 64
// keys -- four arbitrary set blocks at block 16, two at 32, one at 64,
// half of one at 128 -- each with a pair mask of which q block sees which
// slot.  A q block of a Fixed or BigBird layout shares most of its key
// blocks with its neighbours (local windows, global columns), so the
// union costs little: 8.8% more (q, k) work than the set blocks at
// Fixed-16, none at BigBird-64, S=4096 (step_overhead).  Scores of pairs
// the layout does not set, and above the diagonal when causal, are masked
// to -1e30 inside the step; a step whose pairs are all set and all below
// the diagonal (most steps of the global columns) skips the element mask.
// One block of one warpgroup (128 threads) per (tile, b * h), the last
// rows' tiles first (with a causal layout, the tiles with the most steps).  Thread 0 loads the Q tile once and each step's
// K and V by TMA, one 64-column box per gathered block (16 rows at block
// 16: 2 KB boxes, which land in the 128-byte swizzle exactly as one
// 64-row box would, since every box starts on a 1024-byte atom), one step
// ahead through a two-stage ring (an mbarrier per stage each way).  The
// warpgroup runs S = Q K^T (wgmma m64n64, both operands K-major from the
// swizzled tiles), the online softmax on the accumulator registers (one
// ex2.approx per score, as the flash forward), then O += P V with P
// rounded to E in registers as the A operand and V read transposed
// (m64n64 or m64n128 by D).  wgmma rather than mma.sync: with the keys
// gathered into 64-key steps, every layout block gives wgmma its full
// 64 x 64 tile, and one instruction shape serves all four blocks.  A
// single warpgroup with no producer warp keeps a block at 41 KB (D=64) or
// 82 KB (D=128) of shared memory and ~130 registers a thread, so two to
// four blocks share an SM and one block's loads hide under another's
// products.
//
// fp32 stays on the CUDA cores, selected by dtype in the C entry: one
// block of 256 threads per (q block, b * h) walks counts[h][qi] entries of
// table[h][qi] (layout_tables: the set key blocks of each q block, the
// upper triangle dropped when causal), Q and each set K and V block staged
// in shared memory as fp32, both products in fp32 (flash_tile.cuh's
// products), so every block (16-128) and head dim (64, 128) is one
// template and the fp32 checks hold it to 1e-4 of the plain version.
#include "flash_tile.cuh"
#include "hopper.cuh"

namespace {

using dsattn::from_f;
using dsattn::kNeg;
using dsattn::to_f;

constexpr int kThreads = 256;

template <int BLOCK, int D>
struct Tile {
  static constexpr int PD = D + 1;       // pitch of [BLOCK][D] tiles
  static constexpr int PT = BLOCK + 1;   // pitch of [BLOCK][BLOCK] tiles
  static constexpr int RI = BLOCK / 16;  // rows per thread
  static constexpr int DJ = D / 16;      // output columns per thread
  static constexpr size_t kSmemFloats =
      (size_t)2 * BLOCK * PD + (size_t)BLOCK * PT + 3 * BLOCK;
  static_assert(BLOCK % 16 == 0 && D % 16 == 0, "tile shape");
};

// Rows [r0, r0 + BLOCK) of one head of a [B, S, H, D] tensor -> dst
// [BLOCK][D + 1] as fp32 times ``mul`` (S tiles by BLOCK: every row
// exists).  ``base`` is the element offset of (b, 0, h, 0), ``stride`` =
// H * D.  16-byte loads, all issued before any store.
template <typename T, int BLOCK, int D>
__device__ __forceinline__ void load_block(float* __restrict__ dst,
                                           const T* __restrict__ src,
                                           long long base, long long stride,
                                           int r0, float mul) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LANES = D / VEC;
  constexpr int TOTAL = BLOCK * LANES;
  constexpr int PER = (TOTAL + kThreads - 1) / kThreads;
  uint4 buf[PER];
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int i = it * kThreads + threadIdx.x;
    if (TOTAL % kThreads == 0 || i < TOTAL)
      buf[it] = __ldg(reinterpret_cast<const uint4*>(
          src + base + (long long)(r0 + i / LANES) * stride +
          (i % LANES) * VEC));
  }
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int i = it * kThreads + threadIdx.x;
    if (TOTAL % kThreads == 0 || i < TOTAL) {
      const T* e = reinterpret_cast<const T*>(&buf[it]);
      float* row = dst + (i / LANES) * (D + 1) + (i % LANES) * VEC;
#pragma unroll
      for (int x = 0; x < VEC; ++x) row[x] = to_f(e[x]) * mul;
    }
  }
}

template <typename T, int BLOCK, int D>
__global__ void __launch_bounds__(kThreads)
sparse_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        const int* __restrict__ counts,
                        const int* __restrict__ table, int S, int H,
                        int max_active, float scale, int causal) {
  using G = Tile<BLOCK, D>;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [BLOCK][PD] Q * scale
  float* kv_s = q_s + BLOCK * G::PD;  // [BLOCK][PD] K, then V
  float* p_s = kv_s + BLOCK * G::PD;  // [BLOCK][PT] scores, probabilities
  float* m_s = p_s + BLOCK * G::PT;   // [BLOCK] running max
  float* l_s = m_s + BLOCK;           // [BLOCK] running sum
  float* c_s = l_s + BLOCK;           // [BLOCK] rescale of this key block

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int qi = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, nb = S / BLOCK;
  const int q0 = qi * BLOCK;
  const long long base = ((long long)b * S * H + h) * D;
  const long long stride = (long long)H * D;
  const int count = counts[h * nb + qi];
  const int* blocks = table + ((long long)h * nb + qi) * max_active;

  load_block<T, BLOCK, D>(q_s, q, base, stride, q0, scale);
  if (tid < BLOCK) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[G::RI][G::DJ];
#pragma unroll
  for (int i = 0; i < G::RI; ++i)
#pragma unroll
    for (int j = 0; j < G::DJ; ++j) acc[i][j] = 0.f;

  for (int a = 0; a < count; ++a) {
    const int k0 = blocks[a] * BLOCK;
    __syncthreads();  // previous block's P V done; Q and m/l written
    load_block<T, BLOCK, D>(kv_s, k, base, stride, k0, 1.f);
    __syncthreads();

    float s[G::RI][G::RI];
#pragma unroll
    for (int i = 0; i < G::RI; ++i)
#pragma unroll
      for (int j = 0; j < G::RI; ++j) s[i][j] = 0.f;
    dsflash::gemm_nt<G::RI, G::RI, D, G::PD, G::PD>(s, q_s, kv_s, ty, tx);
#pragma unroll
    for (int i = 0; i < G::RI; ++i)
#pragma unroll
      for (int j = 0; j < G::RI; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        p_s[r * G::PT + c] = (!causal || k0 + c <= q0 + r) ? s[i][j] : kNeg;
      }
    __syncthreads();  // scores complete; K no longer read

    // online softmax: warp w owns rows w, w + 8, ...; a lane every 32nd key
    for (int r = warp; r < BLOCK; r += kThreads / 32) {
      float* row = p_s + r * G::PT;
      float mx = kNeg;
      for (int c = lane; c < BLOCK; c += 32) mx = fmaxf(mx, row[c]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, dsattn::warp_max(mx));
      float sum = 0.f;
      for (int c = lane; c < BLOCK; c += 32) {
        const float p = m_new <= kNeg / 2 ? 0.f : expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum = dsattn::warp_sum(sum);
      if (lane == 0) {
        const float corr = m_prev <= kNeg / 2 ? 0.f : expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    load_block<T, BLOCK, D>(kv_s, v, base, stride, k0, 1.f);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < G::RI; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < G::DJ; ++j) acc[i][j] *= corr;
    }
    dsflash::gemm_nn<G::RI, G::DJ, BLOCK, G::PT, G::PD>(acc, p_s, kv_s, ty,
                                                         tx);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < G::RI; ++i) {
    const int r = ty + 16 * i;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = o + base + (long long)(q0 + r) * stride;
#pragma unroll
    for (int j = 0; j < G::DJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / l);
  }
}

// ---- bf16 / fp16: tensor cores ------------------------------------------

namespace tc {
constexpr int BM = 64;          // query rows of a tile
constexpr int BN = 64;          // keys of a step
constexpr int kThreads = 128;   // one warpgroup
constexpr int kStages = 2;
constexpr int kWidth = 8;       // int32 words of a step (STEP_WIDTH)
constexpr int kEdge = 1 << 16;  // EDGE_BIT: the step needs the element mask
constexpr int kHalf = BM * hopper::kBoxCols * 2;   // one 64-column box
template <int D>
struct Smem {
  static constexpr int kTile = BM * D * 2;         // a Q, K or V tile
  // Q, then kStages x (K, V), then the barriers: Q's, full[], empty[]
  static constexpr int kBarOffset = kTile + kStages * 2 * kTile;
  static constexpr size_t kBytes = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};
}  // namespace tc

struct TcParams {
  CUtensorMap q_map, k_map, v_map;
  void* o;                                          // E [B, S, H, D]
  const int* counts;   // [H, n_tiles] steps of each tile
  const int* starts;   // [H, n_tiles] its first step
  const int* steps;    // [n, kWidth]: pair mask | edge, key row of each slot
  int S, H, n_tiles, causal;
  float scale;
};

template <typename E, int BLOCK, int D>
__global__ void __launch_bounds__(tc::kThreads)
sparse_tc_kernel(const __grid_constant__ TcParams p) {
  using namespace hopper;
  using namespace tc;
  constexpr int UNIT = BLOCK < BN ? BLOCK : BN;   // key rows of a slot
  constexpr int SLOTS = BN / UNIT;
  constexpr int kTile = Smem<D>::kTile;
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = base;
  unsigned char* kv_s = base + kTile;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(base + Smem<D>::kBarOffset);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kStages;

  const int tile = p.n_tiles - 1 - blockIdx.x;   // last rows first
  const int bh = blockIdx.y, h = bh % p.H, b = bh / p.H;
  const int q0 = tile * BM, t = threadIdx.x;
  const int n_steps = p.counts[h * p.n_tiles + tile];
  const int* steps = p.steps + (long long)kWidth * p.starts[h * p.n_tiles + tile];

  if (t == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], tc::kThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // K and V of step it -> its stage, one box per slot and 64 columns
  auto issue = [&](int it) {
    const int st = it % kStages;
    mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);   // released by it - 2
    unsigned char* k_t = kv_s + st * 2 * kTile;
    mbar_arrive_expect_tx(&full[st], 2 * kTile);
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int row = __ldg(steps + kWidth * it + 1 + j);
#pragma unroll
      for (int c = 0; c < D / kBoxCols; ++c) {
        unsigned char* dst = k_t + c * kHalf + j * UNIT * 128;
        tma_load_4d(dst, &p.k_map, &full[st], c * kBoxCols, h, row, b);
        tma_load_4d(dst + kTile, &p.v_map, &full[st], c * kBoxCols, h, row,
                    b);
      }
    }
  };
  if (t == 0) {
    mbar_arrive_expect_tx(q_bar, kTile);
#pragma unroll
    for (int c = 0; c < D / kBoxCols; ++c)
      tma_load_4d(q_s + c * kHalf, &p.q_map, q_bar, c * kBoxCols, h, q0, b);
    if (n_steps > 0) issue(0);
  }
  __syncwarp();

  // this thread's two rows: their positions and q block in the tile
  int qpos[2], qi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = acc_row(2 * r, t);
    qpos[r] = q0 + row;
    qi[r] = BLOCK < BM ? row / BLOCK : 0;
  }
  const float scale = p.scale;
  const uint32_t q_addr = smem_u32(q_s);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};   // l: this lane's share

  mbar_wait(q_bar, 0);
  for (int it = 0; it < n_steps; ++it) {
    const int st = it % kStages;
    if (t == 0 && it + 1 < n_steps) issue(it + 1);
    __syncwarp();
    const int* sp = steps + kWidth * it;
    const int mask = __ldg(sp);
    int kstart[SLOTS];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) kstart[j] = __ldg(sp + 1 + j);
    mbar_wait(&full[st], (it / kStages) & 1);
    const uint32_t k_addr = smem_u32(kv_s) + st * 2 * kTile;
    const uint32_t v_addr = k_addr + kTile;

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kHalf + (kk % 4) * 32;
      wgmma_ss_n64<E>(s, desc_kmajor(q_addr + off), desc_kmajor(k_addr + off),
                      kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const bool edge = mask & kEdge;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      float x = __fmul_rn(s[i], scale);
      if (edge) {
        // the column's slot is fixed by i alone (a slot is >= 16 columns,
        // the lane's offset in its 8-column group < 8): kstart stays in
        // registers
        const int j = (8 * (i / 4)) / UNIT;
        const int col = acc_col(i, t);
        bool ok = (mask >> (qi[r] * SLOTS + j)) & 1;
        if (p.causal) ok = ok && kstart[j] + col - j * UNIT <= qpos[r];
        if (!ok) x = kNeg;
      }
      s[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float corr[2], ml[2];   // ml: m * log2(e), the exponents' offset
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row that has seen no key yet keeps m = -1e30; its exponents are
      // taken from 0, so its masked scores give exactly 0
      const float m_new = fmaxf(m[r], mx[r]);
      ml[r] = m_new <= kNeg / 2 ? 0.f : m_new * kLog2e;
      corr[r] = ex2(fmaf(m[r], kLog2e, -ml[r]));
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      const float pr = ex2(fmaf(s[i], kLog2e, -ml[r]));
      l[r] += pr;
      s[i] = pr;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];
    uint32_t pa[16];
    acc_to_a<E>(s, pa);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
      const uint64_t desc = desc_mnmajor(v_addr + kk * 2048, kHalf);
      wgmma_rs<E, D>(o, a, desc);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qpos[r] >= p.S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        static_cast<E*>(p.o) + (((long long)b * p.S + qpos[r]) * p.H + h) * D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      orow[(8 * j + 2 * (t % 4)) / 2] =
          pack2<E>(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

template <typename E, int BLOCK, int D>
int launch_tc(const TcParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = tc::Smem<D>::kBytes;
  // once per instantiation, before any graph capture can be running
  static const cudaError_t attr = cudaFuncSetAttribute(
      sparse_tc_kernel<E, BLOCK, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  sparse_tc_kernel<E, BLOCK, D>
      <<<dim3(p.n_tiles, B * p.H), tc::kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// q/k/v/o E [B, S, H, D] (bf16 or fp16): tensor maps (Q by 64-row tiles,
// K and V by slots of min(block, 64) rows), then the launch by block and
// D.
template <typename E>
int launch_tensor_cores(const void* q, const void* k, const void* v,
                        void* o, const void* counts, const void* starts,
                        const void* steps, int B, int S, int H, int D,
                        int block, int causal, float scale,
                        cudaStream_t stream) {
  TcParams p = {};
  const int unit = block < tc::BN ? block : tc::BN;
  const auto map = hopper::make_head_map<E>;
  int rc = map(&p.q_map, q, B, S, H, tc::BM, D);
  if (!rc) rc = map(&p.k_map, k, B, S, H, unit, D);
  if (!rc) rc = map(&p.v_map, v, B, S, H, unit, D);
  if (rc) return rc;
  p.o = o;
  p.counts = static_cast<const int*>(counts);
  p.starts = static_cast<const int*>(starts);
  p.steps = static_cast<const int*>(steps);
  p.S = S;
  p.H = H;
  p.n_tiles = (S + tc::BM - 1) / tc::BM;
  p.causal = causal;
  p.scale = scale;
#define DS_TC(BLK)                                                    \
  case BLK:                                                           \
    return D == 64 ? launch_tc<E, BLK, 64>(p, B, stream)              \
                   : launch_tc<E, BLK, 128>(p, B, stream);
  switch (block) {
    DS_TC(16)
    DS_TC(32)
    DS_TC(64)
    DS_TC(128)
  }
#undef DS_TC
  return (int)cudaErrorInvalidValue;
}

// ---- fp32: launch by block and D ----------------------------------------

template <typename T, int BLOCK, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* counts, const void* table, int B, int S, int H,
           int max_active, int causal, float scale, cudaStream_t stream) {
  const size_t smem = Tile<BLOCK, D>::kSmemFloats * sizeof(float);
  // once per instantiation, before any graph capture can be running
  static const cudaError_t attr = cudaFuncSetAttribute(
      sparse_attention_kernel<T, BLOCK, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(S / BLOCK, B * H);
  sparse_attention_kernel<T, BLOCK, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int*>(counts), static_cast<const int*>(table), S, H,
      max_active, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_block(const void* q, const void* k, const void* v, void* o,
                 const void* counts, const void* table, int B, int S, int H,
                 int block, int max_active, int causal, float scale,
                 cudaStream_t stream) {
  switch (block) {
    case 16:
      return launch<T, 16, D>(q, k, v, o, counts, table, B, S, H, max_active,
                              causal, scale, stream);
    case 32:
      return launch<T, 32, D>(q, k, v, o, counts, table, B, S, H, max_active,
                              causal, scale, stream);
    case 64:
      return launch<T, 64, D>(q, k, v, o, counts, table, B, S, H, max_active,
                              causal, scale, stream);
    case 128:
      return launch<T, 128, D>(q, k, v, o, counts, table, B, S, H,
                               max_active, causal, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* o,
               const void* counts, const void* table, int B, int S, int H,
               int D, int block, int max_active, int causal, float scale,
               cudaStream_t stream) {
  if (D == 64)
    return launch_block<T, 64>(q, k, v, o, counts, table, B, S, H, block,
                               max_active, causal, scale, stream);
  if (D == 128)
    return launch_block<T, 128>(q, k, v, o, counts, table, B, S, H, block,
                                max_active, causal, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k/v/o: [B, S, H, D], one dtype (0 = float32, 1 = bfloat16, 2 =
// float16), D 64 or 128; block 16, 32, 64 or 128 and S a multiple of it.
// float32 reads layout_tables: counts int32 [H, S / block], table int32
// [H, S / block, max_active]; bfloat16 and float16 read step_tables:
// step_counts and step_starts int32 [H, ceil(S / 64)], steps int32 [n,
// 8].  Returns cudaGetLastError().
extern "C" int ds_sparse_attention(const void* q, const void* k,
                                   const void* v, void* o, const void* counts,
                                   const void* table, const void* step_counts,
                                   const void* step_starts, const void* steps,
                                   int B, int S, int H, int D, int block,
                                   int max_active, int causal, int dtype,
                                   float scale, void* stream) {
  if (B <= 0 || H <= 0 || block <= 0 || S <= 0 || S % block != 0 ||
      max_active <= 0 || (long long)B * H > 65535 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(q, k, v, o, counts, table, B, S, H, D, block,
                             max_active, causal, scale, s);
  if (dtype == 1)
    return launch_tensor_cores<__nv_bfloat16>(q, k, v, o, step_counts,
                                              step_starts, steps, B, S, H, D,
                                              block, causal, scale, s);
  if (dtype == 2)
    return launch_tensor_cores<__half>(q, k, v, o, step_counts, step_starts,
                                       steps, B, S, H, D, block, causal,
                                       scale, s);
  return (int)cudaErrorInvalidValue;
}
