// Split-key decode attention, shared by the two serving kernels that read
// a KV cache one query token at a time: the contiguous cache's decode
// (decode_attention.cu) and the paged cache's decode rows
// (ragged_paged_attention.cu).  They differ only in where a sequence's
// query rows and keys live, which the caller's ``Seqs`` functor says.
//
// Computes, for each sequence z and kv head hk, the attention of ROWS <= 4
// query rows (a GQA group folded in: row r is token r / group of head
// hk * group + r % group) over keys [0, kv_hi) with the causal-ragged mask
// key < lim(r), an fp32 online softmax, and 0 for a row that sees no key.
//
// What bounds it on the H100: every cached K/V byte is read once for 4*D
// flops per key per row -- about 1 flop per byte, far under the card's
// ~295 flop/byte ridge, so HBM bandwidth (3.35 TB/s) is the bound, and a
// decode step is short enough that the memory system has to be kept busy
// from the first cycle: memory-level parallelism is the design.
//
// One block per (key chunk, kv head, sequence): grid (n_split, Hkv, Z).
// The keys of a sequence go to one block, or are split into chunks of
// ``chunk`` keys, one block each (flash-decoding), when Z * Hkv blocks
// would leave the card's block slots idle -- the wrapper sizes the split
// from the occupancy query (split_slots).  A block has 16, 8 or 4 warps
// for 1, 2 or 3-4 rows (as many as one SM's registers hold), and each warp
// takes every n-th group of 16 keys (8 for fp32) of the block's keys.  A
// warp issues all 16 of a group's 16-byte K and V loads into registers
// before it uses any (kept out of L1: each byte is read once), so some
// 128 KB are in flight on every SM; nothing is staged in shared memory.
// The query rows live in registers, a lane holding 8 (fp32: 4) of a row's
// 128 dims, so a score is a warp dot product: 16 (32) lanes each multiply
// their slice of one key row and four (five) shuffles sum it.  The online
// softmax is fp32 in base 2 (q prescaled by scale * log2 e); each lane
// accumulates P V for its own keys' V slices.  Only real rows are computed.
// Merges run in a fixed order, so runs repeat bit for bit: the key halves
// of a warp by one shuffle, the warps in shared memory by warp index, and,
// when a sequence spans several chunks, the chunks' (m, l, acc) by a
// second small kernel in chunk order, launched early (programmatic
// dependent launch) so that its launch latency hides under the chunks'
// tail.  The caller gives the partial buffer (fp32, from torch's caching
// allocator on the launch stream); nothing is allocated here, so the
// launch can be captured in a CUDA graph.  A sequence whose keys fit one
// chunk is finished by that chunk's block and the combine skips it.
//
// ``Seqs`` provides ``seq(z, hk)``, a per-block view with ``kv_hi`` (keys
// of the sequence), ``rows`` (its real query rows, <= ROWS), ``row(r)``
// (element offset of query row r in q and o), ``lim(r)`` (keys below it
// are visible to row r) and ``key(k)`` (element offset of key k's K and V
// row).
#pragma once

#include <type_traits>

#include "attention_tile.cuh"

namespace dsdecode {

using dsattn::from_f;
using dsattn::kNeg;
using dsattn::to_f;

constexpr int kD = 128;             // head_dim
constexpr int kLoads = 8;           // 16-byte K (and V) loads a lane per group
constexpr int kMaxRows = 4;         // query rows per kv head of the form

// Warps of a decode block by its row count: as many as the registers of
// one SM allow for 2-4 blocks (a row's q, accumulator and scores cost a
// lane 24 registers beside the 64 of a group's loads).
__host__ __device__ constexpr int decode_warps(int rows) {
  return rows == 1 ? 16 : rows == 2 ? 8 : 4;
}

// One 16-byte load of a K/V row slice, which is read once: kept out of L1.
__device__ __forceinline__ uint4 load16(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// Lane layout of one key group for element type T: a key row is LPR lanes
// of VEC elements, a warp load covers KPL rows, a group KEYS rows.
template <typename T>
struct Lanes {
  static constexpr int VEC = 16 / sizeof(T);   // dims per lane
  static constexpr int LPR = kD / VEC;         // lanes per key row
  static constexpr int KPL = 32 / LPR;         // key rows per warp load
  static constexpr int KEYS = kLoads * KPL;    // keys per group
};

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

template <typename T, int ROWS, typename Seqs>
__global__ void __launch_bounds__(decode_warps(ROWS) * 32)
split_kernel(const __grid_constant__ SplitParams<Seqs> p) {
  using L = Lanes<T>;
  constexpr int VEC = L::VEC, LPR = L::LPR, KPL = L::KPL, KEYS = L::KEYS;
  constexpr int kWarps = decode_warps(ROWS);
  static_assert(kWarps * 32 >= kD, "the merge gives thread d dim d");
  __shared__ float acc_s[kWarps][ROWS][kD];
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
  const T* q = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.k) + d0;
  const T* vp = static_cast<const T*>(p.v) + d0;

  // the rows' q slices (prescaled to base 2), key limits and offsets
  const float qscale = p.scale * 1.4426950408889634f;
  float qr[ROWS][VEC];
  int lim[ROWS];
  long long off[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const bool real = r < seq.rows;
    off[r] = real ? seq.row(r) : 0;
    lim[r] = real ? min(seq.lim(r), k_end) : k_begin;   // keys < lim
    const uint4 u = real ? *reinterpret_cast<const uint4*>(q + off[r] + d0)
                         : make_uint4(0u, 0u, 0u, 0u);
    unpack<T>(u, qr[r]);
#pragma unroll
    for (int x = 0; x < VEC; ++x) qr[r][x] *= qscale;
  }

  float m[ROWS], l[ROWS], acc[ROWS][VEC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int x = 0; x < VEC; ++x) acc[r][x] = 0.f;
  }

  for (int g0 = k_begin + warp * KEYS; g0 < k_end; g0 += kWarps * KEYS) {
    // every load of the group in flight before any is used
    uint4 kr[kLoads], vr[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int key = g0 + j * KPL + kl;
      const bool in = key < k_end;
      const long long at = in ? seq.key(key) : 0;
      kr[j] = in ? load16(kp + at) : make_uint4(0u, 0u, 0u, 0u);
      vr[j] = in ? load16(vp + at) : make_uint4(0u, 0u, 0u, 0u);
    }
    // scores: each lane's slice of key row j, summed over the row's lanes
    float s[ROWS][kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      float kf[VEC];
      unpack<T>(kr[j], kf);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float a = 0.f;
#pragma unroll
        for (int x = 0; x < VEC; ++x) a = fmaf(qr[r][x], kf[x], a);
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
      for (int j = 0; j < kLoads; ++j) {
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
      for (int x = 0; x < VEC; ++x) acc[r][x] *= corr;
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        // a masked key is 0, also while the row has seen no key (m = kNeg)
        const float pr = s[r][j] <= kNeg / 2 ? 0.f : ex2(s[r][j] - m_new);
        s[r][j] = pr;
        l[r] += pr;
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      float vf[VEC];
      unpack<T>(vr[j], vf);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int x = 0; x < VEC; ++x)
          acc[r][x] = fmaf(s[r][j], vf[x], acc[r][x]);
    }
  }

  // the warp's key rows (bf16 and fp16: lanes l and l + 16 hold the same
  // dims; fp32: each lane its own)
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int o = 16; o >= LPR; o >>= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int x = 0; x < VEC; ++x)
        acc[r][x] += __shfl_xor_sync(0xffffffffu, acc[r][x], o);
    }
    if (lane < LPR) {
#pragma unroll
      for (int x = 0; x < VEC; ++x) acc_s[warp][r][d0 + x] = acc[r][x];
    }
    if (lane == 0) {
      m_s[warp][r] = m[r];
      l_s[warp][r] = l[r];
    }
  }
  __syncthreads();

  // the warps in warp order; thread d < D owns dim d of every row
  const int d = threadIdx.x;
  if (d >= kD) return;
  const long long zhk = (long long)z * p.Hkv + hk;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= seq.rows) break;
    float mm = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_s[w][r]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = ex2(m_s[w][r] - mm);
      ll = fmaf(l_s[w][r], c, ll);
      aa = fmaf(acc_s[w][r][d], c, aa);
    }
    if (n_active == 1) {
      static_cast<T*>(p.o)[off[r] + d] = from_f<T>(aa / fmaxf(ll, 1e-30f));
    } else {
      const long long at = (zhk * p.n_split + split) * ROWS + r;
      p.part[at * (kD + 2) + d] = aa;
      if (d == 0) {
        p.part[at * (kD + 2) + kD] = mm;
        p.part[at * (kD + 2) + kD + 1] = ll;
      }
    }
  }
}

// Merges the chunks of every sequence that spans more than one, in chunk
// order: grid (Hkv, Z), thread d owns dim d of every row.  The loops are
// unrolled so that a row's loads are in flight together.
template <typename T, int ROWS, typename Seqs>
__global__ void __launch_bounds__(kD)
combine_kernel(const __grid_constant__ SplitParams<Seqs> p) {
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the chunks' results
  const int hk = blockIdx.x, z = blockIdx.y, d = threadIdx.x;
  const auto seq = p.seqs.seq(z, hk);
  const int n_active = active_chunks(seq.kv_hi, p.chunk);
  if (n_active == 1) return;                     // finished by its block
  const long long zhk = (long long)z * p.Hkv + hk;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= seq.rows) break;
    const float* row = p.part + (zhk * p.n_split * ROWS + r) * (kD + 2);
    constexpr long long step = (long long)ROWS * (kD + 2);
    float mm = kNeg;
#pragma unroll 8
    for (int c = 0; c < n_active; ++c) mm = fmaxf(mm, row[c * step + kD]);
    float ll = 0.f, aa = 0.f;
#pragma unroll 8
    for (int c = 0; c < n_active; ++c) {
      const float w = ex2(row[c * step + kD] - mm);
      ll = fmaf(row[c * step + kD + 1], w, ll);
      aa = fmaf(row[c * step + d], w, aa);
    }
    static_cast<T*>(p.o)[seq.row(r) + d] = from_f<T>(aa / fmaxf(ll, 1e-30f));
  }
}

// The split kernel over Z sequences, then, when a sequence may span
// several chunks, the combine kernel launched early.
template <typename T, int ROWS, typename Seqs>
int launch_split(const SplitParams<Seqs>& p, int Z, cudaStream_t stream) {
  split_kernel<T, ROWS, Seqs>
      <<<dim3(p.n_split, p.Hkv, Z), decode_warps(ROWS) * 32, 0, stream>>>(p);
  if (p.n_split > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    // programmatic dependent launch: the combine is scheduled while the
    // chunks' blocks run and waits for their results in griddepcontrol.wait
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.Hkv, Z);
    cfg.blockDim = dim3(kD);
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
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, split_kernel<T, R, Seqs>, decode_warps(R) * 32, 0);
    return e == cudaSuccess ? sms * per_sm : -(int)e;
  });
}

}  // namespace dsdecode
