// Decode attention over a contiguous KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py:
// _decode_kernel (host side decode_attention_pallas).  Computes, for each
// sequence b, the attention of its last T tokens (already appended to the
// cache) over cache[b, :, :lengths[b]] with the causal-ragged mask
// kpos <= lengths[b] - T + t, fp32 online softmax, GQA group folded into
// the rows: row r of kv head hk is token r / group of head hk*group + r%group.
// A row that sees no key is 0.
//
// What bounds it on the H100: decode (T = 1) reads every cached K/V byte
// once and does 4*D flops per key per head -- about 1 flop per byte, far
// under the card's ~295 flop/byte ridge, so HBM bandwidth (3.35 TB/s) is
// the bound.  Prefill (T = prompt) has T*group query rows per kv head and
// is bounded by arithmetic.
//
// Decode form (at most 4 query rows per kv head: generate's decode steps),
// designed for memory-level parallelism.  The TPU kernel walks a
// sequence's key blocks in order on one core; here the keys of each (kv
// head, sequence) go to one block, or are split into chunks of ``chunk``
// keys, one block each (grid (n_split, Hkv, B); flash-decoding), when
// B * Hkv blocks would leave the card's block slots idle -- the wrapper
// sizes the split from the occupancy query below.  A block has 16, 8 or
// 4 warps for 1, 2 or 3-4 rows (as many as one SM's registers hold), and
// each warp takes every n-th group of 16 keys (8 for fp32) of the block's
// keys.  A warp issues all 16 of a group's 16-byte K and V loads into
// registers before it uses any (kept out of L1: each byte is read once),
// so some 128 KB are in flight on every SM; nothing is staged in shared
// memory.  The query rows live in registers, a lane holding 8 (fp32: 4) of
// a row's 128 dims, so a score is a warp dot product: 16 (32) lanes each
// multiply their slice of one key row and four (five) shuffles sum it.
// The online softmax is fp32 in base 2 (q prescaled by scale * log2 e);
// each lane accumulates P V for its own keys' V slices.  Only the real
// rows are computed (ROWS = T * group, 1 to 4: MHA decode is one row, not
// a 4-row tile of which three are padding).  Merges run in a fixed order,
// so runs repeat bit for bit: the key halves of a warp by one shuffle, the
// warps in shared memory by warp index, and, when a sequence spans several
// chunks, the chunks' (m, l, acc) by a second small kernel in chunk order,
// launched early (programmatic dependent launch) so that its launch
// latency hides under the chunks' tail.  The wrapper gives the partial
// buffer (fp32, torch's caching allocator on the launch stream); nothing
// is allocated here, so the launch can be captured in a CUDA graph.  A
// sequence whose keys fit one chunk is finished by that chunk's block and
// the combine skips it.
//
// Prefill form (more than 4 rows per kv head; generate's T=128 prefill):
// grid (row tiles, Hkv, B), one block of 128 threads per 16-row tile
// walking its keys in blocks of 64 through fp32 shared memory
// (attention_tile.cuh, shared with the ragged paged kernel), never reading
// keys at or past the tile's causal frontier min(length, last row's
// position + 1).
#include <type_traits>

#include "attention_tile.cuh"

namespace {

using dsattn::from_f;
using dsattn::kNeg;
using dsattn::to_f;

constexpr int kD = 128;             // head_dim
constexpr int kLoads = 8;           // 16-byte K (and V) loads a lane per group

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
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int x = 0; x < 16 / (int)sizeof(T); ++x) f[x] = to_f(e[x]);
}

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part;          // [B * Hkv * n_split * rows] x (D acc, then m, l)
  const int* lengths;   // [B] or null: length_all for every sequence
  int length_all, T, H, Hkv, S_max, n_split, chunk;
  float scale;
};

// Valid keys of sequence b: [0, kv_hi), and the number of chunks they take.
__device__ __forceinline__ int seq_keys(const DecodeParams& p, int b) {
  const int len = p.lengths != nullptr ? p.lengths[b] : p.length_all;
  return max(0, min(len, p.S_max));
}
__device__ __forceinline__ int active_chunks(const DecodeParams& p,
                                             int kv_hi) {
  return max(1, (kv_hi + p.chunk - 1) / p.chunk);
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(decode_warps(ROWS) * 32)
decode_split_kernel(const __grid_constant__ DecodeParams p) {
  using L = Lanes<T>;
  constexpr int VEC = L::VEC, LPR = L::LPR, KPL = L::KPL, KEYS = L::KEYS;
  constexpr int kWarps = decode_warps(ROWS);
  static_assert(kWarps * 32 >= kD, "the merge gives thread d dim d");
  __shared__ float acc_s[kWarps][ROWS][kD];
  __shared__ float m_s[kWarps][ROWS], l_s[kWarps][ROWS];

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  // the combine kernel may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;");
  const int group = p.H / p.Hkv;
  const int kv_hi = seq_keys(p, b);
  const int n_active = active_chunks(p, kv_hi);
  if (split >= n_active) return;
  const int k_begin = split * p.chunk;
  const int k_end = min(kv_hi, k_begin + p.chunk);
  const int len = p.lengths != nullptr ? p.lengths[b] : p.length_all;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = (lane % LPR) * VEC, kl = lane / LPR;
  const T* q = static_cast<const T*>(p.q);
  const long long kv_base = ((long long)b * p.Hkv + hk) * p.S_max * kD;
  const T* kp = static_cast<const T*>(p.k) + kv_base + d0;
  const T* vp = static_cast<const T*>(p.v) + kv_base + d0;

  // the rows' q slices (prescaled to base 2), key limits and offsets
  const float qscale = p.scale * 1.4426950408889634f;
  float qr[ROWS][VEC];
  int lim[ROWS];
  long long off[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int t = r / group, g = r % group;
    off[r] = ((long long)(b * p.T + t) * p.H + hk * group + g) * kD;
    lim[r] = min(len - p.T + t + 1, k_end);   // keys < lim: kpos <= qpos
    const uint4 u = *reinterpret_cast<const uint4*>(q + off[r] + d0);
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
      kr[j] = in ? load16(kp + (long long)key * kD) : make_uint4(0u, 0u, 0u, 0u);
      vr[j] = in ? load16(vp + (long long)key * kD) : make_uint4(0u, 0u, 0u, 0u);
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
        for (int x = 0; x < VEC; ++x) acc[r][x] = fmaf(s[r][j], vf[x], acc[r][x]);
    }
  }

  // the warp's key halves (bf16: lanes l and l + 16 hold the same dims)
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
  const long long bhk = (long long)b * p.Hkv + hk;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
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
      const long long at = (bhk * p.n_split + split) * ROWS + r;
      p.part[at * (kD + 2) + d] = aa;
      if (d == 0) {
        p.part[at * (kD + 2) + kD] = mm;
        p.part[at * (kD + 2) + kD + 1] = ll;
      }
    }
  }
}

// Merges the chunks of every sequence that spans more than one, in chunk
// order: grid (Hkv, B), thread d owns dim d of every row.  The loops are
// unrolled so that a row's loads are in flight together.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kD)
decode_combine_kernel(const __grid_constant__ DecodeParams p) {
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the chunks' results
  const int hk = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int n_active = active_chunks(p, seq_keys(p, b));
  if (n_active == 1) return;                     // finished by its block
  const int group = p.H / p.Hkv;
  const long long bhk = (long long)b * p.Hkv + hk;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float* row = p.part + (bhk * p.n_split * ROWS + r) * (kD + 2);
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
    const int t = r / group, g = r % group;
    const long long off = ((long long)(b * p.T + t) * p.H + hk * group + g) * kD;
    static_cast<T*>(p.o)[off + d] = from_f<T>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int ROWS>
int launch_split(const DecodeParams& p, int B, cudaStream_t stream) {
  decode_split_kernel<T, ROWS>
      <<<dim3(p.n_split, p.Hkv, B), decode_warps(ROWS) * 32, 0, stream>>>(p);
  if (p.n_split > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    // programmatic dependent launch: the combine is scheduled while the
    // chunks' blocks run and waits for their results in griddepcontrol.wait
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.Hkv, B);
    cfg.blockDim = dim3(kD);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t c =
        cudaLaunchKernelEx(&cfg, decode_combine_kernel<T, ROWS>, p);
    if (c != cudaSuccess) return (int)c;
  }
  return (int)cudaGetLastError();
}

// Runs ``f(std::integral_constant<int, rows>)`` for rows 1..4.
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

template <typename T>
int launch_decode(const DecodeParams& p, int B, int rows,
                  cudaStream_t stream) {
  return with_rows(rows, [&](auto r) {
    return launch_split<T, decltype(r)::value>(p, B, stream);
  });
}

// Blocks of the decode form the current card holds at once (SMs times
// blocks per SM), or a negative CUDA error.
template <typename T>
int decode_slots(int rows) {
  return with_rows(rows, [](auto r) {
    constexpr int R = decltype(r)::value;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, decode_split_kernel<T, R>, decode_warps(R) * 32, 0);
    return e == cudaSuccess ? sms * per_sm : -(int)e;
  });
}

// ---- prefill form: 16-row tiles on attend_rows ----------------------------

struct ContiguousKeys {
  long long base;   // element offset of cache[b, hk, 0, 0]
  int d;
  __device__ __forceinline__ long long operator()(int key) const {
    return base + (long long)key * d;
  }
};

template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(dsattn::kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        const int* __restrict__ lengths, int length_all,
                        int T_, int H, int Hkv, int S_max, float scale) {
  using namespace dsattn;
  __shared__ RowMeta<ROWS> rm;
  const int tile = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int n_rows = T_ * group;
  const int len = lengths != nullptr ? lengths[b] : length_all;
  if (threadIdx.x < ROWS) {
    const int rg = tile * ROWS + threadIdx.x;
    const int valid = rg < n_rows;
    const int t = rg / group, g = rg % group;
    rm.valid[threadIdx.x] = valid;
    rm.qpos[threadIdx.x] = len - T_ + t;
    rm.off[threadIdx.x] =
        valid ? ((long long)(b * T_ + t) * H + hk * group + g) * D : 0;
  }
  const int last_row = min(tile * ROWS + ROWS, n_rows) - 1;
  int kv_hi = len - T_ + last_row / group + 1;
  kv_hi = max(0, min(kv_hi, min(len, S_max)));
  const ContiguousKeys keys{(long long)(b * Hkv + hk) * S_max * D, D};
  attend_rows<T, D, ROWS>(q, k, v, o, scale, kv_hi, keys, rm);
}

template <typename T>
int launch_prefill(const DecodeParams& p, int B, cudaStream_t stream) {
  constexpr int ROWS = 16;
  const int n_rows = p.T * (p.H / p.Hkv);
  dim3 grid((n_rows + ROWS - 1) / ROWS, p.Hkv, B);
  decode_attention_kernel<T, kD, ROWS><<<grid, dsattn::kThreads, 0, stream>>>(
      static_cast<const T*>(p.q), static_cast<const T*>(p.k),
      static_cast<const T*>(p.v), static_cast<T*>(p.o), p.lengths,
      p.length_all, p.T, p.H, p.Hkv, p.S_max, p.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, T, H, D]; k/v: [B, Hkv, S_max, D]; o: [B, T, H, D].  dtype: 0 =
// float32, 1 = bfloat16; D must be 128.  lengths may be null: then every
// sequence has length_all valid tokens.  The decode form (T * H / Hkv <= 4)
// splits each sequence's keys into n_split chunks of ``chunk`` keys
// (n_split * chunk >= S_max); with n_split > 1 ``part`` is fp32 scratch of
// B * Hkv * n_split * T * (H / Hkv) * (D + 2) floats.  The prefill form
// takes n_split = 1 and no scratch.  Returns cudaGetLastError().
extern "C" int ds_decode_attention(const void* q, const void* k,
                                   const void* v, void* o,
                                   const void* lengths, void* part,
                                   int length_all, int B, int T, int H,
                                   int Hkv, int S_max, int D, int dtype,
                                   int n_split, int chunk, float scale,
                                   void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 ||
      Hkv > 65535 || D != kD || (dtype != 0 && dtype != 1) ||
      n_split <= 0 || n_split > 65535 || chunk <= 0 ||
      (long long)n_split * chunk < S_max || (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  DecodeParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.part = static_cast<float*>(part);
  p.lengths = static_cast<const int*>(lengths);
  p.length_all = length_all;
  p.T = T;
  p.H = H;
  p.Hkv = Hkv;
  p.S_max = S_max;
  p.n_split = n_split;
  p.chunk = chunk;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = T * (H / Hkv);
  if (rows <= 4)
    return dtype == 0 ? launch_decode<float>(p, B, rows, s)
                      : launch_decode<__nv_bfloat16>(p, B, rows, s);
  if (n_split != 1) return (int)cudaErrorInvalidValue;
  return dtype == 0 ? launch_prefill<float>(p, B, s)
                    : launch_prefill<__nv_bfloat16>(p, B, s);
}

// Blocks of the decode form (T * H / Hkv = rows <= 4 query rows per kv
// head) that the current card holds at once; the wrapper sizes n_split by
// it.  Returns a negative CUDA error code on failure.
extern "C" int ds_decode_attention_slots(int rows, int dtype) {
  if (dtype == 0) return decode_slots<float>(rows);
  if (dtype == 1) return decode_slots<__nv_bfloat16>(rows);
  return -(int)cudaErrorInvalidValue;
}
