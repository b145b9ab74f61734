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
// Decode form (at most 8 query rows per kv head: generate's decode steps,
// a GQA group of up to 8 folded in): the split-key, memory-parallel body
// of split_decode.cuh, shared with the paged cache's decode rows, over a
// contiguous cache: sequence b's keys are rows of cache[b, hk], query row
// r is token r / group of q[b].  Head dim 16, 64, 80, 96, 128 or 256 (16:
// the benches' ``tiny`` model, on the CUDA-core body only; 80: GPT-3
// 2.7B's shape; 96: Phi-3-mini's; 256: Gemma's).  A D = 80 step of
// a B=4 generate over 144 cached tokens and 32 kv heads moves 5.90 MB:
// 1.76 us at 3.35 TB/s.
//
// Prefill form (more than 8 rows per kv head; generate's T=128 prefill):
// grid (row tiles, Hkv, B), one block of 128 threads per 16-row tile
// walking its keys in blocks of 64 (16 at D = 256) through fp32 shared
// memory (attention_tile.cuh, shared with the ragged paged kernel), never
// reading keys at or past the tile's causal frontier min(length, last
// row's position + 1).  Every form is instantiated at every head dim above; the
// C entry refuses any other.
#include "split_decode.cuh"

namespace {

// The contiguous cache's sequences for split_decode.cuh: q [B, T, H, D],
// k/v [B, Hkv, S_max, D], lengths [B] (or length_all for every sequence).
template <int D>
struct ContiguousSeqs {
  static constexpr int kDim = D;
  const int* lengths;
  int length_all, T, H, Hkv, S_max;
  struct Seq {
    long long q_base, kv_base;
    int kv_row, kv_hi, rows, len, T, H, group, hk;
    __device__ __forceinline__ long long row(int r) const {
      return q_base + ((long long)(r / group) * H + hk * group + r % group) *
                          D;
    }
    __device__ __forceinline__ int lim(int r) const {
      return len - T + r / group + 1;   // keys < lim: kpos <= qpos
    }
    __device__ __forceinline__ long long key(int k) const {
      return kv_base + (long long)k * D;
    }
    __device__ __forceinline__ int run(int) const { return 1 << 30; }
    // the staged body's rows: cache[b, hk] is kv_row.. of [B Hkv S_max, D]
    __device__ __forceinline__ int page_of(int) const { return 0; }
    __device__ __forceinline__ int box_row(int k, int) const {
      return kv_row + k;
    }
  };
  __device__ __forceinline__ Seq seq(int b, int hk) const {
    const int len = lengths != nullptr ? lengths[b] : length_all;
    const int group = H / Hkv;
    const int kv_row = (b * Hkv + hk) * S_max;
    return Seq{(long long)b * T * H * D, (long long)kv_row * D, kv_row,
               max(0, min(len, S_max)), T * group, len, T, H, group, hk};
  }
};

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

template <typename T, int D>
int launch_prefill(const dsdecode::SplitParams<ContiguousSeqs<D>>& p, int B,
                   cudaStream_t stream) {
  constexpr int ROWS = 16;
  const ContiguousSeqs<D>& c = p.seqs;
  const int n_rows = c.T * (c.H / c.Hkv);
  dim3 grid((n_rows + ROWS - 1) / ROWS, c.Hkv, B);
  decode_attention_kernel<T, D, ROWS><<<grid, dsattn::kThreads, 0, stream>>>(
      static_cast<const T*>(p.q), static_cast<const T*>(p.k),
      static_cast<const T*>(p.v), static_cast<T*>(p.o), c.lengths,
      c.length_all, c.T, c.H, c.Hkv, c.S_max, p.scale);
  return (int)cudaGetLastError();
}

// One call at head dim D: the decode form for rows <= kMaxRows, else the
// prefill form.
template <int D>
int run(const void* q, const void* k, const void* v, void* o,
        const void* lengths, void* part, int length_all, int B, int T, int H,
        int Hkv, int S_max, int dtype, int n_split, int chunk, float scale,
        cudaStream_t s) {
  dsdecode::SplitParams<ContiguousSeqs<D>> p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.part = static_cast<float*>(part);
  p.seqs = ContiguousSeqs<D>{static_cast<const int*>(lengths), length_all, T,
                             H, Hkv, S_max};
  p.Hkv = Hkv;
  p.n_split = n_split;
  p.chunk = chunk;
  p.scale = scale;
  p.kv_rows = (long long)B * Hkv * S_max;
  p.box_rows = dsdecode::kStagedKeys;   // staged body: a tile a box
  const int rows = T * (H / Hkv);
  if (rows <= dsdecode::kMaxRows)
    return dtype == 0   ? dsdecode::launch_rows<float>(p, B, rows, s)
           : dtype == 1 ? dsdecode::launch_rows<__nv_bfloat16>(p, B, rows, s)
                        : dsdecode::launch_rows<__half>(p, B, rows, s);
  if (n_split != 1) return (int)cudaErrorInvalidValue;
  return dtype == 0   ? launch_prefill<float, D>(p, B, s)
         : dtype == 1 ? launch_prefill<__nv_bfloat16, D>(p, B, s)
                      : launch_prefill<__half, D>(p, B, s);
}

}  // namespace

// q: [B, T, H, D]; k/v: [B, Hkv, S_max, D]; o: [B, T, H, D].  dtype: 0 =
// float32, 1 = bfloat16, 2 = float16 (fp32 inside, as bf16); D is 16, 64,
// 80, 96, 128 or 256.  lengths may be null: then every sequence has
// length_all valid tokens.  The decode form (T * H / Hkv <= 8) splits each sequence's
// keys into n_split chunks of ``chunk`` keys (n_split * chunk >= S_max);
// with n_split > 1 ``part`` is fp32 scratch of B * Hkv * n_split * T *
// (H / Hkv) * (D + 2) floats.  The prefill form takes n_split = 1 and no
// scratch.  Returns cudaGetLastError().
extern "C" int ds_decode_attention(const void* q, const void* k,
                                   const void* v, void* o,
                                   const void* lengths, void* part,
                                   int length_all, int B, int T, int H,
                                   int Hkv, int S_max, int D, int dtype,
                                   int n_split, int chunk, float scale,
                                   void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 ||
      Hkv > 65535 || !dsdecode::head_dim_taken(D) || dtype < 0 ||
      dtype > 2 || n_split <= 0 || n_split > 65535 || chunk <= 0 ||
      (long long)n_split * chunk < S_max || (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = dsdecode::with_head_dim(D, [&](auto d) {
    return run<decltype(d)::value>(q, k, v, o, lengths, part, length_all, B,
                                   T, H, Hkv, S_max, dtype, n_split, chunk,
                                   scale, s);
  });
  return rc < 0 ? -rc : rc;
}

// Blocks of the decode form (T * H / Hkv = rows <= 8 query rows per kv
// head) at head dim D that the current card holds at once; the wrapper
// sizes n_split by it.  Returns a negative CUDA error code on failure.
extern "C" int ds_decode_attention_slots(int rows, int D, int dtype) {
  if (dtype < 0 || dtype > 2) return -(int)cudaErrorInvalidValue;
  return dsdecode::with_head_dim(D, [&](auto d) {
    using S = ContiguousSeqs<decltype(d)::value>;
    return dtype == 0   ? dsdecode::split_slots<float, S>(rows)
           : dtype == 1 ? dsdecode::split_slots<__nv_bfloat16, S>(rows)
                        : dsdecode::split_slots<__half, S>(rows);
  });
}
