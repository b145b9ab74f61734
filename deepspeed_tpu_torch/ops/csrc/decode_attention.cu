// Decode attention over a contiguous KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py:
// _decode_kernel (host side decode_attention_pallas).  Computes, for each
// sequence b, the attention of its last T tokens (already appended to the
// cache) over cache[b, :, :lengths[b]] with the causal-ragged mask
// kpos <= lengths[b] - T + t, fp32 online softmax, GQA group folded into
// the rows: row r of kv head hk is token r / group of head hk*group + r%group.
//
// What bounds it on the H100: decode (T = 1) reads every cached K/V byte
// once and does 4*D flops per key per head -- about 1 flop per byte, far
// under the card's ~295 flop/byte ridge, so HBM bandwidth (3.35 TB/s) is
// the bound.  Prefill (T = prompt) has T*group query rows per kv head and
// is bounded by arithmetic.
//
// Design (first version; wgmma/TMA and split-K over long contexts are
// later work): grid (row tiles, Hkv, B), one block of 128 threads per
// (row tile, kv head, sequence) -- 4-row tiles when a kv head has at most
// 4 query rows (decode), 16-row tiles otherwise -- so a prompt of hundreds
// of rows is tiled over the grid instead of being held in one block.  Each block
// walks its keys in blocks of 64 (the TPU kernel's sequential key-block
// grid axis becomes this loop), never reading keys at or past the tile's
// causal frontier min(length, last row's position + 1).  K/V rows are read
// once per (tile, kv head), so decode reads the cache exactly once.
#include "attention_tile.cuh"

namespace {

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

template <typename T, int D, int ROWS>
void launch_rows(const void* q, const void* k, const void* v, void* o,
                 const int* lengths, int length_all, int B, int T_, int H,
                 int Hkv, int S_max, float scale, cudaStream_t stream) {
  const int n_rows = T_ * (H / Hkv);
  dim3 grid((n_rows + ROWS - 1) / ROWS, Hkv, B);
  decode_attention_kernel<T, D, ROWS><<<grid, dsattn::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lengths, length_all, T_,
      H, Hkv, S_max, scale);
}

// decode (at most 4 query rows per kv head) takes the 4-row tile
template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o,
            const int* lengths, int length_all, int B, int T_, int H,
            int Hkv, int S_max, float scale, cudaStream_t stream) {
  if (T_ * (H / Hkv) <= 4)
    launch_rows<T, D, 4>(q, k, v, o, lengths, length_all, B, T_, H, Hkv,
                         S_max, scale, stream);
  else
    launch_rows<T, D, 16>(q, k, v, o, lengths, length_all, B, T_, H, Hkv,
                          S_max, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D must be 128.  lengths may be null:
// then every sequence has length_all valid tokens.  Returns
// cudaGetLastError().
extern "C" int ds_decode_attention(const void* q, const void* k,
                                   const void* v, void* o,
                                   const void* lengths, int length_all, int B,
                                   int T, int H, int Hkv, int S_max, int D,
                                   int dtype, float scale, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 ||
      Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128)
    launch<float, 128>(q, k, v, o, lens, length_all, B, T, H, Hkv, S_max, scale, s);
  else if (dtype == 1 && D == 128)
    launch<__nv_bfloat16, 128>(q, k, v, o, lens, length_all, B, T, H, Hkv, S_max, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
