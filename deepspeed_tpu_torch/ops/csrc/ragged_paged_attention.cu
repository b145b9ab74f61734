// Ragged paged attention for Hopper (sm_90a): one kernel for decode,
// prefill and mixed ragged batches over a paged KV cache.
//
// Replaces the TPU kernel
// deepspeed_tpu/ops/pallas/ragged_paged_attention.py: _ragged_kernel
// (host side _ragged_call / _pack_metadata).  Computes, for each sequence
// s, the causal attention of its last q_lens[s] tokens over its ctx_lens[s]
// cached tokens (queries included), with K/V pages [P, Hkv, page, D] read
// in place through block_tables[s].  The queries are a packed, unpadded
// [total_q, H, D] stack; sequence s's rows start at q_offs[s].  A tile is
// q_tile query tokens of one sequence (seq_of_tile / qtile_of_tile, the
// TPU kernel's metadata) and reads only the keys below its causal frontier
// ctx - qlen + min(qlen, (qt + 1) * q_tile).  Padding rows (local token >=
// qlen) are neither read nor written; rows that see no key give 0.
//
// What bounds it on the H100: decode reads each sequence's K/V pages once
// for ~1 flop per byte -- HBM bandwidth (3.35 TB/s) is the bound, and the
// gather path it replaces moved the max-length padded view three times.
// Prefill tiles are bounded by arithmetic.
//
// Design (first version; wgmma/TMA, split-K over long contexts and
// persistent blocks are later work): grid (tiles, Hkv, row chunks), one
// 128-thread block per (q tile, kv head, row chunk of the tile's
// q_tile*group rows) -- 4-row chunks for decode tiles of at most 4 rows,
// 16-row chunks otherwise.  The TPU kernel's sequential page grid axis becomes
// the key loop inside the block; each key's page is resolved through the
// block table as it is loaded, so shared prefix pages and partial last
// pages are read in place and no padded view is ever built.
#include "attention_tile.cuh"

namespace {

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

template <typename T, int D, int ROWS>
void launch_rows(const void* q, const void* kp, const void* vp, void* o,
                 const int* ctx, const int* qlens, const int* qoffs,
                 const int* sot, const int* qot, const int* tables,
                 int n_tiles, int max_pages, int H, int Hkv, int page_size,
                 int q_tile, float scale, cudaStream_t stream) {
  const int tile_rows = q_tile * (H / Hkv);
  dim3 grid(n_tiles, Hkv, (tile_rows + ROWS - 1) / ROWS);
  ragged_paged_attention_kernel<T, D, ROWS>
      <<<grid, dsattn::kThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(kp),
          static_cast<const T*>(vp), static_cast<T*>(o), ctx, qlens, qoffs,
          sot, qot, tables, max_pages, H, Hkv, page_size, q_tile, scale);
}

// decode tiles (q_tile * group <= 4 rows) take the 4-row tile
template <typename T, int D>
void launch(const void* q, const void* kp, const void* vp, void* o,
            const int* ctx, const int* qlens, const int* qoffs,
            const int* sot, const int* qot, const int* tables, int n_tiles,
            int max_pages, int H, int Hkv, int page_size, int q_tile,
            float scale, cudaStream_t stream) {
  if (q_tile * (H / Hkv) <= 4)
    launch_rows<T, D, 4>(q, kp, vp, o, ctx, qlens, qoffs, sot, qot, tables,
                         n_tiles, max_pages, H, Hkv, page_size, q_tile,
                         scale, stream);
  else
    launch_rows<T, D, 16>(q, kp, vp, o, ctx, qlens, qoffs, sot, qot, tables,
                          n_tiles, max_pages, H, Hkv, page_size, q_tile,
                          scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D must be 128.  All metadata arrays
// are int32 on the device.  Returns cudaGetLastError().
extern "C" int ds_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages, void* o,
    const void* ctx_lens, const void* q_lens, const void* q_offs,
    const void* seq_of_tile, const void* qtile_of_tile, const void* tables,
    int n_tiles, int max_pages, int H, int Hkv, int page_size, int q_tile,
    int D, int dtype, float scale, void* stream) {
  if (n_tiles <= 0 || Hkv <= 0 || H % Hkv != 0 || page_size <= 0 ||
      q_tile <= 0 || max_pages <= 0 || Hkv > 65535 ||
      (q_tile * (H / Hkv) + 3) / 4 > 65535)
    return (int)cudaErrorInvalidValue;
  const int* c = static_cast<const int*>(ctx_lens);
  const int* ql = static_cast<const int*>(q_lens);
  const int* qo = static_cast<const int*>(q_offs);
  const int* st = static_cast<const int*>(seq_of_tile);
  const int* qt = static_cast<const int*>(qtile_of_tile);
  const int* tb = static_cast<const int*>(tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_LAUNCH(T_, D_)                                                    \
  launch<T_, D_>(q, k_pages, v_pages, o, c, ql, qo, st, qt, tb, n_tiles,      \
                 max_pages, H, Hkv, page_size, q_tile, scale, s)
  if (dtype == 0 && D == 128)
    DS_LAUNCH(float, 128);
  else if (dtype == 1 && D == 128)
    DS_LAUNCH(__nv_bfloat16, 128);
  else
    return (int)cudaErrorInvalidValue;
#undef DS_LAUNCH
  return (int)cudaGetLastError();
}
