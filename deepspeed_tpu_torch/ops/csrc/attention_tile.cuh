// Shared body of the two attention kernels of the serving path
// (decode_attention.cu, ragged_paged_attention.cu): ROWS query rows of one
// block attend over keys [0, kv_hi) with a causal mask and an fp32 online
// softmax, exactly the arithmetic of the Pallas kernels they replace
// (running max m, running sum l, accumulator acc; rows that see no key
// finalise to 0).  The caller fills the per-row metadata in shared memory
// and hands a functor mapping a key index to the element offset of its K/V
// row, which is where the contiguous and the paged cache differ.
//
// One block = 128 threads and ROWS (4 or 16) query rows, head dim D = 16,
// 64, 80, 96, 128 or 256.  Per key block of BK keys (kBK = 64; 16 at D = 256,
// where 64 fp32 key rows alone would take 64 KB of shared memory and 32
// rows beside the 16 fp32 q rows of 1 KB each still exceed the 48 KB a
// block has without opting in):
//   1. K rows -> shared (16-byte vector loads, the block's 128 threads
//      walking the tile's BK * D / VEC vectors in order, stored as fp32
//      with row pitch D+1 so the dot-product reads of neighbouring threads
//      hit different banks);
//   2. scores: thread (key = tid % BK, ROWS * BK / 128 rows) -- the q
//      rows are broadcast reads, the K row is private to the thread;
//   3. online softmax: one warp per row, keys lane and lane + 32 per lane
//      (at BK = 16 half the lanes hold one key, the rest none);
//   4. V rows -> shared, then acc[row][d] += p[row][:] . V[:, d], the
//      ROWS * D outputs dealt to the threads in order (element tid + 128 i
//      of the [ROWS][D] tile to thread tid), each thread owning
//      ceil(ROWS * D / 128) accumulators in registers.
// Nothing carries between blocks: the TPU kernel's sequential key-block
// grid axis is the loop below.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dsattn {

constexpr float kNeg = -1e30f;
constexpr int kBK = 64;       // keys per inner step
constexpr int kThreads = 128;

// Keys per inner step at head dim D: kBK, and 16 at 256 (see above).
template <int D>
__host__ __device__ constexpr int keys_per_step() {
  return D > 128 ? 16 : kBK;
}

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);   // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The largest divisor of n that is at most 8.
__host__ __device__ constexpr int batch_of(int n) {
  int b = n < 8 ? n : 8;
  while (n % b != 0) --b;
  return b;
}

// Keys [kb, kb + BK) of K or V -> dst (fp32, zero past kv_hi).  A key row
// is LANES = D / VEC 16-byte vectors; the tile's BK * LANES vectors go to
// the threads in order (vector tid + 128 p to thread tid in pass p), so
// at D = 16, 64 and 128, where LANES divides 128, a thread keeps one column
// of every row it loads (at 16 a row is 2 or 4 vectors: 64 or 32 rows a
// pass), and at D = 80 and 96 (10 or 12 vectors a row in
// bf16 / fp16, 20 or 24 in fp32) rows straddle threads and no lane idles.
// A thread resolves the row offset of each of its vectors (for the paged
// cache: one block-table read per vector, not per element), then issues
// a batch of independent loads before storing any of them, so up to eight
// loads per thread are in flight at once.
template <typename T, int D, int BK, typename KeyOffset>
__device__ __forceinline__ void load_rows(float (*dst)[D + 1],
                                          const T* __restrict__ src, int kb,
                                          int kv_hi, const KeyOffset& key_off) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LANES = D / VEC;                      // vectors per key row
  constexpr int PASSES = BK * LANES / kThreads;       // vectors per thread
  constexpr int BATCH = batch_of(PASSES);
  static_assert(D % VEC == 0 && BK * LANES % kThreads == 0, "tile shape");
#pragma unroll
  for (int p0 = 0; p0 < PASSES; p0 += BATCH) {
    uint4 buf[BATCH];
#pragma unroll
    for (int p = 0; p < BATCH; ++p) {
      const int i = (p0 + p) * kThreads + threadIdx.x;
      const int key = kb + i / LANES;
      buf[p] = key < kv_hi
                   ? __ldg(reinterpret_cast<const uint4*>(
                         src + key_off(key) + (i % LANES) * VEC))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int p = 0; p < BATCH; ++p) {
      const int i = (p0 + p) * kThreads + threadIdx.x;
      const int j = i / LANES, c = (i % LANES) * VEC;
      const T* e = reinterpret_cast<const T*>(&buf[p]);
#pragma unroll
      for (int x = 0; x < VEC; ++x) dst[j][c + x] = to_f(e[x]);
    }
  }
}

// Per-row metadata, filled by the calling kernel (threads 0..ROWS-1)
// before the call; a __syncthreads() inside orders it.
template <int ROWS>
struct RowMeta {
  long long off[ROWS];    // element offset of the row in q and in o
  int qpos[ROWS];         // absolute position of the query token
  int valid[ROWS];        // 0: padding row, neither read nor written
};

// ROWS = 4 serves decode (one query token per sequence, a GQA group of at
// most 4 heads per kv head) without computing 12 dead rows; ROWS = 16
// serves prefill tiles.
template <typename T, int D, int ROWS, typename KeyOffset>
__device__ __forceinline__ void attend_rows(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float scale, int kv_hi,
    const KeyOffset& key_off, const RowMeta<ROWS>& rm) {
  static_assert(D == 16 || D == 64 || D == 80 || D == 96 || D == 128 ||
                    D == 256,
                "head_dim must be 16, 64, 80, 96, 128 or 256");
  static_assert(ROWS == 4 || ROWS == 16, "ROWS must be 4 or 16");
  constexpr int BK = keys_per_step<D>();
  static_assert(BK <= 64, "the softmax gives a lane two keys at most");
  // outputs per thread: element tid + kThreads * r of the [ROWS][D] tile
  constexpr int RPT = (ROWS * D + kThreads - 1) / kThreads;
  constexpr int SR = ROWS * BK / kThreads;   // score rows per thread
  __shared__ float q_s[ROWS][D];
  __shared__ float kv_s[BK][D + 1];
  __shared__ float p_s[ROWS][BK];
  __shared__ float m_s[ROWS], l_s[ROWS], c_s[ROWS];

  const int tid = threadIdx.x;
  __syncthreads();  // row metadata written by the caller
  for (int i = tid; i < ROWS * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[r][d] = rm.valid[r] ? to_f(q[rm.off[r] + d]) * scale : 0.f;
  }
  if (tid < ROWS) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  int orow[RPT], od[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int e = tid + kThreads * r;
    // past the tile (ROWS * D not a multiple of 128): no row
    orow[r] = ROWS * D % kThreads == 0 || e < ROWS * D ? e / D : -1;
    od[r] = e % D;
  }
  const int sk = tid % BK;
  const int srow0 = (tid / BK) * SR;
  const int warp = tid / 32, lane = tid % 32;
  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int kb = 0; kb < kv_hi; kb += BK) {
    load_rows<T, D, BK>(kv_s, k, kb, kv_hi, key_off);
    __syncthreads();

    float s[SR];
#pragma unroll
    for (int r = 0; r < SR; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = kv_s[sk][d];
#pragma unroll
      for (int r = 0; r < SR; ++r) s[r] = fmaf(q_s[srow0 + r][d], kd, s[r]);
    }
    const int key = kb + sk;
#pragma unroll
    for (int r = 0; r < SR; ++r) {
      const int row = srow0 + r;
      const bool ok = rm.valid[row] && key < kv_hi && key <= rm.qpos[row];
      p_s[row][sk] = ok ? s[r] : kNeg;
    }
    __syncthreads();  // scores complete; K no longer read

    for (int row = warp; row < ROWS; row += kThreads / 32) {
      // keys lane and lane + 32 of the step; past BK (at BK = 16) masked
      const float a = lane < BK ? p_s[row][lane] : kNeg;
      const float b = lane + 32 < BK ? p_s[row][lane + 32] : kNeg;
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(a, b)));
      float pa = expf(a - m_new), pb = expf(b - m_new);
      if (m_new <= kNeg / 2) pa = pb = 0.f;
      if (lane < BK) p_s[row][lane] = pa;
      if (lane + 32 < BK) p_s[row][lane + 32] = pb;
      const float sum = warp_sum(pa + pb);
      if (lane == 0) {
        const float corr = m_prev <= kNeg / 2 ? 0.f : expf(m_prev - m_new);
        m_s[row] = m_new;
        l_s[row] = l_s[row] * corr + sum;
        c_s[row] = corr;
      }
    }
    load_rows<T, D, BK>(kv_s, v, kb, kv_hi, key_off);
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = orow[r];
      if (row < 0) continue;
      float a = acc[r] * c_s[row];
      if constexpr (D == 16) {
        // the step's 64 keys unrolled whole: at 8 a time ptxas spilled
        // 8 B of the fp32 paged tile at this head dim to meet a 56-register
        // target (no spill and 55 registers so, in every dtype)
#pragma unroll
        for (int j = 0; j < BK; ++j) a = fmaf(p_s[row][j], kv_s[j][od[r]], a);
      } else {
#pragma unroll 8
        for (int j = 0; j < BK; ++j) a = fmaf(p_s[row][j], kv_s[j][od[r]], a);
      }
      acc[r] = a;
    }
    __syncthreads();  // before the next block overwrites kv_s and p_s
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = orow[r];
    if (row >= 0 && rm.valid[row]) {
      const float l = fmaxf(l_s[row], 1e-30f);
      o[rm.off[row] + od[r]] = from_f<T>(acc[r] / l);
    }
  }
}

}  // namespace dsattn
