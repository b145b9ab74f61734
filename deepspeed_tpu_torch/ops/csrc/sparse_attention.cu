// Block-sparse attention forward for Hopper (sm_90a): softmax(scale * Q
// K^T) V over the key blocks a static [H, nb, nb] layout sets, causal on
// the diagonal block when asked.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/sparse_attention.py:
// _sparse_kernel (host side sparse_attention_pallas and layout_tables).
// Same arithmetic: the host turns the layout into counts [H, nb] and a
// table [H, nb, max_active] of the set key blocks of each (head, q block)
// (the upper triangle dropped when causal); the kernel walks count[h][qi]
// entries of table[h][qi] with an fp32 online softmax (running max m, sum
// l, accumulator acc; masked scores -1e30), and a row that sees no key --
// a q block with no set block -- finalises to 0 (acc 0 / max(l, 1e-30)).
// Forward only, as on the TPU.
//
// What bounds it on the H100: B * sparse_flops = 4 * set blocks * block^2
// * D operations per batch row, on q, k, v and o read or written once.  At
// S=4096, 16 heads, Fixed (block 16, unidirectional) sets 13% of all
// blocks (26% of the causal ones), BigBird (block 64, bidirectional) 12%:
// both are below the ~295 flop/byte ridge in bf16, so the bytes bound
// them, and the kernel's time should scale with the set blocks, not S^2.
//
// Design (first version: right before fast).  One block of 256 threads per
// (q block, batch * head); the TPU grid's active-block axis is the loop
// over the table inside the block, which loads the block's own indices
// (the TPU's scalar prefetch).  Q, then each set K block and V block in
// turn, sit in shared memory as fp32 with padded pitch; the two products
// run on the CUDA cores in fp32 (flash_tile.cuh's products, thread (ty, tx)
// = (tid / 16, tid % 16) owning rows ty + 16 i and columns tx + 16 j), so
// every layout block (16, 32, 64, 128) and head dim (64, 128) is one
// template.  Small blocks leave most of the 256 threads little work per
// key block, and nothing here uses the tensor cores: wgmma tiles are
// later work.
#include "flash_tile.cuh"

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

// q/k/v/o: [B, S, H, D], one dtype (0 = float32, 1 = bfloat16), D 64 or
// 128; counts: int32 [H, S / block]; table: int32 [H, S / block,
// max_active]; block 16, 32, 64 or 128 and S a multiple of it.  Returns
// cudaGetLastError().
extern "C" int ds_sparse_attention(const void* q, const void* k,
                                   const void* v, void* o, const void* counts,
                                   const void* table, int B, int S, int H,
                                   int D, int block, int max_active,
                                   int causal, int dtype, float scale,
                                   void* stream) {
  if (B <= 0 || H <= 0 || block <= 0 || S <= 0 || S % block != 0 ||
      max_active <= 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(q, k, v, o, counts, table, B, S, H, D, block,
                             max_active, causal, scale, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(q, k, v, o, counts, table, B, S, H, D,
                                     block, max_active, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
