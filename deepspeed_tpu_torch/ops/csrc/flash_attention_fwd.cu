// Flash attention forward for Hopper (sm_90a): the training path's
// attention, O = softmax(scale * Q K^T, causal) V, and the row
// log-sum-exp LSE that the backward kernels recompute P from.
//
// Replaces the TPU kernels deepspeed_tpu/ops/pallas/flash_attention.py:
// _fwd_kernel and _fwd_kernel_biased (body _fwd_impl; host side
// _flash_fwd).  Same arithmetic: fp32 online softmax (running max m, sum
// l, accumulator acc), masked scores -1e30, rows that see no key finalise
// to 0, LSE = m + log(l) in fp32 [B, H, S].  The biased instantiations add
// slope[h] * key to the scaled score and mask keys outside a sliding
// window (flash_tile.cuh's Bias); the key loop then starts at the first
// tile the window reaches, as _k_range skips far-past blocks.  Unlike the
// TPU entry, which sends every S that is not a multiple of its block to
// the jnp reference, this kernel takes any S: the last q tile and the last
// key tile are masked.
//
// What bounds it on the H100: causal attention at the training shape
// (B=2, S=1024, 16 heads of 128, bf16) does 2*B*H*S^2*D = 8.6 GFLOP on
// 34 MB (q, k, v, o and the fp32 LSE), 255 flop per byte -- just under the
// ~295 flop/byte ridge, so the bytes bound it (10.1 us at 3.35 TB/s),
// with the tensor cores' time (8.7 us at 989 TFLOP/s) close behind.
// The biased kernels at BLOOM-1b7's shape (B=2, S=2048, ALiBi) do 4x that
// work on 2x the bytes and are bound by operations; a window of 256 at
// S=2048 leaves 491,648 of the 2,098,176 causal (q, k) pairs, and the key
// loop visits 5 of the up to 32 key tiles of a q tile.
//
// Design (first version: right before fast).  One block of 256 threads
// per (64-row q tile, batch * head); the TPU kernel's sequential key-block
// grid axis is the loop over 64-key tiles inside the block, which stops at
// the tile's causal frontier (as _k_range does).  Q, then K and V in turn,
// sit in shared memory as fp32; the products run on the CUDA cores in
// fp32 (flash_tile.cuh), which is exact for the fp32 check and keeps one
// code path for bf16 and fp32 -- but it caps the kernel near the fp32
// FMA rate (67 TFLOP/s), far under the bound.  wgmma tiles with TMA loads
// are the next kernel PR.
#include "flash_tile.cuh"

namespace {

using namespace dsflash;

constexpr size_t kSmemFloats = 2 * 64 * PD + BQ * PT + 3 * BQ;

template <typename T, bool SLOPE, bool WINDOW>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const float* __restrict__ slopes,
                 int window, int S, int H, int Hkv, float scale, int causal) {
  extern __shared__ float smem[];
  float* q_s = smem;              // [BQ][PD] Q * scale (Q with ALiBi)
  float* kv_s = q_s + BQ * PD;    // [BK][PD] K, then V
  float* p_s = kv_s + BK * PD;    // [BQ][PT] scores, then probabilities
  float* m_s = p_s + BQ * PT;     // [BQ] running max
  float* l_s = m_s + BQ;          // [BQ] running sum
  float* c_s = l_s + BQ;          // [BQ] rescale factor of this key tile

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const Heads hd(S, H, Hkv);
  const Bias<SLOPE, WINDOW> bias(slopes, hd.h, window);

  // the ALiBi kernels scale the product, not Q (see masked())
  load_tile<T>(q_s, q, hd.q_base, hd.q_stride, q0, S, SLOPE ? 1.f : scale);
  if (tid < BQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  for (int k0 = bias.key_lo(q0); k0 < kv_hi; k0 += BK) {
    __syncthreads();  // previous tile's P V done; Q and m/l written
    load_tile<T>(kv_s, k, hd.kv_base, hd.kv_stride, k0, S, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    gemm_nt<4, 4, D, PD, PD>(s, q_s, kv_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float raw = SLOPE ? __fmul_rn(s[i][j], scale) : s[i][j];
        p_s[r * PT + c] = masked(raw, q0 + r, k0 + c, S, causal, bias);
      }
    __syncthreads();  // scores complete; K no longer read

    // online softmax: warp w owns rows 8w..8w+7, a lane two columns
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      const float a = p_s[r * PT + lane], b = p_s[r * PT + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, dsattn::warp_max(fmaxf(a, b)));
      float pa = expf(a - m_new), pb = expf(b - m_new);
      if (m_new <= kNeg / 2) pa = pb = 0.f;
      p_s[r * PT + lane] = pa;
      p_s[r * PT + lane + 32] = pb;
      const float sum = dsattn::warp_sum(pa + pb);
      if (lane == 0) {
        const float corr = m_prev <= kNeg / 2 ? 0.f : expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    load_tile<T>(kv_s, v, hd.kv_base, hd.kv_stride, k0, S, 1.f);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
    }
    gemm_nn<4, 8, BK, PT, PD>(acc, p_s, kv_s, ty, tx);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qrow = q0 + r;
    if (qrow < S) {
      const float l = fmaxf(l_s[r], 1e-30f);
      T* orow = o + hd.q_base + (long long)qrow * hd.q_stride;
#pragma unroll
      for (int j = 0; j < 8; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / l);
    }
  }
  if (tid < BQ && q0 + tid < S)
    lse[(long long)hd.bh * S + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

template <typename T, bool SLOPE, bool WINDOW>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* slopes, int window, int B, int S, int H, int Hkv,
           int causal, float scale, cudaStream_t stream) {
  const size_t smem = kSmemFloats * sizeof(float);
  // once per instantiation, before any graph capture can be running
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, SLOPE, WINDOW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, SLOPE, WINDOW><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      static_cast<const float*>(slopes), window, S, H, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_biased(const void* q, const void* k, const void* v, void* o,
                  void* lse, const void* slopes, int window, int B, int S,
                  int H, int Hkv, int causal, float scale,
                  cudaStream_t stream) {
  return with_bias(slopes, window, [&](auto slope, auto win) {
    return launch<T, decltype(slope)::value, decltype(win)::value>(
        q, k, v, o, lse, slopes, window, B, S, H, Hkv, causal, scale,
        stream);
  });
}

}  // namespace

// q: [B, S, H, D]; k/v: [B, S, Hkv, D]; o: [B, S, H, D] (q's dtype);
// lse: fp32 [B, H, S].  slopes: fp32 [H] ALiBi slopes or null; window:
// the sliding window, <= 0 for none.  dtype: 0 = float32, 1 = bfloat16;
// D must be 128.  Returns cudaGetLastError().
extern "C" int ds_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      const void* slopes, int B, int S,
                                      int H, int Hkv, int D, int causal,
                                      int dtype, int window, float scale,
                                      void* stream) {
  const int bad = dsflash::check_shape(B, S, H, Hkv, D);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_biased<float>(q, k, v, o, lse, slopes, window, B, S, H,
                                Hkv, causal, scale, s);
  if (dtype == 1)
    return launch_biased<__nv_bfloat16>(q, k, v, o, lse, slopes, window, B,
                                        S, H, Hkv, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
