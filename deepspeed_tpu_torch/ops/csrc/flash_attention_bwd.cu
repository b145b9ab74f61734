// Flash attention backward for Hopper (sm_90a): two kernels, as on the TPU.
//
// Replaces deepspeed_tpu/ops/pallas/flash_attention.py: _bwd_dq_kernel
// and _bwd_dq_kernel_biased (body _bwd_dq_impl), _bwd_dkv_kernel and
// _bwd_dkv_kernel_biased (body _bwd_dkv_impl); host side
// _flash_bwd_pallas.  Both recompute P = exp(scale * Q K^T - LSE) tile by
// tile from the forward's fp32 LSE, zeroing it where the masked score is
// <= -1e30 / 2 (so a masked entry contributes exactly 0), and use
// delta = sum_d dO * O (fp32 [B, H, S], computed by the wrapper):
//   dS = P * (dO V^T - delta) * scale
//   dQ = sum over key tiles of dS K          (one block per q tile)
//   dK = sum over q tiles of dS^T Q,  dV = sum over q tiles of P^T dO
//                                            (one block per key tile)
// dQ is stored in q's dtype.  dK and dV are stored in fp32 per QUERY head
// ([B, S, H, D]); the wrapper sums them over the GQA group and casts, as
// _flash_bwd_pallas does, so no atomics are needed and runs repeat bit for
// bit.  The biased instantiations add slope[h] * key after the scale and
// mask keys outside the sliding window, as the TPU kernels do; the dQ
// kernel's key loop starts at the first tile the window reaches, and the
// dK/dV kernel's q loop ends after the last q tile that can see its keys.
// Any S is taken: ragged last tiles are masked.
//
// What bounds them on the H100: at the training shape (B=2, S=1024, 16
// heads of 128, causal, bf16) dQ does 3*B*H*S^2*D = 12.9 GFLOP on 42 MB,
// 307 flop per byte, over the ~295 flop/byte ridge: the tensor cores
// bound it (13.0 us).  dK/dV does 4*B*H*S^2*D = 17.2 GFLOP on 51 MB (dK
// and dV counted in k's dtype at Hkv heads, as the function returns them),
// 340 flop per byte: the tensor cores bound it too (17.4 us).  This
// kernel's fp32 per-query-head outputs write 34 MB more than that.  The
// biased kernels at S=2048 do 4x the work of S=1024 with ALiBi, and a
// window of 256 leaves 491,648 of the 2,098,176 causal (q, k) pairs: both
// are bound by operations, as here.
//
// Design (first version: right before fast).  256 threads, fp32 products
// on the CUDA cores (flash_tile.cuh).  The TPU grid's sequential axis is a
// loop inside the block: the dQ block walks key tiles up to its causal
// frontier; the dK/dV block walks q tiles from its own diagonal
// (k0 / BQ -- the TPU's ki * block_k // block_q with equal tiles) to S.
// Both keep their two operand pairs (Q, dO and K, V) in shared memory at
// once, ~150-170 KB, so one block runs per SM.  wgmma/TMA are later work.
#include "flash_tile.cuh"

namespace {

using namespace dsflash;

// Per-row P and dS of one (q tile, key tile) pair from the shared Q, dO,
// K, V tiles; row r of the q tile is query q0 + r, column c key k0 + c.
// s, dp: this thread's scores and dO V^T; writes P (if p_s) and dS.
template <bool SLOPE, bool WINDOW>
__device__ __forceinline__ void probs_and_ds(
    float (&s)[4][4], float (&dp)[4][4], const float* __restrict__ lse_s,
    const float* __restrict__ dl_s, float* __restrict__ p_s,
    float* __restrict__ ds_s, int q0, int k0, int S, float scale, int causal,
    const Bias<SLOPE, WINDOW>& bias, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const float x = masked(SLOPE ? __fmul_rn(s[i][j], scale)
                                   : s[i][j] * scale,
                             q0 + r, k0 + c, S, causal, bias);
      const float p = x <= kNeg / 2 ? 0.f : expf(x - lse_s[r]);
      if (p_s != nullptr) p_s[r * PT + c] = p;
      ds_s[r * PT + c] = p * (dp[i][j] - dl_s[r]) * scale;
    }
}

// lse / delta of rows [q0, q0 + BQ) of head bh -> shared (0 past S)
__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int bh, int q0, int S) {
  if (threadIdx.x < BQ) {
    const int row = q0 + threadIdx.x;
    const long long at = (long long)bh * S + row;
    lse_s[threadIdx.x] = row < S ? lse[at] : 0.f;
    dl_s[threadIdx.x] = row < S ? delta[at] : 0.f;
  }
}

template <int I, int J>
__device__ __forceinline__ void zero(float (&a)[I][J]) {
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) a[i][j] = 0.f;
}

constexpr size_t kDqSmemFloats = 4 * 64 * PD + BQ * PT + 2 * BQ;

template <typename T, bool SLOPE, bool WINDOW>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const float* __restrict__ slopes, int window, int S,
                    int H, int Hkv, float scale, int causal) {
  extern __shared__ float smem[];
  float* q_s = smem;             // [BQ][PD]
  float* do_s = q_s + BQ * PD;   // [BQ][PD]
  float* k_s = do_s + BQ * PD;   // [BK][PD]
  float* v_s = k_s + BK * PD;    // [BK][PD]
  float* ds_s = v_s + BK * PD;   // [BQ][PT]
  float* lse_s = ds_s + BQ * PT;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const Heads hd(S, H, Hkv);
  const Bias<SLOPE, WINDOW> bias(slopes, hd.h, window);
  load_tile<T>(q_s, q, hd.q_base, hd.q_stride, q0, S, 1.f);
  load_tile<T>(do_s, dout, hd.q_base, hd.q_stride, q0, S, 1.f);
  load_rows(lse_s, dl_s, lse, delta, hd.bh, q0, S);

  float acc[4][8];
  zero(acc);
  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  for (int k0 = bias.key_lo(q0); k0 < kv_hi; k0 += BK) {
    __syncthreads();  // previous dS K done
    load_tile<T>(k_s, k, hd.kv_base, hd.kv_stride, k0, S, 1.f);
    load_tile<T>(v_s, v, hd.kv_base, hd.kv_stride, k0, S, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    gemm_nt<4, 4, D, PD, PD>(s, q_s, k_s, ty, tx);
    gemm_nt<4, 4, D, PD, PD>(dp, do_s, v_s, ty, tx);
    probs_and_ds(s, dp, lse_s, dl_s, nullptr, ds_s, q0, k0, S, scale, causal,
                 bias, ty, tx);
    __syncthreads();
    gemm_nn<4, 8, BK, PT, PD>(acc, ds_s, k_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + ty + 16 * i;
    if (qrow < S) {
      T* row = dq + hd.q_base + (long long)qrow * hd.q_stride;
#pragma unroll
      for (int j = 0; j < 8; ++j) row[tx + 16 * j] = from_f<T>(acc[i][j]);
    }
  }
}

constexpr size_t kDkvSmemFloats = 4 * 64 * PD + 2 * BQ * PT + 2 * BQ;

template <typename T, bool SLOPE, bool WINDOW>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, const float* __restrict__ slopes,
                     int window, int S, int H, int Hkv, float scale,
                     int causal) {
  extern __shared__ float smem[];
  float* k_s = smem;             // [BK][PD]
  float* v_s = k_s + BK * PD;    // [BK][PD]
  float* q_s = v_s + BK * PD;    // [BQ][PD]
  float* do_s = q_s + BQ * PD;   // [BQ][PD]
  float* p_s = do_s + BQ * PD;   // [BQ][PT]
  float* ds_s = p_s + BQ * PT;   // [BQ][PT]
  float* lse_s = ds_s + BQ * PT;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * BK;
  const Heads hd(S, H, Hkv);
  const Bias<SLOPE, WINDOW> bias(slopes, hd.h, window);
  load_tile<T>(k_s, k, hd.kv_base, hd.kv_stride, k0, S, 1.f);
  load_tile<T>(v_s, v, hd.kv_base, hd.kv_stride, k0, S, 1.f);

  float dk_acc[4][8], dv_acc[4][8];
  zero(dk_acc);
  zero(dv_acc);
  // causal: q tiles before this key tile's diagonal see none of its keys;
  // window: q tiles from q_hi on are past the window of all of them
  const int q_hi = bias.q_hi(k0, S);
  for (int q0 = causal ? k0 : 0; q0 < q_hi; q0 += BQ) {
    __syncthreads();  // previous tile's products done
    load_tile<T>(q_s, q, hd.q_base, hd.q_stride, q0, S, 1.f);
    load_tile<T>(do_s, dout, hd.q_base, hd.q_stride, q0, S, 1.f);
    load_rows(lse_s, dl_s, lse, delta, hd.bh, q0, S);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    gemm_nt<4, 4, D, PD, PD>(s, q_s, k_s, ty, tx);
    gemm_nt<4, 4, D, PD, PD>(dp, do_s, v_s, ty, tx);
    probs_and_ds(s, dp, lse_s, dl_s, p_s, ds_s, q0, k0, S, scale, causal,
                 bias, ty, tx);
    __syncthreads();
    gemm_tn<4, 8, BQ, PT, PD>(dv_acc, p_s, do_s, ty, tx);
    gemm_tn<4, 8, BQ, PT, PD>(dk_acc, ds_s, q_s, ty, tx);
  }

  // fp32, per query head: row `key` of head h in the [B, S, H, D] layout
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key < S) {
      const long long at = hd.q_base + (long long)key * hd.q_stride;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dk[at + tx + 16 * j] = dk_acc[i][j];
        dv[at + tx + 16 * j] = dv_acc[i][j];
      }
    }
  }
}

template <typename T, bool SLOPE, bool WINDOW>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq,
              const void* slopes, int window, int B, int S, int H, int Hkv,
              int causal, float scale, cudaStream_t stream) {
  const size_t smem = kDqSmemFloats * sizeof(float);
  // once per instantiation, before any graph capture can be running
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, SLOPE, WINDOW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<T, SLOPE, WINDOW><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), static_cast<const float*>(slopes), window, S, H,
      Hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, bool SLOPE, bool WINDOW>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const void* slopes, int window, int B, int S, int H, int Hkv,
               int causal, float scale, cudaStream_t stream) {
  const size_t smem = kDkvSmemFloats * sizeof(float);
  // once per instantiation, before any graph capture can be running
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, SLOPE, WINDOW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((S + BK - 1) / BK, B * H);
  flash_bwd_dkv_kernel<T, SLOPE, WINDOW><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<const float*>(slopes), window, S, H, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq_biased(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, const void* slopes, int window, int B, int S,
                     int H, int Hkv, int causal, float scale,
                     cudaStream_t stream) {
  return with_bias(slopes, window, [&](auto slope, auto win) {
    return launch_dq<T, decltype(slope)::value, decltype(win)::value>(
        q, k, v, dout, lse, delta, dq, slopes, window, B, S, H, Hkv, causal,
        scale, stream);
  });
}

template <typename T>
int launch_dkv_biased(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, const void* slopes, int window,
                      int B, int S, int H, int Hkv, int causal, float scale,
                      cudaStream_t stream) {
  return with_bias(slopes, window, [&](auto slope, auto win) {
    return launch_dkv<T, decltype(slope)::value, decltype(win)::value>(
        q, k, v, dout, lse, delta, dk, dv, slopes, window, B, S, H, Hkv,
        causal, scale, stream);
  });
}

}  // namespace

// q/dout/dq: [B, S, H, D]; k/v: [B, S, Hkv, D] (one dtype: 0 = float32,
// 1 = bfloat16); lse/delta: fp32 [B, H, S].  slopes: fp32 [H] ALiBi slopes
// or null; window: the sliding window, <= 0 for none.  D must be 128.
// Return cudaGetLastError().
extern "C" int ds_flash_attention_bwd_dq(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq, const void* slopes, int B,
                                         int S, int H, int Hkv, int D,
                                         int causal, int dtype, int window,
                                         float scale, void* stream) {
  const int bad = dsflash::check_shape(B, S, H, Hkv, D);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dq_biased<float>(q, k, v, dout, lse, delta, dq, slopes,
                                   window, B, S, H, Hkv, causal, scale, s);
  if (dtype == 1)
    return launch_dq_biased<__nv_bfloat16>(q, k, v, dout, lse, delta, dq,
                                           slopes, window, B, S, H, Hkv,
                                           causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// dk/dv: fp32 [B, S, H, D], one row block per QUERY head (summed over the
// GQA group by the caller).
extern "C" int ds_flash_attention_bwd_dkv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dk, void* dv,
                                          const void* slopes, int B, int S,
                                          int H, int Hkv, int D, int causal,
                                          int dtype, int window, float scale,
                                          void* stream) {
  const int bad = dsflash::check_shape(B, S, H, Hkv, D);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dkv_biased<float>(q, k, v, dout, lse, delta, dk, dv,
                                    slopes, window, B, S, H, Hkv, causal,
                                    scale, s);
  if (dtype == 1)
    return launch_dkv_biased<__nv_bfloat16>(q, k, v, dout, lse, delta, dk,
                                            dv, slopes, window, B, S, H, Hkv,
                                            causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
