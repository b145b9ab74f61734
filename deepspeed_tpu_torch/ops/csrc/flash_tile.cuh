// Shared pieces of the flash-attention training kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): tile loads from the
// model layout into fp32 shared memory and the three small products the
// forward and backward are made of, all in fp32 on the CUDA cores.
//
// Layout.  q, o, dO: [B, S, H, D]; k, v: [B, S, Hkv, D], contiguous, so row
// s of head h starts at ((b * S + s) * H + h) * D and rows are H * D apart.
// Query head h reads kv head h / (H / Hkv) (GQA).  D = 128.
//
// Tiles.  64 query rows by 64 keys.  A [64][D] tile is stored with pitch
// D + 1 and a [64][64] tile with pitch 65, so the column walks of the
// products below hit 16 (or 32) different banks.  A block has 256 threads;
// thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i and columns
// tx + 16 j of every product tile: a warp reads two A rows (two banks,
// broadcast to the 16 threads of each) and 16 consecutive B rows or
// columns per step.
#pragma once

#include "attention_tile.cuh"

namespace dsflash {

using dsattn::from_f;
using dsattn::kNeg;
using dsattn::to_f;

constexpr int D = 128;         // head_dim
constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int kThreads = 256;
constexpr int PD = D + 1;      // pitch of [64][D] tiles
constexpr int PT = BK + 1;     // pitch of [BQ][BK] tiles
static_assert(BQ == BK, "the dK/dV kernel starts its q loop at its k tile");

// Rows [r0, r0 + 64) of one head of a [B, S, Hx, D] tensor -> dst [64][PD]
// as fp32 times ``mul``; rows at or past S are 0.  ``base`` is the element
// offset of (b, 0, hx, 0), ``stride`` = Hx * D.  Each thread issues all its
// 16-byte loads before storing any of them.
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long base, long long stride,
                                          int r0, int S, float mul) {
  constexpr int VEC = 16 / sizeof(T);        // elements per 16-byte vector
  constexpr int LANES = D / VEC;             // vectors per row
  constexpr int PER = 64 * LANES / kThreads;  // vectors per thread
  static_assert(64 * LANES % kThreads == 0, "tile shape");
  uint4 buf[PER];
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int s = r0 + i / LANES;
    buf[it] = s < S ? __ldg(reinterpret_cast<const uint4*>(
                          src + base + (long long)s * stride +
                          (i % LANES) * VEC))
                    : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const T* e = reinterpret_cast<const T*>(&buf[it]);
    float* row = dst + (i / LANES) * PD + (i % LANES) * VEC;
#pragma unroll
    for (int x = 0; x < VEC; ++x) row[x] = to_f(e[x]) * mul;
  }
}

// acc[i][j] += sum_k A[(ty + 16 i) * PA + k] * B[(tx + 16 j) * PB + k]
// (A times B transposed: scores Q K^T, dP = dO V^T)
template <int I, int J, int KD, int PA, int PB>
__device__ __forceinline__ void gemm_nt(float (&acc)[I][J],
                                        const float* __restrict__ A,
                                        const float* __restrict__ B, int ty,
                                        int tx) {
#pragma unroll 4
  for (int k = 0; k < KD; ++k) {
    float a[I], b[J];
#pragma unroll
    for (int i = 0; i < I; ++i) a[i] = A[(ty + 16 * i) * PA + k];
#pragma unroll
    for (int j = 0; j < J; ++j) b[j] = B[(tx + 16 * j) * PB + k];
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k A[(ty + 16 i) * PA + k] * B[k * PB + tx + 16 j]
// (A times B: O += P V, dQ += dS K)
template <int I, int J, int KD, int PA, int PB>
__device__ __forceinline__ void gemm_nn(float (&acc)[I][J],
                                        const float* __restrict__ A,
                                        const float* __restrict__ B, int ty,
                                        int tx) {
#pragma unroll 4
  for (int k = 0; k < KD; ++k) {
    float a[I], b[J];
#pragma unroll
    for (int i = 0; i < I; ++i) a[i] = A[(ty + 16 * i) * PA + k];
#pragma unroll
    for (int j = 0; j < J; ++j) b[j] = B[k * PB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k A[k * PA + ty + 16 i] * B[k * PB + tx + 16 j]
// (A transposed times B: dV += P^T dO, dK += dS^T Q)
template <int I, int J, int KD, int PA, int PB>
__device__ __forceinline__ void gemm_tn(float (&acc)[I][J],
                                        const float* __restrict__ A,
                                        const float* __restrict__ B, int ty,
                                        int tx) {
#pragma unroll 4
  for (int k = 0; k < KD; ++k) {
    float a[I], b[J];
#pragma unroll
    for (int i = 0; i < I; ++i) a[i] = A[k * PA + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < J; ++j) b[j] = B[k * PB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Score of query row ``qrow`` and key ``key`` (both absolute) after the
// mask: the raw score, or kNeg where the key is past S, the query row is
// past S, or (causal) the key is after the query.
__device__ __forceinline__ float masked(float s, int qrow, int key, int S,
                                        int causal) {
  const bool ok = qrow < S && key < S && (!causal || key <= qrow);
  return ok ? s : kNeg;
}

// Block geometry shared by the three kernels: blockIdx.y = b * H + h.
struct Heads {
  long long q_base, q_stride;    // (b, 0, h, 0) of q/o/dO and its row step
  long long kv_base, kv_stride;  // (b, 0, h / group, 0) of k/v
  int bh;
  __device__ __forceinline__ Heads(int S, int H, int Hkv) {
    bh = blockIdx.y;
    const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
    q_base = ((long long)b * S * H + h) * D;
    q_stride = (long long)H * D;
    kv_base = ((long long)b * S * Hkv + hk) * D;
    kv_stride = (long long)Hkv * D;
  }
};

// Checks shared by the host entries; 0 when the launch may go ahead.
inline int check_shape(int B, int S, int H, int Hkv, int Dh) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || Dh != D ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace dsflash
