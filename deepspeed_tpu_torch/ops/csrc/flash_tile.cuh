// Shared pieces of the flash-attention training kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): tile loads from the
// model layout into fp32 shared memory and the three small products the
// forward and backward are made of, all in fp32 on the CUDA cores.
//
// Layout.  q, o, dO: [B, S, H, D]; k, v: [B, S, Hkv, D], contiguous, so row
// s of head h starts at ((b * S + s) * H + h) * D and rows are H * D apart.
// Query head h reads kv head h / (H / Hkv) (GQA).  D (the head dim) is a
// template argument, 64, 80, 96, 128 or 256 (a thread's D / 16 output
// columns: 4, 5, 6, 8 or 16).  The biased kernels read one fp32 ALiBi
// slope per QUERY head, slopes[h].
//
// Tiles.  R query rows by R keys, R = 64 (the forward at every head dim,
// the backward up to D = 128) or 32 (the backward at D = 256: four
// [64][257] fp32 tiles, 263 KB, would not fit a block's 227 KB of shared
// memory; four [32][257] take 132 KB).  An [R][D] tile is stored with
// pitch D + 1 (pitch<D>) and an [R][R] tile with pitch R + 1, so the
// column walks of the products below hit 16 (or 32) different banks.  A
// block has 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16 i and columns tx + 16 j of every product tile: a warp reads two
// A rows (two banks, broadcast to the 16 threads of each) and 16
// consecutive B rows or columns per step.
#pragma once

#include <type_traits>

#include "attention_tile.cuh"

namespace dsflash {

using dsattn::from_f;
using dsattn::kNeg;
using dsattn::to_f;

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int kThreads = 256;
constexpr int PT = BK + 1;     // pitch of [BQ][BK] tiles

// pitch of [64][D] tiles
template <int D>
__host__ __device__ constexpr int pitch() {
  static_assert(D == 64 || D == 80 || D == 96 || D == 128 || D == 256,
                "the flash kernels take D 64, 80, 96, 128 or 256");
  return D + 1;
}
static_assert(BQ == BK, "the dK/dV kernel starts its q loop at its k tile");

// Rows (= keys) of the backward's fp32 tiles at head dim D (see Tiles).
template <int D>
__host__ __device__ constexpr int bwd_rows() {
  return D == 256 ? 32 : BQ;
}

// Rows [r0, r0 + R) of one head of a [B, S, Hx, D] tensor -> dst
// [R][pitch<D>()] as fp32 times ``mul``; rows at or past S are 0.
// ``base`` is the element offset of (b, 0, hx, 0), ``stride`` = Hx * D.
// Each thread issues all its 16-byte loads before storing any of them.
template <typename T, int D, int R = 64>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long base, long long stride,
                                          int r0, int S, float mul) {
  constexpr int VEC = 16 / sizeof(T);        // elements per 16-byte vector
  constexpr int LANES = D / VEC;             // vectors per row
  constexpr int PER = R * LANES / kThreads;  // vectors per thread
  static_assert(R * LANES % kThreads == 0, "tile shape");
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
    float* row = dst + (i / LANES) * pitch<D>() + (i % LANES) * VEC;
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

// The biased kernels' bias of one query head (_mask_bias of the TPU
// kernels): ALiBi adds slope[h] * key to the score (the row-constant part
// of ALiBi cancels in the softmax), and a sliding window masks keys with
// qrow - key >= window (window <= 0: unlimited).  SLOPE and WINDOW are
// template flags, so Bias<false, false> -- the unbiased kernels -- adds no
// instruction to them.
template <bool SLOPE, bool WINDOW>
struct Bias {
  float slope;
  int window;
  __device__ __forceinline__ Bias(const float* __restrict__ slopes, int h,
                                  int w)
      : slope(SLOPE ? __ldg(slopes + h) : 0.f), window(WINDOW ? w : 0) {}

  // First key of the first key tile (of R keys) that q rows [q0, q0 + R)
  // can see: the tile of key q0 - (window - 1), floored to a tile, or 0
  // (_k_range's lo).
  template <int R = BK>
  __device__ __forceinline__ int key_lo(int q0) const {
    if (!WINDOW || window <= 0) return 0;
    const int first = q0 - (window - 1);
    return first > 0 ? first / R * R : 0;
  }

  // Query rows at or past this bound cannot see keys [k0, k0 + R): the
  // last row that sees key k0 + R - 1 is k0 + R - 2 + window (the dK/dV
  // kernel's q-loop end, _bwd_dkv_impl's hi_w).
  template <int R = BK>
  __device__ __forceinline__ int q_hi(int k0, int S) const {
    if (!WINDOW || window <= 0) return S;
    const long long hi = (long long)k0 + R - 1 + window;
    return hi < S ? (int)hi : S;
  }
};

// Score of query row ``qrow`` and key ``key`` (both absolute) after the
// bias and the mask: the score plus slope * key, or kNeg where the key is
// past S, the query row is past S, (causal) the key is after the query, or
// (window) the key is window or more rows before the query.
//
// ALiBi offsets reach slope * S (~1.4e3 at S=2048), where one fp32 ulp is
// 1.2e-4: any difference in how the score is rounded would come back
// magnified in P.  So the ALiBi kernels take the score as the plain
// version computes it -- the product, then times the scale, then plus
// slope * key rounded on its own (no fused multiply-add) -- and agree with
// it to the bit there.
template <bool SLOPE, bool WINDOW>
__device__ __forceinline__ float masked(float s, int qrow, int key, int S,
                                        int causal,
                                        const Bias<SLOPE, WINDOW>& bias) {
  if (SLOPE) s = __fadd_rn(s, __fmul_rn(bias.slope, (float)key));
  bool ok = qrow < S && key < S && (!causal || key <= qrow);
  if (WINDOW) ok = ok && (bias.window <= 0 || qrow - key < bias.window);
  return ok ? s : kNeg;
}

// Block geometry shared by the three kernels: blockIdx.y = b * H + h.
struct Heads {
  long long q_base, q_stride;    // (b, 0, h, 0) of q/o/dO and its row step
  long long kv_base, kv_stride;  // (b, 0, h / group, 0) of k/v
  int bh, h;                     // b * H + h and the query head h
  __device__ __forceinline__ Heads(int S, int H, int Hkv, int D) {
    bh = blockIdx.y;
    h = bh % H;
    const int b = bh / H, hk = h / (H / Hkv);
    q_base = ((long long)b * S * H + h) * D;
    q_stride = (long long)H * D;
    kv_base = ((long long)b * S * Hkv + hk) * D;
    kv_stride = (long long)Hkv * D;
  }
};

// Runs ``launch(slope, window)`` with two std::bool_constant flags: the
// instantiation a host entry needs for its bias -- ALiBi when ``slopes`` is
// not null, a window when ``window`` > 0.
template <typename Launch>
inline int with_bias(const void* slopes, int window, Launch&& launch) {
  const bool s = slopes != nullptr, w = window > 0;
  if (s && w) return launch(std::true_type{}, std::true_type{});
  if (s) return launch(std::true_type{}, std::false_type{});
  if (w) return launch(std::false_type{}, std::true_type{});
  return launch(std::false_type{}, std::false_type{});
}

// Checks shared by the host entries; 0 when the launch may go ahead.
inline int check_shape(int B, int S, int H, int Hkv, int D) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (D != 64 && D != 80 && D != 96 && D != 128 && D != 256) ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Runs ``launch(d)`` with d a std::integral_constant of the head dim D
// (64, 80, 96, 128 or 256): the instantiation a host entry needs;
// check_shape has refused every other D.
template <typename Launch>
inline int with_head_dim(int D, Launch&& launch) {
  if (D == 64) return launch(std::integral_constant<int, 64>{});
  if (D == 80) return launch(std::integral_constant<int, 80>{});
  if (D == 96) return launch(std::integral_constant<int, 96>{});
  if (D == 256) return launch(std::integral_constant<int, 256>{});
  return launch(std::integral_constant<int, 128>{});
}

}  // namespace dsflash
