// Fused Adam / AdamW step over one flat fp32 buffer, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/fused_adam.py:
// _adam_kernel (host side fused_adam_pallas): one launch updates the
// master parameters p and the moments m, v IN PLACE from the gradient g
// (fp32 or bf16), modes 0 (AdamW, decoupled decay) and 1 (L2 decay added
// to g), with the bias corrections c1 = 1 - beta1^count and
// c2 = 1 - beta2^count (1 when off):
//   m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
//   p = p - lr * ((m / c1) / (sqrt(v / c2) + eps) [+ wd p])
// The per-step scalars lr, b1, 1 - b1, c1 and c2 are read from a device
// buffer, as the TPU kernel reads c1, c2 and lr through scalar prefetch:
// the engine computes them on the card from the count of applied steps
// and the LR / momentum schedules, so no step waits for the host.  A
// device int flag (fp16's overflow) makes every thread return before it
// reads or writes anything: a skipped step leaves p, m and v bit for bit,
// as the JAX engine's where(overflow, old, new) does.  The kernel makes no
// host call and allocates nothing, so a CUDA graph can capture it.
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, IEEE
// division and sqrt; built without --use_fast_math), in the order the
// plain PyTorch version (ops/adam.py) issues its elementwise ops, so the
// two agree to the last bit.  Unlike the TPU entry the buffer is not
// padded to 512 x 128: the tail of the last block is masked.
//
// The moments are fp32 or bf16 (M).  bf16 moments are the update that
// XLA fuses from the JAX package's _scale_by_adam_dtyped
// (deepspeed_tpu/runtime/optimizers.py): m and v are widened to fp32, the
// fp32 m32 and v32 give the update, and each is stored back by stochastic
// rounding -- 16 random bits added to its fp32 bit pattern, the low half
// then cut off (_sr_cast).  The bits are a counter hash of (step, moment,
// element index) from a fixed base seed (sr_bits below; the plain version
// computes the same hash in int64 torch ops), not JAX's threefry bits:
// a run is reproducible, and unbiased, but draws other bits than JAX.
//
// What bounds it on the H100: it is one elementwise pass -- 28 bytes per
// parameter with fp32 g and moments (p, m, v read and written, g read),
// 18 with bf16 g and moments -- and ~20 flops per parameter (~40 with
// the hash), so HBM bandwidth (3.35 TB/s) is the bound: 8.4 ms for
// gpt_1b's 1.01 B parameters, 5.4 ms with bf16 g and moments.  Each
// thread handles four elements a block width apart (coalesced, four
// independent loads in flight); a single launch replaces the ~10
// elementwise kernels per parameter tensor that eager PyTorch would
// issue.  CUDA rather than Triton: the build and binding route of the
// other kernels is already in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIlp = 4;
// the stochastic rounding's base seed: fixed, as the JAX step folds its
// count into the fixed key(0)
constexpr uint32_t kSrSeed = 0x5EEDu;

// the per-step scalars' order in the device buffer
enum Hyper { kLr, kB1, kOmb1, kC1, kC2, kHyper };

struct AdamArgs {
  const float* hyper;  // device [kHyper]
  const int* skip;     // device; != 0: write nothing
  const int* count;    // device: applied steps before this one
  float b2, omb2, eps, wd;
  int adamw;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// a 32-bit integer hash: two multiply-xorshift rounds (the plain version's
// mix32 in utils/hashing.py, whose int64 products stay below 2**63)
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x45D9F3Bu;
  x ^= x >> 16;
  x *= 0x45D9F3Bu;
  return x ^ (x >> 16);
}

// the stream key of (step, moment): moment 0 is m, 1 is v
__device__ __forceinline__ uint32_t sr_key(uint32_t step, uint32_t moment) {
  return mix32(mix32(kSrSeed ^ step) ^ moment);
}

// 16 random bits for element i of the stream ``key``
__device__ __forceinline__ uint32_t sr_bits(uint32_t key, long long i) {
  const uint32_t lo = (uint32_t)((unsigned long long)i & 0xFFFFFFFFull);
  const uint32_t hi = (uint32_t)((unsigned long long)i >> 32);
  return mix32(lo ^ mix32(hi ^ key)) >> 16;
}

__device__ __forceinline__ void store(float* dst, float x, uint32_t) {
  *dst = x;
}
// stochastic rounding to bf16: the low 16 bits of (bits + r) cut off
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x,
                                      uint32_t r) {
  const uint32_t b = (__float_as_uint(x) + r) & 0xFFFF0000u;
  *dst = __ushort_as_bfloat16((unsigned short)(b >> 16));
}

template <typename G, typename M>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(float* __restrict__ p, const G* __restrict__ g,
                  M* __restrict__ m, M* __restrict__ v, long long n,
                  AdamArgs a) {
  if (__ldg(a.skip)) return;
  constexpr bool kSr = sizeof(M) == 2;
  const float lr = __ldg(a.hyper + kLr), b1 = __ldg(a.hyper + kB1);
  const float omb1 = __ldg(a.hyper + kOmb1), c1 = __ldg(a.hyper + kC1);
  const float c2 = __ldg(a.hyper + kC2);
  uint32_t key_m = 0, key_v = 0;
  if (kSr) {
    const uint32_t step = (uint32_t)__ldg(a.count) + 1u;
    key_m = sr_key(step, 0u);
    key_v = sr_key(step, 1u);
  }
  const long long base =
      (long long)blockIdx.x * kThreads * kIlp + threadIdx.x;
  float pr[kIlp], gr[kIlp], mr[kIlp], vr[kIlp];
#pragma unroll
  for (int u = 0; u < kIlp; ++u) {
    const long long i = base + (long long)u * kThreads;
    if (i < n) {
      pr[u] = p[i];
      gr[u] = to_f(g[i]);
      mr[u] = to_f(m[i]);
      vr[u] = to_f(v[i]);
    }
  }
#pragma unroll
  for (int u = 0; u < kIlp; ++u) {
    const long long i = base + (long long)u * kThreads;
    if (i >= n) continue;
    float gi = gr[u];
    const float pi = pr[u];
    if (!a.adamw && a.wd != 0.f) gi = __fadd_rn(gi, __fmul_rn(a.wd, pi));
    const float mi = __fadd_rn(__fmul_rn(mr[u], b1), __fmul_rn(gi, omb1));
    const float vi = __fadd_rn(__fmul_rn(vr[u], a.b2),
                               __fmul_rn(__fmul_rn(gi, gi), a.omb2));
    float upd = __fdiv_rn(__fdiv_rn(mi, c1),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, c2)), a.eps));
    if (a.adamw && a.wd != 0.f) upd = __fadd_rn(upd, __fmul_rn(a.wd, pi));
    p[i] = __fsub_rn(pi, __fmul_rn(lr, upd));
    store(m + i, mi, kSr ? sr_bits(key_m, i) : 0u);
    store(v + i, vi, kSr ? sr_bits(key_v, i) : 0u);
  }
}

template <typename G, typename M>
int launch(void* p, const void* g, void* m, void* v, long long n,
           const AdamArgs& a, cudaStream_t stream) {
  const long long per_block = (long long)kThreads * kIlp;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_adam_kernel<G, M><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<float*>(p), static_cast<const G*>(g), static_cast<M*>(m),
      static_cast<M*>(v), n, a);
  return (int)cudaGetLastError();
}

template <typename G>
int launch_g(int m_dtype, void* p, const void* g, void* m, void* v,
             long long n, const AdamArgs& a, cudaStream_t s) {
  if (m_dtype == 0) return launch<G, float>(p, g, m, v, n, a, s);
  if (m_dtype == 1) return launch<G, __nv_bfloat16>(p, g, m, v, n, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// p: fp32 [n], updated in place; g: [n], g_dtype 0 = float32,
// 1 = bfloat16; m, v: [n], updated in place, m_dtype 0 = float32,
// 1 = bfloat16 (stored by stochastic rounding).  adamw: 1 = mode 0
// (decoupled decay), 0 = mode 1 (L2).  hyper: device fp32 [5] = (lr,
// beta1, 1 - beta1, c1, c2); skip: device int32, nonzero to leave
// everything as it is; count: device int32, the applied steps before this
// one (it seeds the bf16 moments' rounding bits).  omb2 is 1 - beta2,
// rounded once on the host.  Returns cudaGetLastError().
extern "C" int ds_fused_adam(void* p, const void* g, void* m, void* v,
                             long long n, int g_dtype, int m_dtype,
                             int adamw, const void* hyper, const void* skip,
                             const void* count, float b2, float omb2,
                             float eps, float wd, void* stream) {
  if (n <= 0 || hyper == nullptr || skip == nullptr || count == nullptr)
    return (int)cudaErrorInvalidValue;
  const AdamArgs a{static_cast<const float*>(hyper),
                   static_cast<const int*>(skip),
                   static_cast<const int*>(count), b2, omb2, eps, wd, adamw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == 0) return launch_g<float>(m_dtype, p, g, m, v, n, a, s);
  if (g_dtype == 1)
    return launch_g<__nv_bfloat16>(m_dtype, p, g, m, v, n, a, s);
  return (int)cudaErrorInvalidValue;
}
