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
// What bounds it on the H100: it is one elementwise pass -- 28 bytes per
// parameter with an fp32 g (p, m, v read and written, g read), ~20 flops
// per parameter -- so HBM bandwidth (3.35 TB/s) is the bound: 8.4 ms for
// gpt_1b's 1.01 B parameters.  Each thread handles four elements a block
// width apart (coalesced, four independent loads in flight); a single
// launch replaces the ~10 elementwise kernels per parameter tensor that
// eager PyTorch would issue.  CUDA rather than Triton: the build and
// binding route of the other kernels is already in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIlp = 4;

// the per-step scalars' order in the device buffer
enum Hyper { kLr, kB1, kOmb1, kC1, kC2, kHyper };

struct AdamArgs {
  const float* hyper;  // device [kHyper]
  const int* skip;     // device; != 0: write nothing
  float b2, omb2, eps, wd;
  int adamw;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(float* __restrict__ p, const G* __restrict__ g,
                  float* __restrict__ m, float* __restrict__ v, long long n,
                  AdamArgs a) {
  if (__ldg(a.skip)) return;
  const float lr = __ldg(a.hyper + kLr), b1 = __ldg(a.hyper + kB1);
  const float omb1 = __ldg(a.hyper + kOmb1), c1 = __ldg(a.hyper + kC1);
  const float c2 = __ldg(a.hyper + kC2);
  const long long base =
      (long long)blockIdx.x * kThreads * kIlp + threadIdx.x;
  float pr[kIlp], gr[kIlp], mr[kIlp], vr[kIlp];
#pragma unroll
  for (int u = 0; u < kIlp; ++u) {
    const long long i = base + (long long)u * kThreads;
    if (i < n) {
      pr[u] = p[i];
      gr[u] = to_f(g[i]);
      mr[u] = m[i];
      vr[u] = v[i];
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
    m[i] = mi;
    v[i] = vi;
  }
}

template <typename G>
int launch(void* p, const void* g, void* m, void* v, long long n,
           const AdamArgs& a, cudaStream_t stream) {
  const long long per_block = (long long)kThreads * kIlp;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_adam_kernel<G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<float*>(p), static_cast<const G*>(g),
      static_cast<float*>(m), static_cast<float*>(v), n, a);
  return (int)cudaGetLastError();
}

}  // namespace

// p, m, v: fp32 [n], updated in place; g: [n], g_dtype 0 = float32,
// 1 = bfloat16.  adamw: 1 = mode 0 (decoupled decay), 0 = mode 1 (L2).
// hyper: device fp32 [5] = (lr, beta1, 1 - beta1, c1, c2); skip: device
// int32, nonzero to leave everything as it is.  omb2 is 1 - beta2, rounded
// once on the host.  Returns cudaGetLastError().
extern "C" int ds_fused_adam(void* p, const void* g, void* m, void* v,
                             long long n, int g_dtype, int adamw,
                             const void* hyper, const void* skip, float b2,
                             float omb2, float eps, float wd, void* stream) {
  if (n <= 0 || hyper == nullptr || skip == nullptr)
    return (int)cudaErrorInvalidValue;
  const AdamArgs a{static_cast<const float*>(hyper),
                   static_cast<const int*>(skip), b2, omb2, eps, wd, adamw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == 0) return launch<float>(p, g, m, v, n, a, s);
  if (g_dtype == 1) return launch<__nv_bfloat16>(p, g, m, v, n, a, s);
  return (int)cudaErrorInvalidValue;
}
