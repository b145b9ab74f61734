// Host-side fused AdamW for offloaded optimizer state.
//
// Role parity: reference csrc/adam/cpu_adam.cpp (Adam_Optimizer::Step_* with
// AVX intrinsics + OpenMP).  This implementation relies on -O3 -march=native
// auto-vectorisation instead of hand-written intrinsics: the loop is a single
// fused pass (the win over numpy is avoiding five buffer sweeps), and GCC
// vectorises it to the same AVX code the reference writes by hand.
//
// Exported C ABI (ctypes-loaded from ops/cpu_adam.py):
//   adam_update(params, grads, m, v, n, lr, beta1, beta2, eps, wd,
//               bias_corr1, bias_corr2, adamw_mode)

#include <cmath>
#include <cstddef>

extern "C" {

void adam_update(float* __restrict__ params, float* __restrict__ grads,
                 float* __restrict__ exp_avg, float* __restrict__ exp_avg_sq,
                 long n, float lr, float beta1, float beta2, float eps,
                 float weight_decay, float bias_corr1, float bias_corr2,
                 int adamw_mode) {
    const float om_beta1 = 1.0f - beta1;
    const float om_beta2 = 1.0f - beta2;
    const float inv_bc1 = 1.0f / bias_corr1;
    const float inv_bc2_sqrt = 1.0f / std::sqrt(bias_corr2);
    // step_size folding: update = m_hat / (sqrt(v_hat) + eps)
    //   m_hat = m * inv_bc1 ; sqrt(v_hat) = sqrt(v) * inv_bc2_sqrt
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; ++i) {
        float g = grads[i];
        float p = params[i];
        if (!adamw_mode && weight_decay != 0.0f) g += weight_decay * p;
        float m = beta1 * exp_avg[i] + om_beta1 * g;
        float v = beta2 * exp_avg_sq[i] + om_beta2 * g * g;
        exp_avg[i] = m;
        exp_avg_sq[i] = v;
        float update = (m * inv_bc1) / (std::sqrt(v) * inv_bc2_sqrt + eps);
        if (adamw_mode && weight_decay != 0.0f) update += weight_decay * p;
        params[i] = p - lr * update;
    }
}

void adagrad_update(float* __restrict__ params, float* __restrict__ grads,
                    float* __restrict__ sq_accum, long n, float lr, float eps,
                    float weight_decay) {
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; ++i) {
        float g = grads[i];
        if (weight_decay != 0.0f) g += weight_decay * params[i];
        float s = sq_accum[i] + g * g;
        sq_accum[i] = s;
        params[i] -= lr * g / (std::sqrt(s) + eps);
    }
}

}  // extern "C"
