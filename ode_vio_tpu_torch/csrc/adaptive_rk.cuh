// The adaptive explicit-RK solve shared by the port's solver kernels
// (fused_ode_solve.cu, fused_cde_solve.cu): one thread block integrates one
// row. The semantics are those of the port's solver core
// (ops/solvers/odeint.py, the while-mode solve of the JAX package): an
// embedded RK pair (dopri5 in the flagship, FSAL), RMS error control,
// the integral step controller, the last step clamped onto t_end, a
// max_steps budget per interval, rejected steps counted only while the
// row is active.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxStages = 8;
constexpr int kThreads = 512;

enum Act { kTanh = 0, kRelu = 1, kLeakyRelu = 2, kSoftplus = 3 };

struct FieldParams {
  const float* w[kMaxLayers];  // layer l: (dims[l+1], dims[l]), row-major
  const float* b[kMaxLayers];  // layer l: (dims[l+1],)
  int dims[kMaxLayers + 1];
  int n_layers;
  int act;
  int vec4;  // every dims[l] % 4 == 0 and every w[l] 16-byte aligned
};

struct TableauParams {
  float a[kMaxStages][kMaxStages];  // strictly lower triangular
  float b_sol[kMaxStages];
  float b_err[kMaxStages];
  float c[kMaxStages];  // stage times as fractions of the step
  int stages;
  int fsal;
  float expo;  // -1 / order
};

struct ControlParams {
  float rtol, atol, safety, factor_min, factor_max;
  int max_steps;
};

// The controller's state, shared by the block; thread 0 writes it.
struct SolveShared {
  float red[32];
  float t, dt, dtc;
  int go, clamped, accept;
};

__device__ __forceinline__ float activation(float x, int act) {
  switch (act) {
    case kTanh: return tanhf(x);
    case kRelu: return fmaxf(x, 0.f);
    case kLeakyRelu: return x >= 0.f ? x : 0.01f * x;
    default:  // softplus as jax.nn.softplus: logaddexp(x, 0)
      return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
  }
}

// max/min that propagate a NaN in `a`, as torch.clamp and jnp.maximum do
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : fminf(a, b);
}

__host__ __device__ __forceinline__ int round_up32(int x) { return (x + 31) & ~31; }

// out[o] = act(W[o] . x + b[o]) for o < out_dim (tanh where `last`); x and
// out in shared memory; one warp per output.
__device__ void dense(const float* __restrict__ w, const float* __restrict__ b,
                      const float* x, float* out, int in_dim, int out_dim,
                      bool vec4, int act, bool last) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int o = warp; o < out_dim; o += n_warps) {
    const float* row = w + (size_t)o * in_dim;
    float s = 0.f;
    if (vec4) {
      const float4* w4 = reinterpret_cast<const float4*>(row);
      const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
      for (int i = lane; i < in_dim / 4; i += 32) {
        const float4 wv = __ldg(w4 + i);
        const float4 xv = x4[i];
        s += wv.x * xv.x + wv.y * xv.y + wv.z * xv.z + wv.w * xv.w;
      }
    } else {
      for (int i = lane; i < in_dim; i += 32) s += __ldg(row + i) * x[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      const float z = s + __ldg(b + o);
      out[o] = last ? tanhf(z) : activation(z, act);
    }
  }
  __syncthreads();
}

// Sum over the block; the result is valid in thread 0.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (warp == 0) {
    total = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, off);
  }
  return total;
}

// Integrates y (F values in shared memory) from t_start to t_end with the
// step proposal in sh.dt, which it updates. `field(t, y, k)` writes
// k = f(t, y) into shared memory and ends with __syncthreads(). ks holds
// the stage vectors (S rows of round_up32(F)), f the FSAL cache. Stage i
// is evaluated at t + c_i * dt, one product and one sum, each rounded as
// the plain version rounds them (no FMA): where a clamped stage lands on
// a control-path knot, that decides which segment it reads. Adds the
// accepted and rejected steps to *acc and *rej, and 1 to *inc if the row
// ran out of budget, in thread 0.
template <class Field>
__device__ __forceinline__ void adaptive_solve(Field& field, const TableauParams& tp,
                                               const ControlParams& cp, float t_start,
                                               float t_end,
                                               int F, float* y, float* y1, float* ytmp,
                                               float* f, float* ks, SolveShared& sh,
                                               int* acc, int* rej, int* inc) {
  const int tid = threadIdx.x;
  const int S = tp.stages;
  const int Fp = round_up32(F);
  const int fsal = tp.fsal;
  auto K = [=](int i) -> float* { return (i == 0 && fsal) ? f : ks + i * Fp; };

  if (tid == 0) sh.t = t_start;
  __syncthreads();
  // the FSAL cache f(t_start, y); an empty interval takes no step and needs none
  if (fsal && t_end - t_start > 0.f) field(t_start, y, f);

  int accepted = 0, rejected = 0;  // meaningful in thread 0
  for (int step = 0;; ++step) {
    if (tid == 0) {
      const float remaining = fmaxf(t_end - sh.t, 0.f);
      sh.go = (t_end - sh.t) > 0.f && step < cp.max_steps;
      sh.clamped = sh.dt >= remaining;
      sh.dtc = sh.clamped ? remaining : sh.dt;
    }
    __syncthreads();
    if (!sh.go) break;
    const float dtc = sh.dtc;
    const float t = sh.t;

    if (!fsal) field(t, y, K(0));
    for (int i = 1; i < S; ++i) {
      for (int e = tid; e < F; e += blockDim.x) {
        float incr = 0.f;
        bool any = false;
        for (int j = 0; j < i; ++j) {
          const float c = tp.a[i][j];
          if (c == 0.f) continue;
          incr = any ? incr + c * K(j)[e] : c * K(j)[e];
          any = true;
        }
        ytmp[e] = any ? y[e] + dtc * incr : y[e];
      }
      __syncthreads();
      field(__fadd_rn(t, __fmul_rn(tp.c[i], dtc)), ytmp, K(i));
    }

    float part = 0.f;
    for (int e = tid; e < F; e += blockDim.x) {
      float sol = 0.f, err = 0.f;
      bool any_sol = false, any_err = false;
      for (int j = 0; j < S; ++j) {
        const float k = K(j)[e];
        const float cs = tp.b_sol[j], ce = tp.b_err[j];
        if (cs != 0.f) { sol = any_sol ? sol + cs * k : cs * k; any_sol = true; }
        if (ce != 0.f) { err = any_err ? err + ce * k : ce * k; any_err = true; }
      }
      const float ynew = y[e] + dtc * sol;
      const float scale = cp.atol + cp.rtol * fmaxf(fabsf(y[e]), fabsf(ynew));
      const float r = (dtc * err) / scale;
      part += r * r;
      y1[e] = ynew;
    }
    const float total = block_sum(part, sh.red);
    if (tid == 0) {
      const float ratio = sqrtf(total / (float)F);
      const bool accept = ratio <= 1.f;
      const float safe = nan_max(ratio, 1e-10f);
      const float factor = nan_min(
          nan_max(cp.safety * powf(safe, tp.expo), cp.factor_min), cp.factor_max);
      sh.dt = nan_max(dtc * factor, FLT_MIN);
      sh.t = accept ? (sh.clamped ? t_end : t + dtc) : t;
      sh.accept = accept;
      accepted += accept;
      rejected += !accept;
    }
    __syncthreads();
    if (sh.accept) {
      for (int e = tid; e < F; e += blockDim.x) {
        y[e] = y1[e];
        if (fsal) f[e] = K(S - 1)[e];
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    *acc += accepted;
    *rej += rejected;
    *inc += (t_end - sh.t) > 0.f;
  }
  __syncthreads();
}

// Host side: the field's layers and the tableau from the wrapper's arrays.
// Returns the widest hidden layer, or 0 if the layers are not accepted.
inline int fill_field(FieldParams& fp, const void* const* weights,
                      const void* const* biases, const int* dims, int n_layers,
                      int act) {
  if (n_layers < 1 || n_layers > kMaxLayers) return 0;
  int hidden_max = 1;
  int vec4 = 1;
  for (int l = 0; l < n_layers; ++l) {
    fp.w[l] = static_cast<const float*>(weights[l]);
    fp.b[l] = static_cast<const float*>(biases[l]);
    if (dims[l] % 4 != 0 || reinterpret_cast<uintptr_t>(weights[l]) % 16 != 0) vec4 = 0;
    if (l > 0 && dims[l] > hidden_max) hidden_max = dims[l];
  }
  for (int l = 0; l <= n_layers; ++l) fp.dims[l] = dims[l];
  fp.n_layers = n_layers;
  fp.act = act;
  fp.vec4 = vec4;
  return hidden_max;
}

inline bool fill_tableau(TableauParams& tp, const float* a, const float* b_sol,
                         const float* b_err, const float* c, int stages, int fsal,
                         float expo) {
  if (stages < 2 || stages > kMaxStages) return false;
  for (int i = 0; i < kMaxStages; ++i) {
    for (int j = 0; j < kMaxStages; ++j) tp.a[i][j] = a[i * kMaxStages + j];
    tp.b_sol[i] = b_sol[i];
    tp.b_err[i] = b_err[i];
    tp.c[i] = c[i];
  }
  tp.stages = stages;
  tp.fsal = fsal;
  tp.expo = expo;
  return true;
}

// Allows `smem` bytes of dynamic shared memory for `kernel` where more than
// the default 48 KB is needed.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace
