// Fused adaptive ODE solve: one frame interval of the ODE-RNN pose core.
//
// Replaces the TPU kernel `fused_ode_solve` in
// ode_vio_tpu/ops/pallas_kernels.py (its pallas_call body, the row-masked
// while loop). For every row it integrates dy/dt = MLP(y) (activation on
// the hidden layers, tanh on the last) from t0 to t1 with an embedded
// explicit RK pair (dopri5 in the flagship, FSAL), RMS error control, the
// integral step controller, the landing clamped on t1, a max_steps budget
// and a per-row dt0 warm start. Outputs y1, dt_final, accepted, rejected,
// incomplete, exactly as the TPU kernel does.
//
// What bounds it on an H100: the MLP weights (768->1024->1024->768 f32,
// about 10.5 MB) are read once per field evaluation, i.e. six times per
// dopri5 step, by every row. They do not fit in one SM's 227 KB of shared
// memory, so the TPU design (weights resident in VMEM) does not carry
// over. The floor for the work itself is the f32 FMA rate (2 flops per
// weight per row per evaluation); the weights' single pass through HBM is
// microseconds.
//
// Design: the rows' solves are independent (the TPU kernel's global step
// counter with per-row masking equals a per-row step budget, because a row
// that is still active has taken exactly `step` steps). So one thread
// block runs the whole adaptive loop for one row. y, the FSAL cache, the
// stage vectors and the hidden activations sit in shared memory; each
// dense layer is a loop of f32 dot products, one warp per output neuron,
// reading its weight row from global memory, where the 10.5 MB stay
// resident in the 50 MB L2 across evaluations and blocks. The RMS norm is
// a block reduction and thread 0 runs the per-row controller. f32
// throughout, no tensor cores. At the flagship's 12 rows only 12 of 132
// SMs work, and each reads the weights from L2 for itself: splitting a
// row's layers across blocks (clusters and distributed shared memory) and
// wgmma for the products are the next steps.

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
  int stages;
  int fsal;
  float expo;  // -1 / order
};

struct ControlParams {
  float rtol, atol, safety, factor_min, factor_max;
  int max_steps;
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

// max/min that propagate a NaN in `a`, as jnp.maximum/minimum do
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : fminf(a, b);
}

__device__ __forceinline__ int round_up32(int x) { return (x + 31) & ~31; }

// out[o] = act(W[o] . x + b[o]) for o < out_dim; x and out in shared memory.
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

// k = MLP(y): hidden layers ping-pong between ha and hb.
__device__ __forceinline__ void field(const FieldParams& fp, const float* y, float* k,
                      float* ha, float* hb) {
  const float* in = y;
  for (int l = 0; l < fp.n_layers; ++l) {
    const bool last = l == fp.n_layers - 1;
    float* out = last ? k : (l % 2 == 0 ? ha : hb);
    dense(fp.w[l], fp.b[l], in, out, fp.dims[l], fp.dims[l + 1], fp.vec4,
          fp.act, last);
    in = out;
  }
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

__global__ void __launch_bounds__(kThreads)
fused_ode_solve_kernel(const float* __restrict__ y0, const float* __restrict__ t0,
                       const float* __restrict__ t1, const float* __restrict__ dt0,
                       FieldParams fp, TableauParams tp, ControlParams cp,
                       float* __restrict__ y_out, float* __restrict__ dt_out,
                       int* __restrict__ acc_out, int* __restrict__ rej_out,
                       int* __restrict__ inc_out, int F, int hidden_max) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[32];
  __shared__ float s_t, s_dt, s_dtc;
  __shared__ int s_go, s_clamped, s_accept;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int S = tp.stages;
  const int Fp = round_up32(F);
  const int Hp = round_up32(hidden_max);
  float* y = smem;
  float* y1 = y + Fp;
  float* ytmp = y1 + Fp;
  float* f = ytmp + Fp;       // FSAL cache: f(t, y)
  float* ks = f + Fp;         // stages 1..S-1 (stage 0 too without FSAL)
  float* ha = ks + S * Fp;
  float* hb = ha + Hp;
  // stage i's vector; with FSAL stage 0 is the cache f
  const int fsal = tp.fsal;
  auto K = [=](int i) -> float* { return (i == 0 && fsal) ? f : ks + i * Fp; };

  for (int e = tid; e < F; e += blockDim.x) y[e] = y0[(size_t)row * F + e];
  const float t_end = t1[row];
  if (tid == 0) {
    s_t = t0[row];
    s_dt = dt0[row];
  }
  __syncthreads();
  if (fsal) field(fp, y, f, ha, hb);

  int accepted = 0, rejected = 0;  // meaningful in thread 0
  for (int step = 0;; ++step) {
    if (tid == 0) {
      const float remaining = fmaxf(t_end - s_t, 0.f);
      s_go = (t_end - s_t) > 0.f && step < cp.max_steps;
      s_clamped = s_dt >= remaining;
      s_dtc = s_clamped ? remaining : s_dt;
    }
    __syncthreads();
    if (!s_go) break;
    const float dtc = s_dtc;

    if (!fsal) field(fp, y, K(0), ha, hb);
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
      field(fp, ytmp, K(i), ha, hb);
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
    const float total = block_sum(part, red);
    if (tid == 0) {
      const float ratio = sqrtf(total / (float)F);
      const bool accept = ratio <= 1.f;
      const float safe = nan_max(ratio, 1e-10f);
      const float factor = nan_min(
          nan_max(cp.safety * powf(safe, tp.expo), cp.factor_min), cp.factor_max);
      const float t = s_t;
      s_dt = nan_max(dtc * factor, FLT_MIN);
      s_t = accept ? (s_clamped ? t_end : t + dtc) : t;
      s_accept = accept;
      accepted += accept;
      rejected += !accept;
    }
    __syncthreads();
    if (s_accept) {
      for (int e = tid; e < F; e += blockDim.x) {
        y[e] = y1[e];
        if (fsal) f[e] = K(S - 1)[e];
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < F; e += blockDim.x) y_out[(size_t)row * F + e] = y[e];
  if (tid == 0) {
    dt_out[row] = s_dt;
    acc_out[row] = accepted;
    rej_out[row] = rejected;
    inc_out[row] = (t_end - s_t) > 0.f;
  }
}

}  // namespace

// Launches one block per row on `stream`. Host arrays: weights/biases hold
// n_layers device pointers, dims n_layers+1 widths, tab_a kMaxStages^2
// row-major stage coefficients, tab_b_sol/tab_b_err kMaxStages weights.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fused_ode_solve_launch(
    const float* y0, const float* t0, const float* t1, const float* dt0,
    const void* const* weights, const void* const* biases, const int* dims,
    int n_layers, int act, const float* tab_a, const float* tab_b_sol,
    const float* tab_b_err, int stages, int fsal, float expo, float rtol,
    float atol, float safety, float factor_min, float factor_max,
    int max_steps, float* y1, float* dt_out, int* acc, int* rej, int* inc,
    int n_rows, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || stages < 2 ||
      stages > kMaxStages || n_rows < 1 || dims[0] != dims[n_layers])
    return (int)cudaErrorInvalidValue;

  FieldParams fp;
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

  TableauParams tp;
  for (int i = 0; i < kMaxStages; ++i) {
    for (int j = 0; j < kMaxStages; ++j) tp.a[i][j] = tab_a[i * kMaxStages + j];
    tp.b_sol[i] = tab_b_sol[i];
    tp.b_err[i] = tab_b_err[i];
  }
  tp.stages = stages;
  tp.fsal = fsal;
  tp.expo = expo;

  ControlParams cp{rtol, atol, safety, factor_min, factor_max, max_steps};

  const int F = dims[0];
  const int Fp = (F + 31) & ~31;
  const int Hp = (hidden_max + 31) & ~31;
  const size_t smem = sizeof(float) * ((size_t)(4 + stages) * Fp + 2 * (size_t)Hp);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_ode_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_ode_solve_kernel<<<n_rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      y0, t0, t1, dt0, fp, tp, cp, y1, dt_out, acc, rej, inc, F, hidden_max);
  return (int)cudaGetLastError();
}
