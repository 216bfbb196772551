// Fused neural-CDE solve: the whole multi-segment inference solve of the
// CDE and RDE pose cores.
//
// Replaces the TPU kernel `fused_cde_solve` in
// ode_vio_tpu/ops/pallas_kernels.py (its pallas_call body). For every row
// it solves dz/dt = tanh(MLP(z)).reshape(H, C) . dX/dt(t) through
// [path_ts[0]] + eval_ts, segment by segment: each segment a fresh
// adaptive solve (adaptive_rk.cuh) with its own max_steps budget and FSAL
// re-init, the step size carried across segments from dt0 at the start,
// z written out at each segment's end, the step counts summed over the
// segments. The control path is piecewise linear (dX = b[k]) or cubic
// (dX = (3 d[k] s + 2 c[k]) s + b[k], s = t - ts[k]) on the segment
// k = clip(#{i : ts[i] <= t} - 1, 0, T-2), as the plain version's
// InterpolatedPath picks it (ops/interpolation.py). A zero-length segment
// (a repeated knot, or the carry mode's first segment) takes no step and
// leaves z and dt as they are.
//
// What bounds it on an H100: the field's last layer is (H*C, hidden), at
// the flagship cde field (H 128, C 129) 2.1 M weights, 8.5 MB f32, read
// once per evaluation (six per dopri5 step) by every row. The work is
// 2 flops per weight per evaluation at the f32 FMA rate; the weights fit
// in the 50 MB L2 but not in an SM's 227 KB of shared memory.
//
// Design: one thread block per row runs that row's whole solve, z, the
// stage vectors and the hidden activations in shared memory, the
// controller in thread 0, as in fused_ode_solve.cu. The hidden layers
// are one warp per output neuron. The last layer is fused with the
// contraction over C: each warp takes one h at a time and runs over its C
// outputs 32 at a time, every lane reading one float4 of each of the 32
// weight rows (32 rows of 512 bytes, adjacent in memory: coalesced, many
// loads in flight), the 32 partial dot products per lane reduced across
// the warp by a butterfly that leaves output c0+lane in lane `lane` (31
// shuffles for 32 outputs), and each lane then adds
// tanh(o + b) * dX[c] into its running sum for dz[h]. The (H*C)
// activation is never stored. The weights are read from global memory,
// where they stay in L2 across evaluations and blocks. Only B rows work
// (4 of 132 SMs at 4 lanes), each reading the weights from L2 for itself:
// splitting a row over a thread-block cluster and wgmma for the products
// are the next steps.

#include "adaptive_rk.cuh"

namespace {

// One stage of the butterfly: lanes with bit OFF set keep the upper half
// of their 2*OFF partial sums and trade the lower half with their partner.
template <int OFF>
__device__ __forceinline__ void reduce_scatter_stage(float (&p)[32], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int j = 0; j < OFF; ++j) {
    const float send = upper ? p[j] : p[j + OFF];
    const float keep = upper ? p[j + OFF] : p[j];
    p[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// dz[h] = sum_c tanh(W[h*C + c] . x + b[h*C + c]) * dX[c] for h < H; x (in_dim),
// dX (C) and dz (H) in shared memory.
__device__ void cde_last_layer(const float* __restrict__ w, const float* __restrict__ b,
                               const float* x, const float* dX, float* dz,
                               int in_dim, int H, int C, bool vec4) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int h = warp; h < H; h += n_warps) {
    float acc = 0.f;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int nc = min(32, C - c0);
      const float* rows = w + ((size_t)h * C + c0) * in_dim;
      float p[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) p[j] = 0.f;
      if (vec4) {
        const float4* x4 = reinterpret_cast<const float4*>(x);
        for (int i = lane; i < in_dim / 4; i += 32) {
          const float4 xv = x4[i];
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            if (j < nc) {
              const float4 wv =
                  __ldg(reinterpret_cast<const float4*>(rows + (size_t)j * in_dim) + i);
              p[j] += wv.x * xv.x + wv.y * xv.y + wv.z * xv.z + wv.w * xv.w;
            }
          }
        }
      } else {
        for (int i = lane; i < in_dim; i += 32) {
          const float xv = x[i];
#pragma unroll
          for (int j = 0; j < 32; ++j)
            if (j < nc) p[j] += __ldg(rows + (size_t)j * in_dim + i) * xv;
        }
      }
      reduce_scatter_stage<16>(p, lane);
      reduce_scatter_stage<8>(p, lane);
      reduce_scatter_stage<4>(p, lane);
      reduce_scatter_stage<2>(p, lane);
      reduce_scatter_stage<1>(p, lane);
      if (lane < nc) {
        const int c = c0 + lane;
        acc += tanhf(p[0] + __ldg(b + (size_t)h * C + c)) * dX[c];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) dz[h] = acc;
  }
  __syncthreads();
}

// dz = g(z) . dX/dt(t) for this block's row.
struct CdeField {
  const FieldParams& fp;
  const float* ts;                // (T) knot times, shared memory
  const float* cb;  // (T-1, C) the row's coefficients, global memory
  const float* cc;  // null for a linear path
  const float* cd;
  int T, C;
  float* ha;
  float* hb;
  float* dX;  // (C) shared memory

  __device__ void operator()(float t, const float* z, float* dz) {
    int n_le = 0;  // #{i : ts[i] <= t}, searchsorted(ts, t, 'right')
    for (int i = 0; i < T; ++i) n_le += ts[i] <= t;
    const int k = min(max(n_le - 1, 0), T - 2);
    const float s = t - ts[k];
    const size_t base = (size_t)k * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const float slope = __ldg(cb + base + c);
      if (cc == nullptr) {
        dX[c] = slope;
      } else {  // (3 d s + 2 c) s + b, each product and sum rounded
        float v = __fmul_rn(__fmul_rn(3.f, __ldg(cd + base + c)), s);
        v = __fadd_rn(v, __fmul_rn(2.f, __ldg(cc + base + c)));
        dX[c] = __fadd_rn(__fmul_rn(v, s), slope);
      }
    }
    __syncthreads();
    const int L = fp.n_layers;
    const float* in = z;
    for (int l = 0; l < L - 1; ++l) {
      float* out = l % 2 == 0 ? ha : hb;
      dense(fp.w[l], fp.b[l], in, out, fp.dims[l], fp.dims[l + 1], fp.vec4, fp.act, false);
      in = out;
    }
    cde_last_layer(fp.w[L - 1], fp.b[L - 1], in, dX, dz, fp.dims[L - 1],
                   fp.dims[0], C, fp.vec4);
  }
};

__global__ void __launch_bounds__(kThreads)
fused_cde_solve_kernel(const float* __restrict__ z0, const float* __restrict__ path_ts,
                       const float* __restrict__ path_b, const float* __restrict__ path_c,
                       const float* __restrict__ path_d, const float* __restrict__ eval_ts,
                       float dt0, FieldParams fp, TableauParams tp, ControlParams cp,
                       float* __restrict__ zs_out, float* __restrict__ dt_out,
                       int* __restrict__ acc_out, int* __restrict__ rej_out,
                       int* __restrict__ inc_out, int H, int C, int T, int E,
                       int hidden_max) {
  extern __shared__ __align__(16) float smem[];
  __shared__ SolveShared sh;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int Hp = round_up32(H);
  float* z = smem;
  float* z1 = z + Hp;
  float* ztmp = z1 + Hp;
  float* f = ztmp + Hp;       // FSAL cache
  float* ks = f + Hp;         // stages 1..S-1 (stage 0 too without FSAL)
  float* ha = ks + tp.stages * Hp;
  float* hb = ha + round_up32(hidden_max);
  float* dX = hb + round_up32(hidden_max);
  float* ts = dX + round_up32(C);
  float* ev = ts + round_up32(T);

  for (int e = tid; e < H; e += blockDim.x) z[e] = z0[(size_t)row * H + e];
  for (int i = tid; i < T; i += blockDim.x) ts[i] = path_ts[(size_t)row * T + i];
  for (int i = tid; i < E; i += blockDim.x) ev[i] = eval_ts[(size_t)row * E + i];
  if (tid == 0) sh.dt = dt0;
  __syncthreads();

  const size_t coef = (size_t)row * (T - 1) * C;
  CdeField field{fp, ts, path_b + coef,
                 path_c ? path_c + coef : nullptr, path_d ? path_d + coef : nullptr,
                 T, C, ha, hb, dX};
  int acc = 0, rej = 0, inc = 0;  // meaningful in thread 0
  for (int j = 0; j < E; ++j) {
    // segment 0 runs from the path's first knot, segment j from eval_ts[j-1]
    const float t_start = j == 0 ? ts[0] : ev[j - 1];
    adaptive_solve(field, tp, cp, t_start, ev[j], H, z, z1, ztmp, f, ks, sh,
                   &acc, &rej, &inc);
    for (int e = tid; e < H; e += blockDim.x)
      zs_out[((size_t)row * E + j) * H + e] = z[e];
  }
  if (tid == 0) {
    dt_out[row] = sh.dt;
    acc_out[row] = acc;
    rej_out[row] = rej;
    inc_out[row] = inc;
  }
}

}  // namespace

// Launches one block per row on `stream`. The field's layers map H ->
// hidden -> ... -> H*C (weights, biases: n_layers device pointers; dims:
// n_layers+1 widths). path_c and path_d are both null (linear) or both
// set (cubic). The tableau arrays are as for fused_ode_solve_launch.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fused_cde_solve_launch(
    const float* z0, const float* path_ts, const float* path_b, const float* path_c,
    const float* path_d, const float* eval_ts, float dt0,
    const void* const* weights, const void* const* biases, const int* dims,
    int n_layers, int act, const float* tab_a, const float* tab_b_sol,
    const float* tab_b_err, const float* tab_c, int stages, int fsal, float expo,
    float rtol, float atol, float safety, float factor_min, float factor_max,
    int max_steps, float* zs, float* dt_out, int* acc, int* rej, int* inc,
    int n_rows, int C, int T, int E, void* stream) {
  FieldParams fp;
  TableauParams tp;
  const int hidden_max = fill_field(fp, weights, biases, dims, n_layers, act);
  const int H = dims[0];
  if (hidden_max == 0 || n_layers < 2 || n_rows < 1 || C < 1 || T < 2 || E < 1 ||
      dims[n_layers] != H * C || (path_c == nullptr) != (path_d == nullptr) ||
      !fill_tableau(tp, tab_a, tab_b_sol, tab_b_err, tab_c, stages, fsal, expo))
    return (int)cudaErrorInvalidValue;
  ControlParams cp{rtol, atol, safety, factor_min, factor_max, max_steps};

  const size_t smem = sizeof(float) *
      ((size_t)(4 + stages) * round_up32(H) + 2 * (size_t)round_up32(hidden_max) +
       round_up32(C) + round_up32(T) + round_up32(E));
  cudaError_t e = allow_smem(fused_cde_solve_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  fused_cde_solve_kernel<<<n_rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      z0, path_ts, path_b, path_c, path_d, eval_ts, dt0, fp, tp, cp, zs, dt_out, acc,
      rej, inc, H, C, T, E, hidden_max);
  return (int)cudaGetLastError();
}
