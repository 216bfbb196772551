// Fused adaptive ODE solve: one frame interval of the ODE-RNN pose core.
//
// Replaces the TPU kernel `fused_ode_solve` in
// ode_vio_tpu/ops/pallas_kernels.py (its pallas_call body, the row-masked
// while loop). For every row it integrates dy/dt = MLP(y) (activation on
// the hidden layers, tanh on the last) from t0 to t1 with an embedded
// explicit RK pair (dopri5 in the flagship, FSAL), RMS error control, the
// integral step controller, the landing clamped on t1, a max_steps budget
// and a per-row dt0 warm start (adaptive_rk.cuh). Outputs y1, dt_final,
// accepted, rejected, incomplete, exactly as the TPU kernel does.
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

#include "adaptive_rk.cuh"

namespace {

// k = MLP(y), the hidden layers ping-ponging between ha and hb; the field
// is autonomous, t is not read.
struct OdeField {
  const FieldParams& fp;
  float* ha;
  float* hb;

  __device__ void operator()(float, const float* y, float* k) {
    const float* in = y;
    for (int l = 0; l < fp.n_layers; ++l) {
      const bool last = l == fp.n_layers - 1;
      float* out = last ? k : (l % 2 == 0 ? ha : hb);
      dense(fp.w[l], fp.b[l], in, out, fp.dims[l], fp.dims[l + 1], fp.vec4,
            fp.act, last);
      in = out;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
fused_ode_solve_kernel(const float* __restrict__ y0, const float* __restrict__ t0,
                       const float* __restrict__ t1, const float* __restrict__ dt0,
                       FieldParams fp, TableauParams tp, ControlParams cp,
                       float* __restrict__ y_out, float* __restrict__ dt_out,
                       int* __restrict__ acc_out, int* __restrict__ rej_out,
                       int* __restrict__ inc_out, int F, int hidden_max) {
  extern __shared__ __align__(16) float smem[];
  __shared__ SolveShared sh;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int Fp = round_up32(F);
  const int Hp = round_up32(hidden_max);
  float* y = smem;
  float* y1 = y + Fp;
  float* ytmp = y1 + Fp;
  float* f = ytmp + Fp;       // FSAL cache: f(t, y)
  float* ks = f + Fp;         // stages 1..S-1 (stage 0 too without FSAL)
  float* ha = ks + tp.stages * Fp;
  float* hb = ha + Hp;

  for (int e = tid; e < F; e += blockDim.x) y[e] = y0[(size_t)row * F + e];
  if (tid == 0) sh.dt = dt0[row];
  __syncthreads();

  OdeField field{fp, ha, hb};
  int acc = 0, rej = 0, inc = 0;  // meaningful in thread 0
  adaptive_solve(field, tp, cp, t0[row], t1[row], F, y, y1, ytmp, f, ks, sh,
                 &acc, &rej, &inc);

  for (int e = tid; e < F; e += blockDim.x) y_out[(size_t)row * F + e] = y[e];
  if (tid == 0) {
    dt_out[row] = sh.dt;
    acc_out[row] = acc;
    rej_out[row] = rej;
    inc_out[row] = inc;
  }
}

}  // namespace

// Launches one block per row on `stream`. Host arrays: weights/biases hold
// n_layers device pointers, dims n_layers+1 widths, tab_a kMaxStages^2
// row-major stage coefficients, tab_b_sol/tab_b_err/tab_c kMaxStages
// weights and stage times. Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int fused_ode_solve_launch(
    const float* y0, const float* t0, const float* t1, const float* dt0,
    const void* const* weights, const void* const* biases, const int* dims,
    int n_layers, int act, const float* tab_a, const float* tab_b_sol,
    const float* tab_b_err, const float* tab_c, int stages, int fsal, float expo,
    float rtol, float atol, float safety, float factor_min, float factor_max,
    int max_steps, float* y1, float* dt_out, int* acc, int* rej, int* inc,
    int n_rows, void* stream) {
  FieldParams fp;
  TableauParams tp;
  const int hidden_max = fill_field(fp, weights, biases, dims, n_layers, act);
  if (hidden_max == 0 || n_rows < 1 || dims[0] != dims[n_layers] ||
      !fill_tableau(tp, tab_a, tab_b_sol, tab_b_err, tab_c, stages, fsal, expo))
    return (int)cudaErrorInvalidValue;
  ControlParams cp{rtol, atol, safety, factor_min, factor_max, max_steps};

  const int F = dims[0];
  const size_t smem = sizeof(float) *
      ((size_t)(4 + stages) * round_up32(F) + 2 * (size_t)round_up32(hidden_max));
  cudaError_t e = allow_smem(fused_ode_solve_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  fused_ode_solve_kernel<<<n_rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      y0, t0, t1, dt0, fp, tp, cp, y1, dt_out, acc, rej, inc, F, hidden_max);
  return (int)cudaGetLastError();
}
