// Fused adaptive ODE solve: one frame interval of the ODE-RNN pose core.
//
// Replaces the TPU kernel `fused_ode_solve` in
// ode_vio_tpu/ops/pallas_kernels.py:42-210 (its pallas_call body, the
// row-masked while loop at :115-186 with the batched dot_general at
// :91-103). For every row it integrates dy/dt = MLP(y) (activation on the
// hidden layers, tanh on the last) from t0 to t1 with an embedded explicit
// RK pair (dopri5 in the flagship, FSAL), RMS error control, the integral
// step controller, the landing clamped on t1, a max_steps budget and a
// per-row dt0 warm start. Outputs y1, dt_final, accepted, rejected,
// incomplete, exactly as the TPU kernel does.
//
// Design (adaptive_rk.cuh): one persistent cooperative grid of one block
// per SM steps all rows together. The flagship field (softplus
// 768->1024->1024->768, 10.5 MB f32) is split by output neurons over the
// 132 blocks, about 8 rows of each hidden layer and 6 of the last, ~80 KB
// per block, copied into shared memory once per launch by bulk
// asynchronous copies and kept there. One grid barrier publishes each
// layer's outputs, and one more each step's error sums. The block that
// owns output e of the last layer owns y[:, e] and its stage vectors. The
// rows' inputs to a layer (12 x 1024 x 4 B = 48 KB at the main path's 12
// rows) are read from L2 after the barrier, in chunks of rows that fit
// beside the weights (three chunks at 96 rows).
//
// What bounds it: the grid barriers, 3 per field evaluation and 1 per
// step, and the weights' one pass into shared memory; the f32 FMAs are
// about a microsecond per block per evaluation. The one-block-per-row
// kernel this replaces used 12 of the 132 SMs at 12 rows, each
// streaming the whole field from L2 at every evaluation.

#include "adaptive_rk.cuh"

namespace {

// k = MLP(y) for every live row: the hidden layers over the grid, then the
// block's outputs of the last layer (tanh) into k. Autonomous: t is not read.
struct OdeField {
  const FieldParams& fp;
  const float* const* w;  // each layer's rows of this block, shared or global memory

  __device__ void eval(Block& blk, const float* xin, float* k) {
    const float* in = hidden_layers(blk, fp, w, xin);
    const int L = fp.n_layers;
    dense_rows(blk, w[L - 1], fp.b[L - 1] + blk.own0(L - 1), in, k, blk.own_max,
               blk.own(L - 1), fp.dims[L - 1], fp.vec4, fp.act, true);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
fused_ode_solve_kernel(const float* __restrict__ y0, const float* __restrict__ t0,
                       const float* __restrict__ t1, const float* __restrict__ dt0,
                       FieldParams fp, TableauParams tp, ControlParams cp,
                       const int* __restrict__ plan, float* scratch, unsigned* work,
                       float* __restrict__ y_out, float* __restrict__ dt_out,
                       int* __restrict__ acc_out, int* __restrict__ rej_out,
                       int* __restrict__ inc_out) {
  extern __shared__ __align__(128) float smem[];
  Block blk;
  init_block(blk, plan, smem, scratch, work);
  const int L = fp.n_layers, F = fp.dims[0], N = blk.n_rows, nm = blk.own_max;
  const int tid = threadIdx.x;
  int unit_rows[kMaxLayers];
  for (int l = 0; l < kMaxLayers; ++l) unit_rows[l] = 1;
  const float* w[kMaxLayers];
  load_weights(fp, blk, unit_rows, w);

  const int e0 = blk.own0(L - 1), ne = blk.own(L - 1);
  float* y = blk.sm(kPlanOffState);
  for (int q = tid; q < N * ne; q += blockDim.x)
    y[(q / ne) * nm + q % ne] = __ldg(y0 + (size_t)(q / ne) * F + e0 + q % ne);
  for (int r = tid; r < N; r += blockDim.x) {
    blk.rows.t[r] = __ldg(t0 + r);
    blk.rows.t_end[r] = __ldg(t1 + r);
    blk.rows.dt[r] = __ldg(dt0 + r);
  }
  __syncthreads();

  OdeField field{fp, w};
  int xsel = 0, steps = 0, evals = 0;
  lockstep_solve(field, blk, tp, cp, F, e0, ne, xsel, steps, evals);

  for (int q = tid; q < N * ne; q += blockDim.x)
    y_out[(size_t)(q / ne) * F + e0 + q % ne] = y[(q / ne) * nm + q % ne];
  if (blk.bid == 0) {
    for (int r = tid; r < N; r += blockDim.x) {
      dt_out[r] = blk.rows.dt[r];
      acc_out[r] = blk.rows.acc[r];
      rej_out[r] = blk.rows.rej[r];
      inc_out[r] = blk.rows.inc[r];
    }
    if (tid == 0) {
      work[1] = blk.bar.count;
      work[2] = steps;
      work[3] = evals;
    }
  }
}

}  // namespace

// Launches the solve of n_rows rows on `stream` as a cooperative grid of
// n_blocks blocks (one per SM; refused if they cannot all be resident)
// with the plan `plan` (device int32, ops/cuda_kernels.py::ode_grid_plan),
// smem_bytes of dynamic shared memory, the scratch buffer the plan sizes
// and `work` (4 device words, zero: the barrier's arrival counter; then
// the barriers, lockstep steps and field evaluations of the launch). Host
// arrays: weights/biases hold n_layers device pointers, dims n_layers+1
// widths, tab_a kMaxStages^2 row-major stage coefficients,
// tab_b_sol/tab_b_err/tab_c kMaxStages weights and stage times. Returns 0
// on success, else the CUDA error of the refused launch.
extern "C" int fused_ode_solve_launch(
    const float* y0, const float* t0, const float* t1, const float* dt0,
    const void* const* weights, const void* const* biases, const int* dims,
    int n_layers, int act, const float* tab_a, const float* tab_b_sol,
    const float* tab_b_err, const float* tab_c, int stages, int fsal, float expo,
    float rtol, float atol, float safety, float factor_min, float factor_max,
    int max_steps, float* y1, float* dt_out, int* acc, int* rej, int* inc,
    int n_rows, const int* plan, int n_blocks, int smem_bytes, float* scratch,
    unsigned* work, void* stream) {
  FieldParams fp;
  TableauParams tp;
  if (!fill_field(fp, weights, biases, dims, n_layers, act) || n_rows < 1 ||
      dims[0] != dims[n_layers] ||
      !fill_tableau(tp, tab_a, tab_b_sol, tab_b_err, tab_c, stages, fsal, expo))
    return (int)cudaErrorInvalidValue;
  ControlParams cp{rtol, atol, safety, factor_min, factor_max, max_steps};
  void* args[] = {&y0, &t0, &t1, &dt0, &fp, &tp, &cp, &plan, &scratch, &work,
                  &y1, &dt_out, &acc, &rej, &inc};
  return (int)launch_grid(fused_ode_solve_kernel, n_blocks, (size_t)smem_bytes,
                          static_cast<cudaStream_t>(stream), args);
}
