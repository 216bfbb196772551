// Fused neural-CDE solve: the whole multi-segment inference solve of the
// CDE and RDE pose cores.
//
// Replaces the TPU kernel `fused_cde_solve` in
// ode_vio_tpu/ops/pallas_kernels.py:213-526 (its pallas_call body, the
// segments' masked while loops in solve_segment at :397-464). For every row
// it solves dz/dt = tanh(MLP(z)).reshape(H, C) . dX/dt(t) through
// [path_ts[0]] + eval_ts, segment by segment: each segment a fresh
// adaptive solve with its own max_steps budget and FSAL re-init, the step
// size carried across segments from dt0 at the start, z written out at each
// segment's end, the step counts summed over the segments. The control path
// is piecewise linear (dX = b[k]) or cubic (dX = (3 d[k] s + 2 c[k]) s +
// b[k], s = t - ts[k]) on the segment k = clip(#{i : ts[i] <= t} - 1, 0,
// T-2), as the plain version's InterpolatedPath picks it
// (ops/interpolation.py). A zero-length segment (a repeated knot, or the
// carry mode's first segment) takes no step and leaves z and dt as they
// are.
//
// Design (adaptive_rk.cuh): one persistent cooperative grid of one block
// per SM steps all rows together, segment by segment as solve_segment
// does. The hidden layers (flagship cde: 3 x 128x128) are split by output
// neurons over the blocks, one grid barrier after each. The last layer
// (H*C x hidden, 8.5 MB f32 at H 128, C 129) is split by h: a block owns
// whole h, all C of their rows (66 KB per h, resident in shared memory),
// and fuses the layer with the contraction over C: for each live row it
// computes dX/dt at that row's own stage time, then dz[h] = sum_c
// tanh(W[h*C + c] . x + b) * dX[c], the dot products in tiles of 4
// outputs x 4 rows per warp, the C terms summed by one warp in a fixed
// order. The (H*C) activation
// never leaves the block, dz[h] needs no sum across blocks, and the block
// owns z[:, h] and its stage vectors. Grid barriers: one per hidden layer and one for the
// stage input per field evaluation (4 at the flagship), one per step for
// the error sums. The hidden layers are not held in a thread-block cluster
// (which would leave one grid barrier per evaluation). A cooperative launch
// through cudaLaunchKernelEx does take cluster dimensions: on an H100 all
// 132 blocks are co-resident in clusters of 2, not of 4 (30 of 33 fit). But
// a bare grid barrier there costs ~1.0 us and a cluster barrier ~0.74 us,
// while a layer phase here costs ~3.7 us: the phase's own work, not the
// barrier, sets the pace (PERF.md).
//
// What bounds it: those barriers, thousands per launch on the main path's
// input, and the weights' one pass into shared memory. The one-block-per-
// row kernel this replaces ran 4 of the 132 SMs at 4 rows, each
// streaming the last layer from L2 at every evaluation, with 276 bytes of
// register spills from a 32-output butterfly, which is gone.

#include "adaptive_rk.cuh"

namespace {

// dz = g(z) . dX/dt(t) for every live row at its rows.tstage: the hidden
// layers over the grid, then the block's h of the fused last layer.
struct CdeField {
  const FieldParams& fp;
  const float* const* w;             // each layer's rows of this block
  const float* __restrict__ ts;      // (N, T) knot times
  const float* __restrict__ cb;      // (N, T-1, C) path coefficients
  const float* __restrict__ cc;      // null for a linear path
  const float* __restrict__ cd;
  int T, C;

  __device__ void eval(Block& blk, const float* xin, float* dz) {
    const float* in = hidden_layers(blk, fp, w, xin);
    const int L = fp.n_layers;
    const int nh = blk.own(L - 1);
    if (nh == 0) return;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int N = blk.n_rows, nm = blk.own_max, in_dim = fp.dims[L - 1];
    const int n_out = nh * C, gstride = nm * C;
    const float* wl = w[L - 1];
    const float* bl = fp.b[L - 1] + (size_t)blk.own0(L - 1) * C;
    Rows& rs = blk.rows;
    float* xs = blk.sm(kPlanOffX);
    float* g = blk.sm(kPlanOffG);
    float* dX = blk.sm(kPlanOffDX);

    for (int r = tid; r < N; r += blockDim.x) {
      if (!rs.live[r]) continue;
      const float t = rs.tstage[r];
      int n_le = 0;  // #{i : ts[i] <= t}, searchsorted(ts, t, 'right')
      for (int i = 0; i < T; ++i) n_le += __ldg(ts + (size_t)r * T + i) <= t;
      const int k = min(max(n_le - 1, 0), T - 2);
      rs.seg[r] = k;
      rs.s[r] = t - __ldg(ts + (size_t)r * T + k);
    }
    __syncthreads();
    for (int r0 = 0; r0 < N; r0 += blk.chunk) {
      const int nr = min(blk.chunk, N - r0);
      for (int q = tid; q < nr * C; q += blockDim.x) {
        const int r = r0 + q / C, c = q % C;
        if (!rs.live[r]) continue;
        const size_t base = ((size_t)r * (T - 1) + rs.seg[r]) * C + c;
        const float slope = __ldg(cb + base);
        if (cc == nullptr) {
          dX[q] = slope;
        } else {  // (3 d s + 2 c) s + b, each product and sum rounded
          const float s = rs.s[r];
          float v = __fmul_rn(__fmul_rn(3.f, __ldg(cd + base)), s);
          v = __fadd_rn(v, __fmul_rn(2.f, __ldg(cc + base)));
          dX[q] = __fadd_rn(__fmul_rn(v, s), slope);
        }
      }
      __syncthreads();  // every warp's emit below reads dX of every thread
      stage_rows(blk, in, xs, r0, nr, in_dim, fp.vec4);
      tile_dots(blk, wl, xs, in_dim, n_out, nr, r0, fp.vec4, [&](int j, int rr, float o) {
        g[rr * gstride + j] = tanhf(o + __ldg(bl + j)) * dX[rr * C + j % C];
      });
      __syncthreads();
      // dz[h] = sum over c, one warp per (row, h): lane-strided, then a butterfly
      for (int q = warp; q < nr * nh; q += kWarps) {
        const int rr = q / nh, h = q % nh;
        if (!rs.live[r0 + rr]) continue;
        const float* gr = g + rr * gstride + h * C;
        float acc = 0.f;
        for (int c = lane; c < C; c += 32) acc += gr[c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) dz[(r0 + rr) * nm + h] = acc;
      }
      __syncthreads();
    }
  }
};

__global__ void __launch_bounds__(kThreads, 1)
fused_cde_solve_kernel(const float* __restrict__ z0, const float* __restrict__ path_ts,
                       const float* __restrict__ path_b, const float* __restrict__ path_c,
                       const float* __restrict__ path_d, const float* __restrict__ eval_ts,
                       float dt0, FieldParams fp, TableauParams tp, ControlParams cp,
                       const int* __restrict__ plan, float* scratch, unsigned* work,
                       float* __restrict__ zs_out, float* __restrict__ dt_out,
                       int* __restrict__ acc_out, int* __restrict__ rej_out,
                       int* __restrict__ inc_out, int C, int T, int E) {
  extern __shared__ __align__(128) float smem[];
  Block blk;
  init_block(blk, plan, smem, scratch, work);
  const int L = fp.n_layers, H = fp.dims[0], N = blk.n_rows, nm = blk.own_max;
  const int tid = threadIdx.x;
  int unit_rows[kMaxLayers];
  for (int l = 0; l < kMaxLayers; ++l) unit_rows[l] = l == L - 1 ? C : 1;
  const float* w[kMaxLayers];
  load_weights(fp, blk, unit_rows, w);

  const int h0 = blk.own0(L - 1), nh = blk.own(L - 1);
  float* z = blk.sm(kPlanOffState);
  for (int q = tid; q < N * nh; q += blockDim.x)
    z[(q / nh) * nm + q % nh] = __ldg(z0 + (size_t)(q / nh) * H + h0 + q % nh);
  for (int r = tid; r < N; r += blockDim.x) blk.rows.dt[r] = dt0;

  CdeField field{fp, w, path_ts, path_b, path_c, path_d, T, C};
  int xsel = 0, steps = 0, evals = 0;
  for (int j = 0; j < E; ++j) {
    // segment 0 runs from the path's first knot, segment j from eval_ts[j-1]
    for (int r = tid; r < N; r += blockDim.x) {
      blk.rows.t[r] = j == 0 ? __ldg(path_ts + (size_t)r * T)
                             : __ldg(eval_ts + (size_t)r * E + j - 1);
      blk.rows.t_end[r] = __ldg(eval_ts + (size_t)r * E + j);
    }
    __syncthreads();
    lockstep_solve(field, blk, tp, cp, H, h0, nh, xsel, steps, evals);
    for (int q = tid; q < N * nh; q += blockDim.x)
      zs_out[((size_t)(q / nh) * E + j) * H + h0 + q % nh] = z[(q / nh) * nm + q % nh];
  }
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
// n_blocks blocks with the plan `plan` (device int32,
// ops/cuda_kernels.py::cde_grid_plan), smem_bytes of dynamic shared memory,
// the scratch buffer the plan sizes and `work`, as fused_ode_solve_launch.
// The field's layers map H -> hidden -> ... -> H*C (weights, biases:
// n_layers device pointers; dims: n_layers+1 widths). path_c and path_d
// are both null (linear) or both set (cubic). The tableau arrays are as for
// fused_ode_solve_launch. Returns 0 on success, else the CUDA error.
extern "C" int fused_cde_solve_launch(
    const float* z0, const float* path_ts, const float* path_b, const float* path_c,
    const float* path_d, const float* eval_ts, float dt0,
    const void* const* weights, const void* const* biases, const int* dims,
    int n_layers, int act, const float* tab_a, const float* tab_b_sol,
    const float* tab_b_err, const float* tab_c, int stages, int fsal, float expo,
    float rtol, float atol, float safety, float factor_min, float factor_max,
    int max_steps, float* zs, float* dt_out, int* acc, int* rej, int* inc,
    int n_rows, int C, int T, int E, const int* plan, int n_blocks, int smem_bytes,
    float* scratch, unsigned* work, void* stream) {
  FieldParams fp;
  TableauParams tp;
  if (!fill_field(fp, weights, biases, dims, n_layers, act) || n_layers < 2 || n_rows < 1 ||
      C < 1 || T < 2 || E < 1 || dims[n_layers] != dims[0] * C ||
      (path_c == nullptr) != (path_d == nullptr) ||
      !fill_tableau(tp, tab_a, tab_b_sol, tab_b_err, tab_c, stages, fsal, expo))
    return (int)cudaErrorInvalidValue;
  ControlParams cp{rtol, atol, safety, factor_min, factor_max, max_steps};
  void* args[] = {&z0, &path_ts, &path_b, &path_c, &path_d, &eval_ts, &dt0, &fp, &tp, &cp,
                  &plan, &scratch, &work, &zs, &dt_out, &acc, &rej, &inc, &C, &T, &E};
  return (int)launch_grid(fused_cde_solve_kernel, n_blocks, (size_t)smem_bytes,
                          static_cast<cudaStream_t>(stream), args);
}
