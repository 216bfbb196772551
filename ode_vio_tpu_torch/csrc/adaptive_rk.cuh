// The adaptive explicit-RK solve shared by the port's solver kernels
// (fused_ode_solve.cu, fused_cde_solve.cu), as one persistent grid that
// steps every row together.
//
// Semantics: those of the port's solver core (ops/solvers/odeint.py, the
// while-mode solve of the JAX package): an embedded RK pair (dopri5 in the
// flagship, FSAL), RMS error control, the integral step controller, the
// last step clamped onto t_end, a max_steps budget per interval, rejected
// steps counted only while the row is active.
//
// Replaces the design of the TPU kernels' masked while loop
// (ode_vio_tpu/ops/pallas_kernels.py:115-186 for fused_ode_solve,
// solve_segment at :397-464 for fused_cde_solve): the field's weights stay
// resident in fast memory for the whole solve, and all rows advance
// together, a row that has landed or run out of budget masked out. On the
// TPU one core's VMEM held the weights; on an H100 one SM's 227 KB holds
// neither field, but the 132 SMs' ~30 MB hold either whole. So:
//
// - One block per SM, all co-resident (a cooperative launch, which refuses
//   a grid that cannot be). Each layer's outputs are split into contiguous
//   ranges balanced over the blocks (the plan, computed by the wrapper in
//   ops/cuda_kernels.py::ode_grid_plan / cde_grid_plan and passed as an
//   int array). At the start each block copies its rows of every layer
//   into its shared memory with one bulk asynchronous copy per layer
//   (cp.async.bulk into an mbarrier), and keeps them for the launch. Where
//   the plan finds a field too wide for that, the same kernel reads its
//   rows from global memory (L2) instead: the streamed path.
// - A layer's input (all rows) is read from global memory after a grid
//   barrier, a chunk of rows at a time, into shared memory; each output's
//   dot product runs inside one warp in a fixed order, so no sum crosses
//   blocks, no value is added atomically, and results are the same bits
//   run to run. The outputs go to global memory, and a grid barrier
//   publishes them to the next layer.
// - The block that owns output e of the last layer owns state component e
//   of every row: y, the FSAL cache, the stage vectors and the candidate
//   y1 stay in its shared memory. It forms the next stage's input for its
//   components and writes it to global memory, and writes its rows' partial
//   error sums.
// - The controller runs in every block, redundantly and identically: each
//   block sums the partial error sums over the blocks in block order and
//   updates every row's t, dt and counts in its own shared memory, so every
//   block takes the same branches and meets the same barriers. This costs
//   one grid barrier per step (after the last stage), and no barrier to
//   publish a decision.
//
// A row that is still active has taken exactly `step` steps, so masked
// lockstep gives each row the steps of its own loop. Inactive rows (landed,
// out of budget, zero-length) take no step, keep dt and count nothing. The
// stage sums are built term by term, the stage times rounded as the plain
// version rounds them (__fmul_rn, __fadd_rn).
//
// What bounds it: the phases between grid barriers, one per layer per
// field evaluation and one per step, and the weights' one pass into shared
// memory. A phase (the barrier, the bulk copy of the rows, the dots, the
// block's syncs) took 3.7 us in K2 and 6.6 us in K1 on an H100
// (chip_smoke.py's us_per_barrier), far above its multiply-adds. Computing
// a 128x128 layer whole in every block at 4 rows, instead of splitting it
// behind a barrier, took as long as the phase it saved.
//
// The products stay on the f32 CUDA cores, not the tensor cores: the rows
// are 1-96 while wgmma takes 64-row tiles, TF32 would move the
// field by ~1e-3 relative and break the per-row step-count equality the
// kernel is held to, and each block's share of a layer is a microsecond of
// FMAs or less.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxStages = 8;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

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

// The plan's header words; ops/cuda_kernels.py::PLAN_WORDS names them in
// the same order. Shared-memory offsets count floats from the dynamic
// shared memory's base, scratch offsets floats from the scratch buffer's.
// After the header, layer l's block ranges: n_blocks + 1 starts at
// kPlanHeader + l * (n_blocks + 1), in output rows (in h for the cde
// field's last layer).
enum PlanWord {
  kPlanBlocks = 0,
  kPlanRows,
  kPlanResident,
  kPlanRowChunk,
  kPlanSmemBytes,
  kPlanOwnMax,     // state components per block, at most
  kPlanOffX,       // a chunk of a layer's input rows
  kPlanOffG,       // cde: the last layer's tanh(.) * dX per chunk row
  kPlanOffDX,      // cde: dX/dt per chunk row
  kPlanOffState,   // y, y1, f, stage vectors: (3 + stages) x rows x own_max
  kPlanOffRows,    // per-row controller state: 13 arrays (Rows) x rows
  kPlanOffW,       // kMaxLayers words: each layer's resident rows
  kPlanScrXin = kPlanOffW + kMaxLayers,  // 2 x rows x F: stage inputs
  kPlanScrPartial,                       // n_blocks x rows: error sums
  kPlanScrH,                             // kMaxLayers words: hidden outputs
  kPlanScrFloats = kPlanScrH + kMaxLayers,
  kPlanHeader
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

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A barrier across the whole (co-resident) grid on a global arrival
// counter that is zero at launch: after the block's own barrier, thread 0
// adds one with release semantics and polls with acquire loads until the
// counter reaches n_blocks times the barriers passed. Writes before it are
// visible after it to every block that reads through L2 (__ldcg) or with
// a bulk copy (after a proxy fence). A wait of more than 10 s (a barrier is
// microseconds otherwise) traps, so a block left behind ends the launch
// with an error instead of hanging it.
struct GridBarrier {
  unsigned* arrivals;
  unsigned n_blocks;
  unsigned target;
  int count;

  __device__ void sync() {
    __syncthreads();
    target += n_blocks;
    ++count;
    if (threadIdx.x == 0) {
      asm volatile("red.release.gpu.global.add.u32 [%0], %1;" :: "l"(arrivals), "r"(1u) : "memory");
      unsigned seen;
      const uint64_t t0 = global_ns();
      for (unsigned spin = 1;; ++spin) {
        asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(seen) : "l"(arrivals) : "memory");
        if (seen >= target) break;
        if ((spin & 1023u) == 0 && global_ns() - t0 > 10000000000ull) __trap();
      }
    }
    __syncthreads();
  }
};

// The per-row controller state in shared memory, the same in every block:
// 13 arrays of n_rows words (ops/cuda_kernels.py::_ROW_WORDS).
struct Rows {
  float *t, *dt, *dtc, *t_end, *tstage, *s;  // s: cde, the stage time's offset on its segment
  int *live, *clamped, *accept, *acc, *rej, *inc, *seg;  // seg: cde, the stage time's segment

  __device__ void bind(float* base, int n) {
    t = base; dt = t + n; dtc = dt + n; t_end = dtc + n; tstage = t_end + n; s = tstage + n;
    int* ib = reinterpret_cast<int*>(s + n);
    live = ib; clamped = live + n; accept = clamped + n; acc = accept + n; rej = acc + n;
    inc = rej + n; seg = inc + n;
  }
};

// Whether any row is live; every thread reads the array (after a sync).
__device__ __forceinline__ bool any_live(const int* live, int n) {
  int any = 0;
  for (int r = 0; r < n; ++r) any |= live[r];
  return any != 0;
}

// The block's view of the launch: its place in the grid, its plan, its
// regions of shared and scratch memory.
struct Block {
  GridBarrier bar;
  uint64_t* stage_bar;   // the mbarrier of the input rows' bulk copies
  uint32_t stage_phase;
  const int* plan;   // in global memory: the header and every layer's starts
  int G, bid, n_rows, chunk, own_max;
  float* smem;
  float* scratch;
  Rows rows;

  __device__ int word(int w) const { return __ldg(plan + w); }
  __device__ int start(int l, int b) const { return word(kPlanHeader + l * (G + 1) + b); }
  __device__ int own0(int l) const { return start(l, bid); }
  __device__ int own(int l) const { return start(l, bid + 1) - start(l, bid); }
  __device__ float* sm(int w) const { return smem + word(w); }
  __device__ float* scr(int w) const { return scratch + word(w); }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* mbar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(mbar)), "r"(phase) : "memory");
  }
}

// Copies each layer's rows of this block into shared memory (the resident
// path): one bulk asynchronous copy per layer into one mbarrier where the
// rows are 16-byte multiples, by thread loads where they are not. Returns
// the weights' pointers, in shared memory or (streamed) in global memory.
__device__ void load_weights(const FieldParams& fp, const Block& blk, const int* unit_rows,
                             const float* w_out[kMaxLayers]) {
  __shared__ __align__(8) uint64_t mbar;
  const bool resident = blk.word(kPlanResident) != 0;
  for (int l = 0; l < fp.n_layers; ++l) {
    const size_t off = (size_t)blk.own0(l) * unit_rows[l] * fp.dims[l];
    w_out[l] = resident ? blk.sm(kPlanOffW + l) : fp.w[l] + off;
  }
  if (!resident) return;
  if (fp.vec4) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&mbar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      uint32_t total = 0;
      for (int l = 0; l < fp.n_layers; ++l)
        total += (uint32_t)blk.own(l) * unit_rows[l] * fp.dims[l] * 4u;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(smem_addr(&mbar)), "r"(total) : "memory");
      for (int l = 0; l < fp.n_layers; ++l) {
        const uint32_t bytes = (uint32_t)blk.own(l) * unit_rows[l] * fp.dims[l] * 4u;
        if (bytes == 0) continue;
        const float* src = fp.w[l] + (size_t)blk.own0(l) * unit_rows[l] * fp.dims[l];
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
            :: "r"(smem_addr(w_out[l])), "l"(src), "r"(bytes), "r"(smem_addr(&mbar)) : "memory");
      }
    }
    __syncthreads();
    mbar_wait(&mbar, 0);
  } else {
    for (int l = 0; l < fp.n_layers; ++l) {
      const int n = blk.own(l) * unit_rows[l] * fp.dims[l];
      const float* src = fp.w[l] + (size_t)blk.own0(l) * unit_rows[l] * fp.dims[l];
      float* dst = blk.sm(kPlanOffW + l);
      for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
    }
  }
  __syncthreads();
}

// Copies rows [r0, r0 + nr) of a (rows, width) array written in this
// launch by other blocks into xs: one bulk asynchronous copy where the
// rows are 16-byte multiples (thread 0 issues it after proxy fences: the
// rows were written through the generic proxy, and xs was last read
// through it), else thread loads through L2. The rows are in xs for every
// thread on return. In the bulk copy's branch that is all it orders: it is
// not a block barrier, so shared memory that threads wrote before the call
// needs a __syncthreads of its own before other threads read it.
__device__ __forceinline__ void stage_rows(Block& blk, const float* in, float* xs, int r0, int nr,
                                           int width, bool vec4) {
  const float* src = in + (size_t)r0 * width;
  const int n = nr * width;
  if (vec4) {
    if (threadIdx.x == 0) {
      asm volatile("fence.proxy.async.global;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(smem_addr(blk.stage_bar)), "r"((uint32_t)n * 4u) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          :: "r"(smem_addr(xs)), "l"(src), "r"((uint32_t)n * 4u), "r"(smem_addr(blk.stage_bar))
          : "memory");
    }
    mbar_wait(blk.stage_bar, blk.stage_phase);
    blk.stage_phase ^= 1u;
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) xs[i] = __ldcg(src + i);
    __syncthreads();
  }
}

// One stage of a butterfly that reduces 2H values over the lanes and
// scatters them: lanes with bit S set keep the upper half and trade the
// lower half with their partner.
template <int S, int H>
__device__ __forceinline__ void reduce_scatter_stage(float (&v)[16], int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = upper ? v[j] : v[j + H];
    const float keep = upper ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// The dot products w[j] . xs[rr] over in_dim inputs for j < n_out, rr < nr,
// in tiles of 4 outputs x 4 rows, one warp per tile: each lane takes every
// 32nd float4 of the inputs and accumulates the 16 products of its 4
// weight and 4 input vectors (each loaded once), and a reduce-scatter
// butterfly (16 shuffles) leaves the sum of value (lane >> 1) & 15 in lane
// pairs. A fixed order throughout. emit(j, rr, dot) runs for the pairs
// whose row r0 + rr is live.
template <class Emit>
__device__ __forceinline__ void tile_dots(const Block& blk, const float* w, const float* xs,
                                          int in_dim, int n_out, int nr, int r0, bool vec4,
                                          Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tr = (nr + 3) / 4, tiles = (n_out + 3) / 4 * tr;
  for (int t = warp; t < tiles; t += kWarps) {
    const int j0 = t / tr * 4, q0 = t % tr * 4;
    const float* wr[4];
    const float* xr[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      wr[a] = w + (size_t)min(j0 + a, n_out - 1) * in_dim;
      xr[a] = xs + (size_t)min(q0 + a, nr - 1) * in_dim;
    }
    float v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = 0.f;
    if (vec4) {
      for (int i = lane; i < in_dim / 4; i += 32) {
        float4 wv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          wv[a] = reinterpret_cast<const float4*>(wr[a])[i];
          xv[a] = reinterpret_cast<const float4*>(xr[a])[i];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            v[a * 4 + c] += wv[a].x * xv[c].x + wv[a].y * xv[c].y + wv[a].z * xv[c].z +
                            wv[a].w * xv[c].w;
      }
    } else {
      for (int i = lane; i < in_dim; i += 32) {
        float wv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          wv[a] = wr[a][i];
          xv[a] = xr[a][i];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) v[a * 4 + c] += wv[a] * xv[c];
      }
    }
    reduce_scatter_stage<16, 8>(v, lane);
    reduce_scatter_stage<8, 4>(v, lane);
    reduce_scatter_stage<4, 2>(v, lane);
    reduce_scatter_stage<2, 1>(v, lane);
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
    const int vi = (lane >> 1) & 15, j = j0 + vi / 4, rr = q0 + vi % 4;
    if ((lane & 1) == 0 && j < n_out && rr < nr && blk.rows.live[r0 + rr]) emit(j, rr, v[0]);
  }
}

// out[r * out_stride + j] = act(w[j] . in[r] + b[j]) (tanh where `last`)
// for the block's n_out outputs j and every live row r; `in` (rows, in_dim)
// in global memory, staged a chunk of rows at a time.
__device__ void dense_rows(Block& blk, const float* w, const float* __restrict__ b,
                           const float* in, float* out, int out_stride, int n_out, int in_dim,
                           bool vec4, int act, bool last) {
  if (n_out == 0) return;
  float* xs = blk.sm(kPlanOffX);
  for (int r0 = 0; r0 < blk.n_rows; r0 += blk.chunk) {
    const int nr = min(blk.chunk, blk.n_rows - r0);
    stage_rows(blk, in, xs, r0, nr, in_dim, vec4);
    tile_dots(blk, w, xs, in_dim, n_out, nr, r0, vec4, [&](int j, int rr, float s) {
      const float z = s + __ldg(b + j);
      out[(size_t)(r0 + rr) * out_stride + j] = last ? tanhf(z) : activation(z, act);
    });
    __syncthreads();
  }
}

// The field's hidden layers for every live row: layer l's own outputs to
// scratch, a grid barrier after each. Returns the last hidden output in
// scratch (or `xin` where there is none).
__device__ const float* hidden_layers(Block& blk, const FieldParams& fp,
                                      const float* const* w, const float* xin) {
  const float* in = xin;
  for (int l = 0; l < fp.n_layers - 1; ++l) {
    float* h = blk.scr(kPlanScrH + l);
    const int o0 = blk.own0(l);
    dense_rows(blk, w[l], fp.b[l] + o0, in, h + o0, fp.dims[l + 1], blk.own(l), fp.dims[l],
               fp.vec4, fp.act, false);
    blk.bar.sync();
    in = h;
  }
  return in;
}

// The attempts of a solve that no one records.
struct NoStepLog {
  __device__ void put(int, int, float, float) const {}
};

// Integrates every row from rows.t to rows.t_end, in lockstep, with the
// step proposals in rows.dt, which it updates; adds to the rows' counts.
// The block owns state components [e0, e0 + ne) of F: y, the FSAL cache
// f, the stage vectors ks and y1 in shared memory, (rows, own_max) each.
// `field.eval(blk, xin, k)` evaluates the field at every live row's
// rows.tstage on the stage input xin (rows, F) in scratch, after a grid
// barrier has published it, and writes the block's components of it into
// k (rows, own_max); it passes the same barriers in every block. `xsel`
// picks the half of the stage-input buffer to write next; `steps` and
// `evals` count lockstep steps and field evaluations. Block 0 hands each
// live row's attempt to `log.put(row, attempt, t, h)`: its start t and
// its step h, negated where the step was rejected.
template <class Field, class Log = NoStepLog>
__device__ void lockstep_solve(Field& field, Block& blk, const TableauParams& tp,
                               const ControlParams& cp, int F, int e0, int ne, int& xsel,
                               int& steps, int& evals, const Log& log = Log()) {
  const int tid = threadIdx.x;
  const int N = blk.n_rows, nm = blk.own_max;
  const int S = tp.stages, fsal = tp.fsal;
  Rows& rs = blk.rows;
  float* y = blk.sm(kPlanOffState);
  float* y1 = y + N * nm;
  float* f = y1 + N * nm;
  float* ks = f + N * nm;
  auto K = [=](int i) -> float* { return (i == 0 && fsal) ? f : ks + i * N * nm; };
  float* partial = blk.scr(kPlanScrPartial);
  auto xin = [&]() -> float* { return blk.scr(kPlanScrXin) + (size_t)xsel * N * F; };
  // writes the stage input (y, or y + dtc * sum_j a_ij k_j) of the block's
  // components for every live row, then publishes it
  auto publish_stage = [&](int i) -> const float* {
    float* x = xin();
    for (int q = tid; q < N * ne; q += blockDim.x) {
      const int r = q / ne, e = q % ne;
      if (!rs.live[r]) continue;
      const float ye = y[r * nm + e];
      float incr = 0.f;
      bool any = false;
      for (int j = 0; j < i; ++j) {
        const float c = tp.a[i][j];
        if (c == 0.f) continue;
        const float kj = K(j)[r * nm + e];
        incr = any ? incr + c * kj : c * kj;
        any = true;
      }
      x[(size_t)r * F + e0 + e] = any ? ye + rs.dtc[r] * incr : ye;
    }
    blk.bar.sync();
    xsel ^= 1;
    ++evals;
    return x;
  };

  // the FSAL cache f(t_start, y); an empty interval takes no step and needs none
  if (fsal) {
    for (int r = tid; r < N; r += blockDim.x) {
      rs.live[r] = rs.t_end[r] - rs.t[r] > 0.f;
      rs.tstage[r] = rs.t[r];
    }
    __syncthreads();
    if (any_live(rs.live, N)) field.eval(blk, publish_stage(0), f);
  }

  for (int step = 0;; ++step) {
    __syncthreads();
    for (int r = tid; r < N; r += blockDim.x) {
      const float remaining = fmaxf(rs.t_end[r] - rs.t[r], 0.f);
      rs.live[r] = (rs.t_end[r] - rs.t[r]) > 0.f && step < cp.max_steps;
      rs.clamped[r] = rs.dt[r] >= remaining;
      rs.dtc[r] = rs.clamped[r] ? remaining : rs.dt[r];
      rs.tstage[r] = rs.t[r];
    }
    __syncthreads();
    if (!any_live(rs.live, N)) {
      steps += step;
      break;
    }

    if (!fsal) field.eval(blk, publish_stage(0), K(0));
    for (int i = 1; i < S; ++i) {
      for (int r = tid; r < N; r += blockDim.x)
        rs.tstage[r] = __fadd_rn(rs.t[r], __fmul_rn(tp.c[i], rs.dtc[r]));
      field.eval(blk, publish_stage(i), K(i));  // publish_stage syncs first
    }

    // y1 and the block's part of each live row's squared error norm
    for (int r = tid; r < N; r += blockDim.x) {
      if (!rs.live[r]) continue;
      const float dtc = rs.dtc[r];
      float part = 0.f;
      for (int e = 0; e < ne; ++e) {
        float sol = 0.f, err = 0.f;
        bool any_sol = false, any_err = false;
        for (int j = 0; j < S; ++j) {
          const float k = K(j)[r * nm + e];
          const float cs = tp.b_sol[j], ce = tp.b_err[j];
          if (cs != 0.f) { sol = any_sol ? sol + cs * k : cs * k; any_sol = true; }
          if (ce != 0.f) { err = any_err ? err + ce * k : ce * k; any_err = true; }
        }
        const float ye = y[r * nm + e];
        const float ynew = ye + dtc * sol;
        const float scale = cp.atol + cp.rtol * fmaxf(fabsf(ye), fabsf(ynew));
        const float q = (dtc * err) / scale;
        part += q * q;
        y1[r * nm + e] = ynew;
      }
      partial[(size_t)r * blk.G + blk.bid] = part;
    }
    blk.bar.sync();

    // the controller, in every block: the same sums in the same order, one
    // warp per row (lane-strided over the blocks, then a butterfly)
    for (int r = tid >> 5; r < N; r += kWarps) {
      if (!rs.live[r]) continue;
      const int lane = tid & 31;
      float total = 0.f;
      for (int b = lane; b < blk.G; b += 32) total += __ldcg(partial + (size_t)r * blk.G + b);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
      if (lane != 0) continue;
      const float ratio = sqrtf(total / (float)F);
      const bool accept = ratio <= 1.f;
      const float safe = nan_max(ratio, 1e-10f);
      const float factor = nan_min(
          nan_max(cp.safety * powf(safe, tp.expo), cp.factor_min), cp.factor_max);
      const float dtc = rs.dtc[r], t = rs.t[r];
      if (blk.bid == 0) log.put(r, step, t, accept ? dtc : -dtc);
      rs.dt[r] = nan_max(dtc * factor, FLT_MIN);
      rs.t[r] = accept ? (rs.clamped[r] ? rs.t_end[r] : t + dtc) : t;
      rs.accept[r] = accept;
      rs.acc[r] += accept;
      rs.rej[r] += !accept;
    }
    __syncthreads();
    for (int q = tid; q < N * ne; q += blockDim.x) {
      const int r = q / ne, e = q % ne;
      if (!rs.live[r] || !rs.accept[r]) continue;
      y[r * nm + e] = y1[r * nm + e];
      if (fsal) f[r * nm + e] = K(S - 1)[r * nm + e];
    }
  }
  for (int r = tid; r < N; r += blockDim.x) rs.inc[r] += (rs.t_end[r] - rs.t[r]) > 0.f;
  __syncthreads();
}

// Sets up the block: its view of the plan, the barrier, the rows' counts.
__device__ void init_block(Block& blk, const int* plan, float* smem, float* scratch,
                           unsigned* arrivals) {
  __shared__ __align__(8) uint64_t stage_bar;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&stage_bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  blk.stage_bar = &stage_bar;
  blk.stage_phase = 0;
  blk.plan = plan;
  blk.G = blk.word(kPlanBlocks);
  blk.bid = blockIdx.x;
  blk.n_rows = blk.word(kPlanRows);
  blk.chunk = blk.word(kPlanRowChunk);
  blk.own_max = blk.word(kPlanOwnMax);
  blk.smem = smem;
  blk.scratch = scratch;
  blk.bar = GridBarrier{arrivals, (unsigned)blk.G, 0u, 0};
  blk.rows.bind(blk.sm(kPlanOffRows), blk.n_rows);
  for (int r = threadIdx.x; r < blk.n_rows; r += blockDim.x) {
    blk.rows.acc[r] = 0;
    blk.rows.rej[r] = 0;
    blk.rows.inc[r] = 0;
  }
  __syncthreads();
}

// Host side: the field's layers and the tableau from the wrapper's arrays.
// Returns false if the layers are not accepted.
inline bool fill_field(FieldParams& fp, const void* const* weights, const void* const* biases,
                       const int* dims, int n_layers, int act) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  int vec4 = 1;
  for (int l = 0; l < n_layers; ++l) {
    fp.w[l] = static_cast<const float*>(weights[l]);
    fp.b[l] = static_cast<const float*>(biases[l]);
    if (dims[l] % 4 != 0 || reinterpret_cast<uintptr_t>(weights[l]) % 16 != 0) vec4 = 0;
  }
  for (int l = 0; l <= n_layers; ++l) fp.dims[l] = dims[l];
  fp.n_layers = n_layers;
  fp.act = act;
  fp.vec4 = vec4;
  return true;
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

// Launches `kernel` as a cooperative grid of n_blocks blocks of kThreads
// on `stream` with `smem` bytes of dynamic shared memory: every block
// co-resident, or the launch is refused (the error is returned).
template <class Kernel>
inline cudaError_t launch_grid(Kernel kernel, int n_blocks, size_t smem, cudaStream_t stream,
                               void** args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (n_blocks < 1 || n_blocks > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(n_blocks),
                                  dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
