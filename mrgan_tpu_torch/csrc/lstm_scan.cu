// The Keras-2.0.9 LSTM recurrence for the WGAN-LP-CT variant zoo, forward
// and backward through time, each in one launch over every sequence.
//
// Not a port of a Pallas kernel: on the TPU the recurrence is a lax.scan
// (mrgan_tpu/models/variant_nets.py:147-169) that XLA compiles into one
// device loop. Eager PyTorch would dispatch ~8 operations a step and
// direction, ~20,000 host dispatches a forward at T = 1,280, so the loop
// over time runs here. Semantics (variant_nets.py:142-169): gate order i, f,
// c, o; hard_sigmoid(x) = clip(0.2x + 0.5, 0, 1) on i, f and o; c = f*c +
// i*tanh(g); h = o*tanh(c); a reverse sequence walks t = T-1 ... 0 and its
// outputs stay time-aligned.
//
// What bounds it: the T dependent steps of each sequence, not bytes or
// FLOPs. A step is a few dozen FMAs, two tanhf and U shuffles, but each
// needs the previous step's h. So everything a step needs stays on the SM:
// the recurrent weights in registers (4U floats a thread), h and c in
// registers, h broadcast within the sequence's U lanes by __shfl_sync; the
// step's inputs are loaded kAhead steps before they are needed, so the
// load latency leaves the dependent chain; and every sequence of every
// fold and direction runs in the same launch, one pass per launch.
//
// Layout: S = folds x dirs sequences (s = fold * dirs + d; with dirs = 2,
// d = 1 runs backwards), U lanes of a warp per sequence row, one lane per
// unit. All tensors are float32, contiguous, time-aligned:
//   xw (S, T, B, 4U)  input projection x @ wx + b (made outside, by cuBLAS)
//   wh (S, U, 4U)
//   h  (S, T, B, U)   outputs;  h_last (S, B, U) final states
//   zs (S, T, B, 4U)  pre-activations of i, f, o; tanh(g) in the c slot
//   c  (S, T, B, U)   cells
//   dz (S, T, B, 4U)  gate gradients (the backward's output); dwh, dwx, db
//                     and dx are products of it, taken outside (no atomics)
// Numerics: fp32, tanhf, no fast math; hard_sigmoid's products and sums
// are rounded one at a time, as the plain PyTorch version computes them.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 64;  // threads a block: 64 / U sequence rows
// steps of input loaded ahead of their use: 2 was faster than 8 and 32 on
// an H100 (the chain of a step, not the load latency, sets the pace, and a
// deeper unrolled ring only adds instructions)
constexpr int kAhead = 2;

__device__ __forceinline__ float hard_sigmoid(float z) {
  const float y = __fadd_rn(__fmul_rn(0.2f, z), 0.5f);
  return fminf(fmaxf(y, 0.0f), 1.0f);
}

// d hard_sigmoid / dz as jax.grad of jnp.clip gives it: 0.2 inside, half
// of it on a clip edge, 0 outside
__device__ __forceinline__ float hard_sigmoid_grad(float z) {
  const float y = __fadd_rn(__fmul_rn(0.2f, z), 0.5f);
  if (y > 0.0f && y < 1.0f) return 0.2f;
  return (y == 0.0f || y == 1.0f) ? 0.1f : 0.0f;
}

__device__ __forceinline__ int time_at(int p, int steps, bool rev) {
  return rev ? steps - 1 - p : p;
}

template <int U>
__global__ void __launch_bounds__(kThreads)
lstm_scan_fwd(const float* __restrict__ xw, const float* __restrict__ wh,
              int steps, int rows, int dirs, int reverse,
              float* __restrict__ h_seq, float* __restrict__ h_last,
              float* __restrict__ zs, float* __restrict__ c_seq) {
  constexpr int G = 4 * U;
  const int s = blockIdx.y;
  const int u = threadIdx.x % U;
  const int row = (blockIdx.x * kThreads + threadIdx.x) / U;
  // lanes past the last row run a copy of it in step with their warp (the
  // shuffles need every lane) and store nothing
  const bool active = row < rows;
  const int b = active ? row : rows - 1;
  const bool rev = dirs == 2 ? (s & 1) != 0 : reverse != 0;

  float w[4][U];  // w[g][k] = wh[s][k][g*U + u]: this unit's columns
  const float* whs = wh + (size_t)s * U * G;
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int k = 0; k < U; ++k) w[g][k] = whs[k * G + g * U + u];

  const size_t gstep = (size_t)rows * G;   // one step of xw, zs
  const size_t ustep = (size_t)rows * U;   // one step of h, c
  const float* xs = xw + (size_t)s * steps * gstep + (size_t)b * G + u;
  float* zp = zs ? zs + (size_t)s * steps * gstep + (size_t)b * G + u : nullptr;
  const size_t hoff = (size_t)s * steps * ustep + (size_t)b * U + u;

  float ring[kAhead][4];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < steps) {
      const float* src = xs + (size_t)time_at(j, steps, rev) * gstep;
#pragma unroll
      for (int g = 0; g < 4; ++g) ring[j][g] = __ldg(src + g * U);
    }
  }

  float h = 0.0f, c = 0.0f;
  for (int p0 = 0; p0 < steps; p0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int p = p0 + j;
      if (p < steps) {  // the same for every lane of the warp
        const int t = time_at(p, steps, rev);
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g] = ring[j][g];
        if (p + kAhead < steps) {
          const float* src =
              xs + (size_t)time_at(p + kAhead, steps, rev) * gstep;
#pragma unroll
          for (int g = 0; g < 4; ++g) ring[j][g] = __ldg(src + g * U);
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const float hk = __shfl_sync(0xffffffffu, h, k, U);
#pragma unroll
          for (int g = 0; g < 4; ++g) z[g] = fmaf(hk, w[g][k], z[g]);
        }
        const float tg = tanhf(z[2]);
        c = __fadd_rn(__fmul_rn(hard_sigmoid(z[1]), c),
                      __fmul_rn(hard_sigmoid(z[0]), tg));
        h = __fmul_rn(hard_sigmoid(z[3]), tanhf(c));
        if (active) {
          const size_t o = hoff + (size_t)t * ustep;
          if (h_seq) h_seq[o] = h;
          if (c_seq) c_seq[o] = c;
          if (zp) {
            float* dst = zp + (size_t)t * gstep;
            dst[0] = z[0];
            dst[U] = z[1];
            dst[2 * U] = tg;
            dst[3 * U] = z[3];
          }
        }
      }
    }
  }
  if (active) h_last[((size_t)s * rows + b) * U + u] = h;
}

template <int U>
__global__ void __launch_bounds__(kThreads)
lstm_scan_bwd(const float* __restrict__ dh_seq,
              const float* __restrict__ dh_last, const float* __restrict__ zs,
              const float* __restrict__ c_seq, const float* __restrict__ wh,
              int steps, int rows, int dirs, int reverse,
              float* __restrict__ dz) {
  constexpr int G = 4 * U;
  const int s = blockIdx.y;
  const int u = threadIdx.x % U;
  const int row = (blockIdx.x * kThreads + threadIdx.x) / U;
  const bool active = row < rows;
  const int b = active ? row : rows - 1;
  const bool rev = dirs == 2 ? (s & 1) != 0 : reverse != 0;

  float w[4][U];  // w[g][j] = wh[s][u][g*U + j]: this unit's row
  const float* whs = wh + (size_t)s * U * G + (size_t)u * G;
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < U; ++j) w[g][j] = whs[g * U + j];

  const size_t gstep = (size_t)rows * G;
  const size_t ustep = (size_t)rows * U;
  const size_t goff = (size_t)s * steps * gstep + (size_t)b * G + u;
  const size_t uoff = (size_t)s * steps * ustep + (size_t)b * U + u;

  // backward step q walks p = steps-1-q; a ring slot holds its four saved
  // gates, the previous step's cell and the output gradient
  float ring[kAhead][6];
  auto load = [&](float* slot, int q) {
    const int p = steps - 1 - q;
    const int t = time_at(p, steps, rev);
    const float* zsrc = zs + goff + (size_t)t * gstep;
#pragma unroll
    for (int g = 0; g < 4; ++g) slot[g] = __ldg(zsrc + g * U);
    slot[4] = p > 0 ? __ldg(c_seq + uoff +
                            (size_t)time_at(p - 1, steps, rev) * ustep)
                    : 0.0f;
    slot[5] = dh_seq ? __ldg(dh_seq + uoff + (size_t)t * ustep) : 0.0f;
  };
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    if (j < steps) load(ring[j], j);

  float c_t = steps > 0
      ? __ldg(c_seq + uoff + (size_t)time_at(steps - 1, steps, rev) * ustep)
      : 0.0f;
  const float dh_end =
      dh_last ? __ldg(dh_last + ((size_t)s * rows + b) * U + u) : 0.0f;
  float dh_rec = 0.0f, dc = 0.0f;
  for (int q0 = 0; q0 < steps; q0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int q = q0 + j;
      if (q < steps) {  // the same for every lane of the warp
        const int t = time_at(steps - 1 - q, steps, rev);
        const float zi = ring[j][0], zf = ring[j][1], tg = ring[j][2],
                    zo = ring[j][3], c_prev = ring[j][4];
        float dh = __fadd_rn(dh_rec, ring[j][5]);
        if (q == 0 && dh_last) dh = __fadd_rn(dh, dh_end);
        if (q + kAhead < steps) load(ring[j], q + kAhead);

        const float tc = tanhf(c_t);
        dc = __fadd_rn(dc, __fmul_rn(__fmul_rn(dh, hard_sigmoid(zo)),
                                     __fsub_rn(1.0f, __fmul_rn(tc, tc))));
        float d[4];
        d[0] = __fmul_rn(__fmul_rn(dc, tg), hard_sigmoid_grad(zi));
        d[1] = __fmul_rn(__fmul_rn(dc, c_prev), hard_sigmoid_grad(zf));
        d[2] = __fmul_rn(__fmul_rn(dc, hard_sigmoid(zi)),
                         __fsub_rn(1.0f, __fmul_rn(tg, tg)));
        d[3] = __fmul_rn(__fmul_rn(dh, tc), hard_sigmoid_grad(zo));
        dc = __fmul_rn(dc, hard_sigmoid(zf));
        if (active) {
          float* dst = dz + goff + (size_t)t * gstep;
#pragma unroll
          for (int g = 0; g < 4; ++g) dst[g * U] = d[g];
        }
        // dh of the step before: dz_t @ wh^T, this unit's entry
        float acc = 0.0f;
#pragma unroll
        for (int j2 = 0; j2 < U; ++j2) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            acc = fmaf(__shfl_sync(0xffffffffu, d[g], j2, U), w[g][j2], acc);
        }
        dh_rec = acc;
        c_t = c_prev;
      }
    }
  }
}

template <int U>
int launch_fwd(const float* xw, const float* wh, int n_seq, int steps,
               int rows, int dirs, int reverse, float* h_seq, float* h_last,
               float* zs, float* c_seq, cudaStream_t stream) {
  const dim3 grid((rows * U + kThreads - 1) / kThreads, n_seq);
  lstm_scan_fwd<U><<<grid, kThreads, 0, stream>>>(
      xw, wh, steps, rows, dirs, reverse, h_seq, h_last, zs, c_seq);
  return (int)cudaGetLastError();
}

template <int U>
int launch_bwd(const float* dh_seq, const float* dh_last, const float* zs,
               const float* c_seq, const float* wh, int n_seq, int steps,
               int rows, int dirs, int reverse, float* dz,
               cudaStream_t stream) {
  const dim3 grid((rows * U + kThreads - 1) / kThreads, n_seq);
  lstm_scan_bwd<U><<<grid, kThreads, 0, stream>>>(
      dh_seq, dh_last, zs, c_seq, wh, steps, rows, dirs, reverse, dz);
  return (int)cudaGetLastError();
}

}  // namespace

// The forward: h_seq, zs and c_seq may be null (not written); h_last is
// always written. Returns a cudaError_t, or -1 for a unit count the kernels
// are not compiled for (the variant zoo's are 4, the iwganlstm critic, and
// 16, the lstm classifier).
extern "C" int mrgan_lstm_scan_fwd(const float* xw, const float* wh,
                                   int n_seq, int steps, int rows, int units,
                                   int dirs, int reverse, float* h_seq,
                                   float* h_last, float* zs, float* c_seq,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (units) {
    case 4: return launch_fwd<4>(xw, wh, n_seq, steps, rows, dirs, reverse, h_seq, h_last, zs, c_seq, st);
    case 16: return launch_fwd<16>(xw, wh, n_seq, steps, rows, dirs, reverse, h_seq, h_last, zs, c_seq, st);
    default: return -1;
  }
}

// The backward: dh_seq or dh_last may be null (no gradient there).
extern "C" int mrgan_lstm_scan_bwd(const float* dh_seq, const float* dh_last,
                                   const float* zs, const float* c_seq,
                                   const float* wh, int n_seq, int steps,
                                   int rows, int units, int dirs, int reverse,
                                   float* dz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (units) {
    case 4: return launch_bwd<4>(dh_seq, dh_last, zs, c_seq, wh, n_seq, steps, rows, dirs, reverse, dz, st);
    case 16: return launch_bwd<16>(dh_seq, dh_last, zs, c_seq, wh, n_seq, steps, rows, dirs, reverse, dz, st);
    default: return -1;
  }
}
