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
// What bounds them on an H100. Each of the S x B sequence rows is a chain of
// T dependent steps, and a warp walks its rows one step at a time. At small
// launches (the iwganlstm generator update's 12 x 128 rows, one row alone)
// a step's latency sets the time: two tanhf in series (each MUFU.EX2 then
// MUFU.RCP) and a shuffle in the forward, a 16-term sum behind 16 shuffles
// in the backward; ~125 and ~160 ns a step. At a critic update (12 x 384)
// the bytes do: the forward stores h, c and the gates (96 B a cell), the
// backward reads the gates and cells and writes dz (144 B a cell). The
// design keeps everything but the chain off the step:
// - Lanes a row (LPR, a template parameter: 2 or 4 at U = 4, 16 at
//   U = 16). Each lane holds U / LPR units: their h, c and recurrent
//   weights in registers; h (and the backward's dz) is gathered from the
//   row's lanes by __shfl_sync (independent shuffles). Fewer lanes a row
//   mean fewer warps and shuffles but more instructions a lane: the
//   wrapper picks by the launch's rows. (1 lane a row at U = 4 and 8 at
//   U = 16 were slower at every shape measured.)
// - No global load on the chain: each block (one warp, 32 / LPR rows)
//   stages its step inputs a chunk of steps at a time into shared memory
//   with cp.async, double-buffered, the next chunk in flight while this one
//   is walked. The stores are 4 * (U / LPR)-byte vectors of a lane's
//   contiguous units, coalesced across the warp, and nothing waits for
//   them; no branch or 64-bit index product sits in the step (offsets move
//   a step at a time; lanes past the last row redo it).
// - The input projection is fused where in = 1 (the iwganlstm critic, the
//   lstm classifier's first layer): the forward reads x, one float a cell,
//   with wx and b in registers, and rounds x * wx + b as the matmul did.
// - Sums: at U = 16, h @ wh in 4 partial sums added to the input last and
//   the backward's dz @ wh^T in two partial sums a gate, a quarter and an
//   eighth as deep as one chain each. At U = 4 both stay one chain in unit
//   order (the forward's is 4 deep either way), the order the first
//   version of these kernels used: the iwganlstm critic's outputs and
//   gradients, and so the trained cells that chip_smoke.py holds to the
//   JAX record, stay bit for bit those; dx stays a product of dz outside
//   for the same reason.
// Every lanes-a-row variant computes the same sums in the same order, so
// they agree bit for bit.
//
// Layout: S = folds x dirs sequences (s = fold * dirs + d; with dirs = 2,
// d = 1 runs backwards). All tensors are float32, contiguous, time-aligned:
//   x  (F, T, B)        the input where in = 1; wx, b (S, 4U)
//   xw (S, T, B, 4U)    otherwise: x @ wx + b (made outside, by cuBLAS)
//   wh (S, U, 4U)
//   h  (S, T, B, U)     outputs;  h_last (S, B, U) final states
//   zs (S, T, B, 4U)    pre-activations of i, f, o; tanh(g) in the c slot
//   c  (S, T, B, U)     cells
//   dz (S, T, B, 4U)    gate gradients (the backward's output); dx, dwh, dwx
//                       and db are products of it, taken outside (no atomics)
//   e, k (S, T, B, U)   the backward's carries (the second order's)
// Numerics: fp32, tanhf, no fast math; hard_sigmoid's products and sums
// are rounded one at a time, as the plain PyTorch version computes them.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarp = 32;               // threads a block: one warp
constexpr int kChunkBytes = 16 * 1024;  // the most one staged chunk may take

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// V consecutive floats as one access (V = 2: 8-byte aligned)
template <int V>
__device__ __forceinline__ void load_vec(float (&v)[V], const float* src) {
  if constexpr (V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(src);
    v[0] = a.x; v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = src[i];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = v[i];
  }
}

// copy(i, piece) for every step i < n of a staged chunk and each of its P
// pieces, spread over the warp's lanes (each lane keeps its pieces)
template <int P, class F>
__device__ __forceinline__ void for_pieces(int lane, int n, F&& copy) {
  if constexpr (P >= kWarp) {
    static_assert(P % kWarp == 0, "whole pieces a lane");
#pragma unroll
    for (int k = 0; k < P / kWarp; ++k)
      for (int i = 0; i < n; ++i) copy(i, lane + k * kWarp);
  } else {
    static_assert(kWarp % P == 0, "whole steps a pass");
    for (int i = lane / P; i < n; i += kWarp / P) copy(i, lane % P);
  }
}

// steps a staged chunk holds: the most (up to 32, a power of two) whose
// step_bytes each fit kChunkBytes
constexpr int chunk_steps(int step_bytes) {
  int n = 32;
  while (n > 1 && n * step_bytes > kChunkBytes) n /= 2;
  return n;
}

// the shapes of a (U, LPR) variant: units a lane, rows a block, and the
// staged chunks of the forward (FUSED: x, one float a row and step; else
// the row's 4U inputs, padded by 4 floats so that a warp's 16-byte reads of
// 32 rows fall in distinct banks), of the backward (the row's 4U saved
// gates, padded, then its U previous cells and U output gradients; with
// cotangents (COT) also the 4U gate cotangents, padded, and the U cell
// cotangents) and of the adjoint (the row's 4U cotangents on dz and 4U
// saved gates, both padded, then its U cells and the 2U carries e and k)
template <int U, int LPR, bool FUSED>
struct Layout {
  static_assert(U % 4 == 0 && U % LPR == 0 && kWarp % LPR == 0, "layout");
  static constexpr int G = 4 * U;
  static constexpr int UPL = U / LPR;
  static constexpr int RPB = kWarp / LPR;
  static constexpr int IN_LD = FUSED ? 1 : G + 4;
  static constexpr int FWD_TC = chunk_steps(RPB * IN_LD * 4);
  static constexpr int FWD_SMEM = 2 * FWD_TC * RPB * IN_LD * 4;
  static constexpr int Z_LD = G + 4;
  static constexpr int BWD_STEP = RPB * (Z_LD + 2 * U);  // floats a step
  static constexpr int BWD_TC = chunk_steps(BWD_STEP * 4);
  static constexpr int BWD_SMEM = 2 * BWD_TC * BWD_STEP * 4;
  static constexpr int COT_STEP = BWD_STEP + RPB * (Z_LD + U);
  static constexpr int COT_TC = chunk_steps(COT_STEP * 4);
  static constexpr int COT_SMEM = 2 * COT_TC * COT_STEP * 4;
  static constexpr int ADJ_STEP = RPB * (2 * Z_LD + 3 * U);
  static constexpr int ADJ_TC = chunk_steps(ADJ_STEP * 4);
  static constexpr int ADJ_SMEM = 2 * ADJ_TC * ADJ_STEP * 4;
};

struct FwdArgs {
  const float* x;    // (F, T, B) where in = 1, else null
  const float* wx;   // (S, 4U) where in = 1
  const float* b;    // (S, 4U) where in = 1
  const float* xw;   // (S, T, B, 4U) where in > 1, else null
  const float* wh;
  int steps, rows, dirs, reverse;
  float* h_seq;      // may be null
  float* h_last;
  float* zs;         // may be null (then so is c_seq)
  float* c_seq;
};

// SAVE: h, c and the gates of every step are stored (a forward that
// autograd will walk back); otherwise only h, where h_seq is given
template <int U, int LPR, bool FUSED, bool SAVE>
__global__ void __launch_bounds__(kWarp)
lstm_scan_fwd(const FwdArgs a) {
  using L = Layout<U, LPR, FUSED>;
  constexpr int G = L::G, UPL = L::UPL, RPB = L::RPB, LD = L::IN_LD;
  constexpr int TC = L::FWD_TC;
  constexpr int NP = U >= 16 ? 4 : 1;  // partial sums of h @ wh
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x;
  const int r = lane / LPR, q = lane % LPR;
  const int s = blockIdx.y;
  const int T = a.steps, B = a.rows;
  const int row0 = blockIdx.x * RPB;
  // lanes past the last row run a copy of it in step with their warp (the
  // shuffles need every lane): the same values to the same addresses
  const int row = min(row0 + r, B - 1);
  const bool rev = a.dirs == 2 ? (s & 1) != 0 : a.reverse != 0;
  const int u0 = q * UPL;

  float w[4][UPL][U];  // w[g][j][k] = wh[s][k][g*U + u0 + j]
  const float* whs = a.wh + (size_t)s * U * G;
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < UPL; ++j)
#pragma unroll
      for (int k = 0; k < U; ++k) w[g][j][k] = whs[k * G + g * U + u0 + j];
  float wxr[4][UPL], br[4][UPL];
  if constexpr (FUSED) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int j = 0; j < UPL; ++j) {
        wxr[g][j] = a.wx[(size_t)s * G + g * U + u0 + j];
        br[g][j] = a.b[(size_t)s * G + g * U + u0 + j];
      }
  }

  // stage processing steps [p0, p0 + TC) of the block's rows into buffer st
  auto stage = [&](int st, int p0) {
    const int n = min(TC, T - p0);
    float* dst = smem + st * TC * RPB * LD;
    if constexpr (FUSED) {  // a piece: one row's x
      const float* xs = a.x + (size_t)(s / a.dirs) * T * B;
      for_pieces<RPB>(lane, n, [&](int i, int rr) {
        cp_async4(dst + i * RPB + rr,
                  xs + (size_t)time_at(p0 + i, T, rev) * B + min(row0 + rr, B - 1));
      });
    } else {  // a piece: 16 bytes of one row's inputs
      constexpr int V = G / 4;
      for_pieces<RPB * V>(lane, n, [&](int i, int e) {
        const int rr = e / V, v = e % V;
        cp_async16(dst + (i * RPB + rr) * LD + 4 * v,
                   a.xw + (((size_t)s * T + time_at(p0 + i, T, rev)) * B +
                           min(row0 + rr, B - 1)) * G + 4 * v);
      });
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  // offsets of this lane's outputs at the step's time, moved a step at a
  // time (a reverse sequence walks down)
  const ptrdiff_t du = (rev ? -1 : 1) * (ptrdiff_t)B * U, dg = 4 * du;
  const int t0 = rev ? T - 1 : 0;
  ptrdiff_t ou = ((ptrdiff_t)s * T + t0) * B * U + (ptrdiff_t)row * U + u0;
  ptrdiff_t og = ((ptrdiff_t)s * T + t0) * B * G + (ptrdiff_t)row * G + u0;

  float h[UPL], c[UPL];
#pragma unroll
  for (int j = 0; j < UPL; ++j) h[j] = c[j] = 0.0f;

  stage(0, 0);
  for (int p0 = 0, st = 0; p0 < T; p0 += TC, st ^= 1) {
    stage(st ^ 1, p0 + TC);
    cp_async_wait_one();
    __syncwarp();
    const float* in = smem + st * TC * RPB * LD + r * LD;
    const int n = min(TC, T - p0);
#pragma unroll 2
    for (int i = 0; i < n; ++i) {
      float x_in[4][UPL];
      if constexpr (FUSED) {
        const float xv = in[i * RPB * LD];
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int j = 0; j < UPL; ++j)
            x_in[g][j] = __fadd_rn(__fmul_rn(xv, wxr[g][j]), br[g][j]);
      } else {
#pragma unroll
        for (int g = 0; g < 4; ++g) load_vec<UPL>(x_in[g], in + i * RPB * LD + g * U + u0);
      }
      float hall[U];
#pragma unroll
      for (int k = 0; k < U; ++k)
        hall[k] = __shfl_sync(0xffffffffu, h[k % UPL], k / UPL, LPR);
      float z[4][UPL];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < UPL; ++j) {
          if constexpr (NP == 1) {  // one chain from the input, k = 0 ... U-1
            z[g][j] = x_in[g][j];
#pragma unroll
            for (int k = 0; k < U; ++k) z[g][j] = fmaf(hall[k], w[g][j][k], z[g][j]);
          } else {
            float part[NP];
#pragma unroll
            for (int k = 0; k < NP; ++k) part[k] = __fmul_rn(hall[k], w[g][j][k]);
#pragma unroll
            for (int k = NP; k < U; ++k) part[k % NP] = fmaf(hall[k], w[g][j][k], part[k % NP]);
#pragma unroll
            for (int wd = NP / 2; wd > 0; wd /= 2)
#pragma unroll
              for (int k = 0; k < wd; ++k) part[k] = __fadd_rn(part[k], part[k + wd]);
            z[g][j] = __fadd_rn(x_in[g][j], part[0]);
          }
        }
#pragma unroll
      for (int j = 0; j < UPL; ++j) {
        const float tg = tanhf(z[2][j]);
        c[j] = __fadd_rn(__fmul_rn(hard_sigmoid(z[1][j]), c[j]),
                         __fmul_rn(hard_sigmoid(z[0][j]), tg));
        h[j] = __fmul_rn(hard_sigmoid(z[3][j]), tanhf(c[j]));
        z[2][j] = tg;  // the saved set holds tanh(g) in the c slot
      }
      if constexpr (SAVE) {
        store_vec<UPL>(a.h_seq + ou, h);
        store_vec<UPL>(a.c_seq + ou, c);
#pragma unroll
        for (int g = 0; g < 4; ++g) store_vec<UPL>(a.zs + og + g * U, z[g]);
      } else if (a.h_seq) {
        store_vec<UPL>(a.h_seq + ou, h);
      }
      ou += du;
      og += dg;
    }
    __syncwarp();  // every lane is done with buffer st before it is refilled
  }
  store_vec<UPL>(a.h_last + ((size_t)s * B + row) * U + u0, h);
}

// The backward, and the second order. What jax.grad of a penalty on the
// critic's input gradient (the Petzka Lipschitz penalty,
// mrgan_tpu/models/losses.py:90, mrgan_tpu/variants/wgan.py:162-166) runs
// through the lax.scan's transpose. The backward is linear in the output
// gradients but not in the saved gates and cells, so its own VJP is two
// passes:
// - lstm_scan_bwd again, with per-step cotangents on the saved gates and
//   cells added where they enter it (COT: it takes them back through the
//   forward recurrence), and, where the first backward is itself to be
//   differentiated, storing its carries e and k (CARRY) for the adjoint
//   (the C entry point mrgan_lstm_scan_bwd_ext);
// - lstm_scan_adj walks FORWARD in time: given a cotangent D on dz, it
//   carries the adjoints of the backward's two carries, the output
//   gradient e_t = dh_t + dz_{t+1} wh^T and the cell gradient k_t =
//   k_{t+1} f_{t+1} + e_t o_t (1 - tanh^2 c_t), and yields the cotangent
//   of e (the incoming dh, and through a product outside the kernel the
//   recurrent weights) and per-step cotangents on the saved gates and
//   cells, whose terms need tanh''; hard_sigmoid'' is 0.
// Both take the first order's design: the same lanes-a-row variants, the
// step inputs staged by cp.async in double-buffered chunks (a COT step's
// bytes nearly double, so its chunks hold half the steps; the adjoint
// reads each cell once, the previous one kept in a register), vector
// stores. COT and CARRY only add terms after the first backward's sums, in
// its order: without cotangents the second order's dz is lstm_scan_bwd's
// bit for bit, and every variant of each kernel agrees with the others
// bit for bit. In the adjoint only the gathered e_bar, the U-term sums
// into D and the products into kb and eb sit on the chain; tanhf(c), the
// hard-sigmoid factors and the output products are computed beside it,
// each rounded one at a time.
struct BwdArgs {
  const float* dh_seq;   // (S, T, B, U) or null
  const float* dh_last;  // (S, B, U) or null
  const float* zs;
  const float* c_seq;
  const float* wh;
  const float* dzs;      // (S, T, B, 4U) or null: cotangents on the saved gates
  const float* dcs;      // (S, T, B, U) or null: cotangents on the cells
  int steps, rows, dirs, reverse;
  float* dz;
  float* e_seq;          // (S, T, B, U) or null (then so is k_seq): each
  float* k_seq;          // step's output gradient e and cell gradient k
};

// SEQ: dh_seq is given (the outputs of every step had a gradient). COT:
// per-step cotangents on the saved gates and cells enter (a null one of
// dzs, dcs is staged as zeros). CARRY: each step's output gradient e and
// cell gradient k are stored, for lstm_scan_adj
template <int U, int LPR, bool SEQ, bool COT, bool CARRY>
__global__ void __launch_bounds__(kWarp)
lstm_scan_bwd(const BwdArgs a) {
  using L = Layout<U, LPR, false>;
  constexpr int G = L::G, UPL = L::UPL, RPB = L::RPB, ZLD = L::Z_LD;
  constexpr int TC = COT ? L::COT_TC : L::BWD_TC;
  constexpr int STEP = COT ? L::COT_STEP : L::BWD_STEP;
  constexpr int NPG = 2;  // partial sums a gate of dz @ wh^T at U = 16
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x;
  const int r = lane / LPR, q = lane % LPR;
  const int s = blockIdx.y;
  const int T = a.steps, B = a.rows;
  const int row0 = blockIdx.x * RPB;
  const int row = min(row0 + r, B - 1);  // as in the forward
  const bool rev = a.dirs == 2 ? (s & 1) != 0 : a.reverse != 0;
  const int u0 = q * UPL;

  float w[UPL][4][U];  // w[j][g][m] = wh[s][u0 + j][g*U + m]: this lane's rows
  const float* whs = a.wh + (size_t)s * U * G;
#pragma unroll
  for (int j = 0; j < UPL; ++j)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int m = 0; m < U; ++m) w[j][g][m] = whs[(u0 + j) * G + g * U + m];

  const size_t ustep = (size_t)B * U, gstep = (size_t)B * G;
  const size_t useq = (size_t)s * T * ustep, gseq = (size_t)s * T * gstep;
  // a chunk: [TC][RPB][ZLD] gates, [TC][RPB][U] previous cells, [TC][RPB][U]
  // output gradients, then with COT [TC][RPB][ZLD] gate cotangents and
  // [TC][RPB][U] cell cotangents; backward step q walks p = T-1-q
  auto stage = [&](int st, int q0) {
    const int n = min(TC, T - q0);
    float* zb = smem + st * TC * STEP;
    float* cb = zb + TC * RPB * ZLD;
    float* db = cb + TC * RPB * U;
    float* xzb = db + TC * RPB * U;
    float* xcb = xzb + TC * RPB * ZLD;
    // 16 bytes of src + o, or zeros where src is null
    auto copy16 = [](float* dst, const float* src, size_t o) {
      if (src) {
        cp_async16(dst, src + o);
      } else {
        dst[0] = dst[1] = dst[2] = dst[3] = 0.0f;
      }
    };
    constexpr int VZ = G / 4, VU = U / 4;  // 16-byte pieces a row
    for_pieces<RPB * VZ>(lane, n, [&](int i, int e) {
      const int rr = e / VZ, v = e % VZ;
      const size_t o = gseq + (size_t)time_at(T - 1 - (q0 + i), T, rev) * gstep +
                       (size_t)min(row0 + rr, B - 1) * G + 4 * v;
      cp_async16(zb + (i * RPB + rr) * ZLD + 4 * v, a.zs + o);
      if constexpr (COT) copy16(xzb + (i * RPB + rr) * ZLD + 4 * v, a.dzs, o);
    });
    for_pieces<RPB * VU>(lane, n, [&](int i, int e) {
      const int rr = e / VU, v = e % VU, p = T - 1 - (q0 + i);
      const size_t o = useq + (size_t)min(row0 + rr, B - 1) * U + 4 * v;
      const int at = (i * RPB + rr) * U + 4 * v;
      // a branch, not copy16 on a selected pointer: with the latter, ptxas
      // gave the first order's 2-lanes variant fewer registers and
      // serialised its 16 shuffles, a third slower at 12 x 384 rows
      if (p > 0) {
        cp_async16(cb + at, a.c_seq + o + (size_t)time_at(p - 1, T, rev) * ustep);
      } else {
        cb[at] = cb[at + 1] = cb[at + 2] = cb[at + 3] = 0.0f;
      }
      const size_t ot = o + (size_t)time_at(p, T, rev) * ustep;
      if constexpr (SEQ) cp_async16(db + at, a.dh_seq + ot);
      if constexpr (COT) copy16(xcb + at, a.dcs, ot);
    });
    cp_async_commit();
  };

  float c_t[UPL], dh_rec[UPL], dc[UPL];
  load_vec<UPL>(c_t, a.c_seq + useq + (size_t)time_at(T - 1, T, rev) * ustep +
                         (size_t)row * U + u0);
#pragma unroll
  for (int j = 0; j < UPL; ++j) dc[j] = dh_rec[j] = 0.0f;
  // the final state's gradient enters at the first backward step, as the
  // recurrent gradient does at every later one
  if (a.dh_last) load_vec<UPL>(dh_rec, a.dh_last + ((size_t)s * B + row) * U + u0);
  // offsets of this lane's outputs at the step's time: backward step q
  // is at time_at(T-1-q), which walks down (up for a reverse sequence)
  const int t0 = time_at(T - 1, T, rev);
  const ptrdiff_t dtb = (rev ? 1 : -1) * (ptrdiff_t)B;
  ptrdiff_t og = (ptrdiff_t)gseq + (ptrdiff_t)t0 * B * G + (ptrdiff_t)row * G + u0;
  ptrdiff_t ou = (ptrdiff_t)useq + (ptrdiff_t)t0 * B * U + (ptrdiff_t)row * U + u0;

  stage(0, 0);
  for (int q0 = 0, st = 0; q0 < T; q0 += TC, st ^= 1) {
    stage(st ^ 1, q0 + TC);
    cp_async_wait_one();
    __syncwarp();
    const float* base = smem + st * TC * STEP;
    const float* zb = base + r * ZLD;
    const float* cb = base + TC * RPB * ZLD + r * U;
    const float* db = cb + TC * RPB * U;
    const float* xzb = base + TC * RPB * (ZLD + 2 * U) + r * ZLD;
    const float* xcb = base + TC * RPB * (2 * ZLD + 2 * U) + r * U;
    const int n = min(TC, T - q0);
#pragma unroll 2
    for (int i = 0; i < n; ++i) {
      float zi[UPL], zf[UPL], tg[UPL], zo[UPL], c_prev[UPL], dh[UPL];
      load_vec<UPL>(zi, zb + i * RPB * ZLD + u0);
      load_vec<UPL>(zf, zb + i * RPB * ZLD + U + u0);
      load_vec<UPL>(tg, zb + i * RPB * ZLD + 2 * U + u0);
      load_vec<UPL>(zo, zb + i * RPB * ZLD + 3 * U + u0);
      load_vec<UPL>(c_prev, cb + i * RPB * U + u0);
      if constexpr (SEQ) {
        load_vec<UPL>(dh, db + i * RPB * U + u0);
#pragma unroll
        for (int j = 0; j < UPL; ++j) dh[j] = __fadd_rn(dh_rec[j], dh[j]);
      } else {
#pragma unroll
        for (int j = 0; j < UPL; ++j) dh[j] = dh_rec[j];
      }
      float xz[4][UPL], xc[UPL];
      if constexpr (COT) {
#pragma unroll
        for (int g = 0; g < 4; ++g) load_vec<UPL>(xz[g], xzb + i * RPB * ZLD + g * U + u0);
        load_vec<UPL>(xc, xcb + i * RPB * U + u0);
      }
      float d[4][UPL], k[UPL];
#pragma unroll
      for (int j = 0; j < UPL; ++j) {
        const float tc = tanhf(c_t[j]);
        if constexpr (COT) dc[j] = __fadd_rn(dc[j], xc[j]);
        dc[j] = __fadd_rn(dc[j], __fmul_rn(__fmul_rn(dh[j], hard_sigmoid(zo[j])),
                                           __fsub_rn(1.0f, __fmul_rn(tc, tc))));
        d[0][j] = __fmul_rn(__fmul_rn(dc[j], tg[j]), hard_sigmoid_grad(zi[j]));
        d[1][j] = __fmul_rn(__fmul_rn(dc[j], c_prev[j]), hard_sigmoid_grad(zf[j]));
        float dg = __fmul_rn(dc[j], hard_sigmoid(zi[j]));
        d[3][j] = __fmul_rn(__fmul_rn(dh[j], tc), hard_sigmoid_grad(zo[j]));
        if constexpr (COT) {  // the cotangent on tanh(g) enters before its derivative
          d[0][j] = __fadd_rn(d[0][j], xz[0][j]);
          d[1][j] = __fadd_rn(d[1][j], xz[1][j]);
          dg = __fadd_rn(dg, xz[2][j]);
          d[3][j] = __fadd_rn(d[3][j], xz[3][j]);
        }
        d[2][j] = __fmul_rn(dg, __fsub_rn(1.0f, __fmul_rn(tg[j], tg[j])));
        k[j] = dc[j];
        dc[j] = __fmul_rn(dc[j], hard_sigmoid(zf[j]));
        c_t[j] = c_prev[j];
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) store_vec<UPL>(a.dz + og + g * U, d[g]);
      if constexpr (CARRY) {
        store_vec<UPL>(a.e_seq + ou, dh);
        store_vec<UPL>(a.k_seq + ou, k);
      }
      og += 4 * U * dtb;
      ou += U * dtb;
      // dh of the step before: dz_t @ wh^T for this lane's units. At U = 4
      // one sum over the units and, within each, the gates (the first
      // version's order: the iwganlstm critic's gradients stay bit for
      // bit); at U = 16 two partial sums a gate, then the gates pairwise
      if constexpr (U == 4) {
        // the row's dz gathered from its lanes first: the shuffles stay in
        // flight together, ahead of the one chain of FMAs
        float dall[U][4];
#pragma unroll
        for (int m = 0; m < U; ++m)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            dall[m][g] = __shfl_sync(0xffffffffu, d[g][m % UPL], m / UPL, LPR);
        float acc[UPL];
#pragma unroll
        for (int j = 0; j < UPL; ++j) acc[j] = 0.0f;
#pragma unroll
        for (int m = 0; m < U; ++m)
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int j = 0; j < UPL; ++j) acc[j] = fmaf(dall[m][g], w[j][g][m], acc[j]);
#pragma unroll
        for (int j = 0; j < UPL; ++j) dh_rec[j] = acc[j];
      } else {
        float acc[UPL][4][NPG];
#pragma unroll
        for (int m = 0; m < U; ++m) {
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float dm = __shfl_sync(0xffffffffu, d[g][m % UPL], m / UPL, LPR);
#pragma unroll
            for (int j = 0; j < UPL; ++j) {
              float& ac = acc[j][g][m % NPG];
              ac = m < NPG ? __fmul_rn(dm, w[j][g][m]) : fmaf(dm, w[j][g][m], ac);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < UPL; ++j) {
          float pg[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            pg[g] = acc[j][g][0];
#pragma unroll
            for (int kk = 1; kk < NPG; ++kk) pg[g] = __fadd_rn(pg[g], acc[j][g][kk]);
          }
          dh_rec[j] = __fadd_rn(__fadd_rn(pg[0], pg[1]), __fadd_rn(pg[2], pg[3]));
        }
      }
    }
    __syncwarp();
  }
}

struct AdjArgs {
  const float* delta;  // (S, T, B, 4U): the cotangent on dz
  const float* zs;
  const float* c_seq;
  const float* e_seq;  // (S, T, B, U): the backward's carries
  const float* k_seq;
  const float* wh;
  int steps, rows, dirs, reverse;
  float* e_bar;        // (S, T, B, U): the cotangent on e (so on dh_seq)
  float* zs_bar;       // (S, T, B, 4U): on the saved zi, zf, tanh(g), zo
  float* c_bar;        // (S, T, B, U): on the cells
};

// the backward's VJP, forward in time (processing step p = 0 ... T-1)
template <int U, int LPR>
__global__ void __launch_bounds__(kWarp)
lstm_scan_adj(const AdjArgs a) {
  using L = Layout<U, LPR, false>;
  constexpr int G = L::G, UPL = L::UPL, RPB = L::RPB, ZLD = L::Z_LD;
  constexpr int TC = L::ADJ_TC, STEP = L::ADJ_STEP;
  constexpr int NP = U >= 16 ? 4 : 1;  // partial sums of e_bar @ wh
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x;
  const int r = lane / LPR, q = lane % LPR;
  const int s = blockIdx.y;
  const int T = a.steps, B = a.rows;
  const int row0 = blockIdx.x * RPB;
  const int row = min(row0 + r, B - 1);  // as in the forward
  const bool rev = a.dirs == 2 ? (s & 1) != 0 : a.reverse != 0;
  const int u0 = q * UPL;

  float w[4][UPL][U];  // w[g][j][m] = wh[s][m][g*U + u0 + j]: this lane's gate columns
  const float* whs = a.wh + (size_t)s * U * G;
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < UPL; ++j)
#pragma unroll
      for (int m = 0; m < U; ++m) w[g][j][m] = whs[m * G + g * U + u0 + j];

  const size_t ustep = (size_t)B * U, gstep = (size_t)B * G;
  const size_t useq = (size_t)s * T * ustep, gseq = (size_t)s * T * gstep;
  // a chunk: [TC][RPB][ZLD] cotangents on dz, [TC][RPB][ZLD] gates, then
  // [TC][RPB][U] cells, e and k each, steps [p0, p0 + TC)
  auto stage = [&](int st, int p0) {
    const int n = min(TC, T - p0);
    float* xb = smem + st * TC * STEP;
    float* zb = xb + TC * RPB * ZLD;
    float* cb = zb + TC * RPB * ZLD;
    float* eb = cb + TC * RPB * U;
    float* kb = eb + TC * RPB * U;
    constexpr int VZ = G / 4, VU = U / 4;  // 16-byte pieces a row
    for_pieces<RPB * VZ>(lane, n, [&](int i, int e) {
      const int rr = e / VZ, v = e % VZ;
      const size_t o = gseq + (size_t)time_at(p0 + i, T, rev) * gstep +
                       (size_t)min(row0 + rr, B - 1) * G + 4 * v;
      const int at = (i * RPB + rr) * ZLD + 4 * v;
      cp_async16(xb + at, a.delta + o);
      cp_async16(zb + at, a.zs + o);
    });
    for_pieces<RPB * VU>(lane, n, [&](int i, int e) {
      const int rr = e / VU, v = e % VU;
      const size_t o = useq + (size_t)time_at(p0 + i, T, rev) * ustep +
                       (size_t)min(row0 + rr, B - 1) * U + 4 * v;
      const int at = (i * RPB + rr) * U + 4 * v;
      cp_async16(cb + at, a.c_seq + o);
      cp_async16(eb + at, a.e_seq + o);
      cp_async16(kb + at, a.k_seq + o);
    });
    cp_async_commit();
  };

  // offsets of this lane's outputs at the step's time, moved a step at a
  // time (a reverse sequence walks down); c_bar is stored a step late
  const ptrdiff_t du = (rev ? -1 : 1) * (ptrdiff_t)B * U, dg = 4 * du;
  const int t0 = rev ? T - 1 : 0;
  ptrdiff_t ou = ((ptrdiff_t)s * T + t0) * B * U + (ptrdiff_t)row * U + u0;
  ptrdiff_t og = ((ptrdiff_t)s * T + t0) * B * G + (ptrdiff_t)row * G + u0;
  ptrdiff_t ou_prev = ou;

  // the adjoints of the step before's e and k, its cell (c at p-1 enters
  // step p's forget-gate term) and the part of its cell cotangent that
  // step p completes
  float e_bar[UPL], k_bar[UPL], c_prev[UPL], c_pend[UPL];
#pragma unroll
  for (int j = 0; j < UPL; ++j) e_bar[j] = k_bar[j] = c_prev[j] = c_pend[j] = 0.0f;

  stage(0, 0);
  for (int p0 = 0, st = 0; p0 < T; p0 += TC, st ^= 1) {
    stage(st ^ 1, p0 + TC);
    cp_async_wait_one();
    __syncwarp();
    const float* base = smem + st * TC * STEP;
    const float* xb = base + r * ZLD;
    const float* zb = xb + TC * RPB * ZLD;
    const float* cb = base + 2 * TC * RPB * ZLD + r * U;
    const float* eb = cb + TC * RPB * U;
    const float* kb = eb + TC * RPB * U;
    const int n = min(TC, T - p0);
#pragma unroll 2
    for (int i = 0; i < n; ++i) {
      // off the chain: the step's inputs and every factor they give
      float dl[4][UPL], z[4][UPL], c[UPL], e[UPL], k[UPL];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        load_vec<UPL>(dl[g], xb + i * RPB * ZLD + g * U + u0);
        load_vec<UPL>(z[g], zb + i * RPB * ZLD + g * U + u0);
      }
      load_vec<UPL>(c, cb + i * RPB * U + u0);
      load_vec<UPL>(e, eb + i * RPB * U + u0);
      load_vec<UPL>(k, kb + i * RPB * U + u0);
      float sf[UPL], a0[UPL], a1[UPL], a2[UPL], ao[UPL], a3[UPL];
      float kgf[UPL], zb0[UPL], kgi[UPL], zb2[UPL], zb3[UPL], ego[UPL], ces[UPL],
          dtc[UPL];
#pragma unroll
      for (int j = 0; j < UPL; ++j) {
        const float tg = z[2][j], tc = tanhf(c[j]);
        dtc[j] = __fsub_rn(1.0f, __fmul_rn(tc, tc));
        const float dtg = __fsub_rn(1.0f, __fmul_rn(tg, tg));
        const float si = hard_sigmoid(z[0][j]), so = hard_sigmoid(z[3][j]);
        const float gi = hard_sigmoid_grad(z[0][j]), gf = hard_sigmoid_grad(z[1][j]),
                    go = hard_sigmoid_grad(z[3][j]);
        sf[j] = hard_sigmoid(z[1][j]);
        a0[j] = __fmul_rn(tg, gi);         // dk / dD_i
        a1[j] = __fmul_rn(c_prev[j], gf);  // dk / dD_f
        a2[j] = __fmul_rn(si, dtg);        // dk / dD_g
        ao[j] = __fmul_rn(so, dtc[j]);     // de / dk
        a3[j] = __fmul_rn(tc, go);         // de / dD_o
        kgf[j] = __fmul_rn(k[j], gf);
        kgi[j] = __fmul_rn(k[j], gi);
        zb0[j] = __fmul_rn(__fmul_rn(k[j], dtg), gi);
        zb2[j] = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, tg), k[j]), si);
        zb3[j] = __fmul_rn(__fmul_rn(e[j], dtc[j]), go);
        ego[j] = __fmul_rn(e[j], go);
        ces[j] = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, tc), e[j]), so);
        c_prev[j] = c[j];
      }
      // the chain: the step before's e_bar gathered from the row's lanes,
      // the whole cotangent on dz (delta, and through e_{p-1}), then kb, eb
      float eall[U];
#pragma unroll
      for (int m = 0; m < U; ++m)
        eall[m] = __shfl_sync(0xffffffffu, e_bar[m % UPL], m / UPL, LPR);
      float D[4][UPL];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < UPL; ++j) {
          if constexpr (NP == 1) {  // one chain from delta, m = 0 ... U-1
            D[g][j] = dl[g][j];
#pragma unroll
            for (int m = 0; m < U; ++m) D[g][j] = fmaf(eall[m], w[g][j][m], D[g][j]);
          } else {
            float part[NP];
#pragma unroll
            for (int m = 0; m < NP; ++m) part[m] = __fmul_rn(eall[m], w[g][j][m]);
#pragma unroll
            for (int m = NP; m < U; ++m) part[m % NP] = fmaf(eall[m], w[g][j][m], part[m % NP]);
            D[g][j] = __fadd_rn(dl[g][j], __fadd_rn(__fadd_rn(part[0], part[1]),
                                                    __fadd_rn(part[2], part[3])));
          }
        }
      float kb_new[UPL], zsb[4][UPL], cb_out[UPL];
#pragma unroll
      for (int j = 0; j < UPL; ++j) {
        kb_new[j] = fmaf(D[2][j], a2[j],
                         fmaf(D[1][j], a1[j], fmaf(D[0][j], a0[j], __fmul_rn(k_bar[j], sf[j]))));
        const float eb_new = fmaf(kb_new[j], ao[j], __fmul_rn(D[3][j], a3[j]));
        // off the chain again: the outputs
        zsb[0][j] = __fmul_rn(D[2][j], zb0[j]);
        zsb[1][j] = __fmul_rn(k_bar[j], kgf[j]);
        zsb[2][j] = __fsub_rn(__fmul_rn(D[0][j], kgi[j]), __fmul_rn(D[2][j], zb2[j]));
        zsb[3][j] = __fmul_rn(kb_new[j], zb3[j]);
        cb_out[j] = __fadd_rn(c_pend[j], __fmul_rn(D[1][j], kgf[j]));
        c_pend[j] = __fmul_rn(dtc[j], __fsub_rn(__fmul_rn(D[3][j], ego[j]),
                                                __fmul_rn(kb_new[j], ces[j])));
        e_bar[j] = eb_new;
        k_bar[j] = kb_new[j];
      }
      store_vec<UPL>(a.e_bar + ou, e_bar);
#pragma unroll
      for (int g = 0; g < 4; ++g) store_vec<UPL>(a.zs_bar + og + g * U, zsb[g]);
      if (p0 + i > 0) store_vec<UPL>(a.c_bar + ou_prev, cb_out);
      ou_prev = ou;
      ou += du;
      og += dg;
    }
    __syncwarp();  // every lane is done with buffer st before it is refilled
  }
  store_vec<UPL>(a.c_bar + ou_prev, c_pend);
}

template <int U, int LPR, bool FUSED>
int launch_fwd(const FwdArgs& a, int n_seq, cudaStream_t stream) {
  using L = Layout<U, LPR, FUSED>;
  auto kernel = a.zs ? lstm_scan_fwd<U, LPR, FUSED, true> : lstm_scan_fwd<U, LPR, FUSED, false>;
  if (L::FWD_SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::FWD_SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.rows + L::RPB - 1) / L::RPB, n_seq);
  kernel<<<grid, kWarp, L::FWD_SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int U, int LPR, bool COT, bool CARRY>
int launch_bwd(const BwdArgs& a, int n_seq, cudaStream_t stream) {
  using L = Layout<U, LPR, false>;
  constexpr int SMEM = COT ? L::COT_SMEM : L::BWD_SMEM;
  auto kernel = a.dh_seq ? lstm_scan_bwd<U, LPR, true, COT, CARRY>
                         : lstm_scan_bwd<U, LPR, false, COT, CARRY>;
  if (SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.rows + L::RPB - 1) / L::RPB, n_seq);
  kernel<<<grid, kWarp, SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// the backward's variant for its optional inputs and outputs
template <int U, int LPR>
int launch_bwd_any(const BwdArgs& a, int n_seq, cudaStream_t st) {
  if (a.dzs || a.dcs)
    return a.e_seq ? launch_bwd<U, LPR, true, true>(a, n_seq, st)
                   : launch_bwd<U, LPR, true, false>(a, n_seq, st);
  return a.e_seq ? launch_bwd<U, LPR, false, true>(a, n_seq, st)
                 : launch_bwd<U, LPR, false, false>(a, n_seq, st);
}

template <int U, int LPR>
int launch_adj(const AdjArgs& a, int n_seq, cudaStream_t stream) {
  using L = Layout<U, LPR, false>;
  auto kernel = lstm_scan_adj<U, LPR>;
  if (L::ADJ_SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::ADJ_SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.rows + L::RPB - 1) / L::RPB, n_seq);
  kernel<<<grid, kWarp, L::ADJ_SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int dispatch_fwd(const FwdArgs& a, int n_seq, int units, int lanes, cudaStream_t st) {
  switch (units * 100 + lanes) {
    case 402: return launch_fwd<4, 2, FUSED>(a, n_seq, st);
    case 404: return launch_fwd<4, 4, FUSED>(a, n_seq, st);
    case 1616: return launch_fwd<16, 16, FUSED>(a, n_seq, st);
    default: return -1;
  }
}

int dispatch_bwd(const BwdArgs& a, int n_seq, int units, int lanes, cudaStream_t st) {
  switch (units * 100 + lanes) {
    case 402: return launch_bwd_any<4, 2>(a, n_seq, st);
    case 404: return launch_bwd_any<4, 4>(a, n_seq, st);
    case 1616: return launch_bwd_any<16, 16>(a, n_seq, st);
    default: return -1;
  }
}

int dispatch_adj(const AdjArgs& a, int n_seq, int units, int lanes, cudaStream_t st) {
  switch (units * 100 + lanes) {
    case 402: return launch_adj<4, 2>(a, n_seq, st);
    case 404: return launch_adj<4, 4>(a, n_seq, st);
    case 1616: return launch_adj<16, 16>(a, n_seq, st);
    default: return -1;
  }
}

}  // namespace

// The forward. The input is x, wx and b (in = 1: the projection is fused)
// or, with x null, xw. zs and c_seq are both given (then so is h_seq) or
// both null, and then h_seq may be null too; h_last is always written.
// Returns a cudaError_t, or -1 for a (units, lanes a row) pair the kernels
// are not compiled for: (4, 2), (4, 4), (16, 16) (the variant zoo's U are
// 4, the iwganlstm critic, and 16, the lstm classifier). So do the others.
extern "C" int mrgan_lstm_scan_fwd(const float* x, const float* wx, const float* b,
                                   const float* xw, const float* wh, int n_seq,
                                   int steps, int rows, int units, int lanes, int dirs,
                                   int reverse, float* h_seq, float* h_last, float* zs,
                                   float* c_seq, void* stream) {
  const FwdArgs a{x, wx, b, xw, wh, steps, rows, dirs, reverse, h_seq, h_last, zs, c_seq};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x ? dispatch_fwd<true>(a, n_seq, units, lanes, st)
           : dispatch_fwd<false>(a, n_seq, units, lanes, st);
}

// The backward: dh_seq or dh_last may be null (no gradient there).
extern "C" int mrgan_lstm_scan_bwd(const float* dh_seq, const float* dh_last,
                                   const float* zs, const float* c_seq, const float* wh,
                                   int n_seq, int steps, int rows, int units, int lanes,
                                   int dirs, int reverse, float* dz, void* stream) {
  const BwdArgs a{dh_seq, dh_last, zs, c_seq, wh, nullptr, nullptr, steps, rows,
                  dirs, reverse, dz, nullptr, nullptr};
  return dispatch_bwd(a, n_seq, units, lanes, static_cast<cudaStream_t>(stream));
}

// The backward with per-step cotangents on the saved gates (dzs) and cells
// (dcs), either or both null, and, with e_seq and k_seq given (both or
// neither), its carries stored.
extern "C" int mrgan_lstm_scan_bwd_ext(const float* dh_seq, const float* dh_last,
                                       const float* zs, const float* c_seq,
                                       const float* wh, const float* dzs,
                                       const float* dcs, int n_seq, int steps,
                                       int rows, int units, int lanes, int dirs,
                                       int reverse, float* dz, float* e_seq,
                                       float* k_seq, void* stream) {
  const BwdArgs a{dh_seq, dh_last, zs, c_seq, wh, dzs, dcs, steps, rows,
                  dirs, reverse, dz, e_seq, k_seq};
  return dispatch_bwd(a, n_seq, units, lanes, static_cast<cudaStream_t>(stream));
}

// The forward-time adjoint of the backward, from a cotangent on dz and the
// backward's carries.
extern "C" int mrgan_lstm_scan_adj(const float* delta, const float* zs,
                                   const float* c_seq, const float* e_seq,
                                   const float* k_seq, const float* wh, int n_seq,
                                   int steps, int rows, int units, int lanes, int dirs,
                                   int reverse, float* e_bar, float* zs_bar,
                                   float* c_bar, void* stream) {
  const AdjArgs a{delta, zs, c_seq, e_seq, k_seq, wh, steps, rows, dirs, reverse,
                  e_bar, zs_bar, c_bar};
  return dispatch_adj(a, n_seq, units, lanes, static_cast<cudaStream_t>(stream));
}
