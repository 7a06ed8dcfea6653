// Fused DFT -> power -> mel projection for Hopper (sm_90a), 3xTF32 on the
// tensor cores.
//
// Replaces mrgan_tpu/ops/mel_pallas.py::_mel_kernel at Precision.HIGHEST. For
// every STFT frame f:
//
//     re[k]  = sum_n x_f[n] * Cw[n, k]        (window-premultiplied cosines)
//     im[k]  = sum_n x_f[n] * Sw[n, k]        (window-premultiplied sines)
//     out[m] = sum_k (re[k]^2 + im[k]^2) * melW[k, m]
//
// with n < n_fft = 2048, k < n_bins = 1025, m < 128. The log-dB, ref-max and
// top_db steps stay outside the kernel (torch elementwise ops), as on the TPU.
//
// What bounds it on the H100: the DFT is 2 * 2 * 2048 * 1025 ~ 8.4 MFLOP per
// frame (the mel projection ~1/2000 of that). fp32 FMA on the CUDA cores tops
// out at 67 TFLOP/s; TF32 on the tensor cores at 495. TF32 keeps 10 mantissa
// bits, so fp32 accuracy (the counterpart of the TPU's multi-pass HIGHEST)
// takes three products of split operands, x = hi + lo with hi and lo both
// TF32: x*y ~ hi_x*hi_y + hi_x*lo_y + lo_x*hi_y, dropping lo*lo (2^-22
// relative). That is 3x the tensor-core work, still ~2.5x the CUDA cores'
// fp32 peak. Every frame tile reads the whole fp32 basis (2 x 2048 x 1088 x
// 4 B = 17.8 MB, L2-resident) and every bin tile its frames, so at large F
// the L2 -> SM traffic binds as much as the tensor cores; at serving sizes
// (F = 19 .. 1,368 frames) the question is how many SMs get work at all.
//
// Design:
// - The basis is constant and laid out on the host (ops/mel_cuda.py,
//   kernel_basis): (2 * n_bins_padded, n_fft), K-major (bins x samples), cos
//   and sin interleaved per bin (row 2k = cos of bin k, row 2k+1 = its sine),
//   zero past the last bin. So one 8-column MMA tile holds 4 bins' (cos, sin)
//   pairs, and the accumulator fragment gives each thread re and im of the
//   same bin and frame side by side: the power epilogue needs no exchange.
//   It stays fp32 in memory (half the bytes of a split copy) and is split as
//   it is used, with cvt.rna.tf32.f32 of x and of x - hi, as are the frames.
// - Three products into one fp32 accumulator per fragment, issued pass by
//   pass (lo*hi, hi*lo, hi*hi) so consecutive products go to different
//   accumulators. The large tile (128 frames x 64 bins) issues
//   wgmma.m64n128k8.tf32 from two warpgroups: frames from registers, the
//   split basis slice K-major in shared memory as unswizzled core matrices
//   (8 rows x 16 B) behind descriptors; one slice's products stay in flight
//   while the next slice is split and its frame fragments built. The small
//   tiles (16 x 8 and 32 x 16 for a few poke windows) use
//   mma.sync.m16n8k8.tf32 with the samples split across the 8 warps (their
//   re/im sums are added in warp order before squaring): there latency and
//   L2 traffic, not the tensor cores, set the pace.
// - Each frame is taken less a per-row constant c (the row's mean, from the
//   wrapper) and c * (the basis row's float64 sum) is added back: exact
//   algebra that keeps a DC offset (the contact mic's 2048 ADC counts) out
//   of the products, whose tensor-core sums would otherwise lose the weak
//   bins to it.
// - Shared memory is fed by cp.async (16-byte copies where the frame rows
//   are 16-byte aligned, 4-byte ones otherwise; rows past the last frame are
//   zero-filled) in a ring of STAGES slices of BK samples. Frames are read in
//   place from the reflect-padded audio: frame t of row b starts at b * ld +
//   t * hop; the (F, 2048) frames tensor is never built (ld = hop = n_fft,
//   one frame per row, reads a plain frames matrix).
// - The grid is frame tiles x bin groups. A block owns BM frames and a group
//   of consecutive BN-bin tiles; the wrapper picks the tile and the group
//   count from F and the SM count (ops/mel_cuda.py, _layout), so a 1-poke
//   request (19 frames) runs on 258 blocks, not 2.
// - Between bin tiles the drained ring holds the tile's re/im sums and
//   power, so the large tile needs 72.5 KB and two blocks share an SM.
// - The TPU summed over bin blocks in one revisited output tile because its
//   grid runs in order. Here a block sums its group's bins into mel sums held
//   in its own rows of the output (one group) or of a partials buffer
//   (several groups, only the bands its bins touch): each band over its
//   nonzero bins only, in increasing bin order, fp32 FMA on the CUDA cores
//   (bin k feeds at most two adjacent bands). No other block touches those
//   rows. mel_group_sum then adds the groups of each band in group order. No
//   atomics: the output is bitwise the same from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int N_MELS = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FFT_STEP = 64;  // n_fft must be a multiple of every tile's BK

// WARPS_M x WARPS_N x WARPS_K warps; each warp holds WM x WN MMA tiles of
// 16 frames x 8 basis rows (4 bins). With WGMMA the 8 warps are two
// warpgroups of 64 frames that each issue wgmma over all BC basis rows; the
// accumulator fragments are laid out as mma.sync's (WARPS_M = 8, WM = 1).
template <int WARPS_M_, int WARPS_N_, int WM_, int WN_, int BK_, int STAGES_, int MIN_BLOCKS_,
          bool WGMMA_ = false>
struct Tile {
  static constexpr bool WGMMA = WGMMA_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int WARPS_K = WARPS / (WARPS_M * WARPS_N);
  static constexpr int WM = WM_, WN = WN_, BK = BK_, STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;  // blocks per SM the registers must allow
  static constexpr int BM = WARPS_M * WM * 16;  // frames per block
  static constexpr int BC = WARPS_N * WN * 8;   // basis rows per bin tile
  static constexpr int BN = BC / 2;             // bins per tile
  static constexpr int KS = BK / (8 * WARPS_K); // k8 steps per warp per slice
  static constexpr int LDS = BK + 4;            // smem row stride: conflict-free fragments
  static constexpr int A_FLOATS = BM * LDS;     // frames slice [BM][LDS]
  // fp32 basis slice: [BC][LDS] for mma.sync's fragment loads; for wgmma
  // K-major core matrices (8 rows x 4 samples, 128 B) [BK / 4][BC / 8][8][4],
  // split in place into their TF32 heads, the residuals going to LO
  static constexpr int B_FLOATS = BC * (WGMMA ? BK : LDS);
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int LO_FLOATS = WGMMA ? 2 * BC * BK : 0;  // residuals of two slices in turn
  static constexpr int PW_LD = BN + 1;          // power tile [BM][PW_LD]
  static constexpr int RED_FLOATS = WARPS_K > 1 ? WARPS_K * BM * BC : 0;
  static_assert(WARPS_K * WARPS_M * WARPS_N == WARPS, "warp layout");
  static_assert(KS >= 1 && FFT_STEP % BK == 0, "slice depth");
  // between bin tiles the drained ring holds the re/im sums, then the power
  static_assert(RED_FLOATS + BM * PW_LD <= STAGES * STAGE_FLOATS, "epilogue fits the ring");
  // shared memory: row bases (long long), band ranges (int), row centers
  // (float), the ring, the residuals
  static constexpr size_t HEAD =
      (BM * sizeof(long long) + 2 * N_MELS * sizeof(int) + BM * sizeof(float) + 127) / 128 * 128;
  static constexpr size_t BYTES = HEAD + (STAGES * STAGE_FLOATS + LO_FLOATS) * sizeof(float);
  static_assert(HEAD % 128 == 0 && A_FLOATS % 32 == 0 && B_FLOATS % 32 == 0,
                "ring slots start 128-byte aligned");
  static_assert(!WGMMA || (WARPS_M == 8 && WM == 1 && WARPS_N == 1 && BC == 128 && STAGES >= 3),
                "wgmma tile: two warpgroups x 64 frames, n = 128");
  // where sample c (a multiple of 4) of basis row r goes in a slice
  static __device__ __forceinline__ int b_offset(int r, int c) {
    return WGMMA ? ((c / 4 * (BC / 8) + r / 8) * 8 + r % 8) * 4 : r * LDS + c;
  }
};

// The tiles the wrapper can pick (index = ops/mel_cuda.py TILES position).
// The small tiles' register caps (3 and 2 blocks per SM) keep a 258-block
// launch in one wave.
using TileS = Tile<1, 1, 1, 2, 64, 4, 3>;  //  16 frames x  8 bins, mma.sync, 8-way sample split
using TileM = Tile<1, 1, 2, 4, 64, 3, 2>;  //  32 frames x 16 bins, mma.sync, 8-way sample split
using TileL = Tile<8, 1, 1, 16, 16, 3, 2, true>;  // 128 frames x 64 bins, wgmma, 2 blocks per SM

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a * b for one 16 x 8 x 8 TF32 tile. Not volatile: the compiler may
// interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b over 64 frames x 128 basis rows x 8 samples for the warpgroup:
// a in registers (this warp's 16 x 8 slice, mma.sync's fragment), b K-major
// in shared memory behind `desc`.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
      "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
      "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
      "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
      "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Shared memory descriptor of a K-major, unswizzled operand: core matrices
// of 8 rows x 16 B, `lbo` bytes apart along K, `sbo` bytes apart along N.
__device__ __forceinline__ uint64_t wgmma_desc(const float* p, int lbo, int sbo) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

// Queue the copies of the BK-deep slice at sample n0 of the frames (rows
// from row_base, < 0 past the last frame) and of the basis rows c0 ..
// c0 + BC into ring slot `st`.
template <typename T>
__device__ __forceinline__ void load_slice(float* st, const float* __restrict__ src,
                                           const long long* row_base, bool vec,
                                           const float* __restrict__ basis, int n_fft,
                                           long long c0, int n0, int tid) {
  float* As = st;
  float* Bs = st + T::A_FLOATS;
  if (vec) {
#pragma unroll
    for (int i = tid; i < T::BM * T::BK / 4; i += THREADS) {
      const int r = i / (T::BK / 4), c = (i % (T::BK / 4)) * 4;
      const long long base = row_base[r];
      cp_async16(As + r * T::LDS + c, src + (base < 0 ? 0 : base + n0 + c), base >= 0);
    }
  } else {
#pragma unroll
    for (int i = tid; i < T::BM * T::BK; i += THREADS) {
      const int r = i / T::BK, c = i % T::BK;
      const long long base = row_base[r];
      cp_async4(As + r * T::LDS + c, src + (base < 0 ? 0 : base + n0 + c), base >= 0);
    }
  }
#pragma unroll
  for (int i = tid; i < T::BC * T::BK / 4; i += THREADS) {
    const int r = i / (T::BK / 4), c = (i % (T::BK / 4)) * 4;
    cp_async16(Bs + T::b_offset(r, c), basis + static_cast<size_t>(c0 + r) * n_fft + n0 + c,
               true);
  }
}

// This warp's fragment of frames r0 .. r0 + 15 x samples kb .. kb + 7, each
// less its row's center, split into TF32 heads and residuals.
template <typename T>
__device__ __forceinline__ void frame_fragment(const float* As, const float* center_s, int r0,
                                               int kb, int g, int t, uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
  const float* a = As + (r0 + g) * T::LDS + kb + t;
  const float c0 = center_s[r0 + g], c1 = center_s[r0 + g + 8];
  const float x[4] = {a[0] - c0, a[8 * T::LDS] - c1, a[4] - c0, a[8 * T::LDS + 4] - c1};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    hi[q] = to_tf32(x[q]);
    lo[q] = to_tf32(x[q] - __uint_as_float(hi[q]));
  }
}

// The products of one bin tile over all samples with mma.sync.
template <typename T>
__device__ __forceinline__ void mma_slices(float (&acc)[T::WM][T::WN][4], float* ring,
                                           const float* __restrict__ src,
                                           const long long* row_base, const float* center_s,
                                           bool vec, const float* __restrict__ basis,
                                           int n_fft, long long c0, int tid) {
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int wk = warp % T::WARPS_K;
  const int wm = (warp / T::WARPS_K) % T::WARPS_M;
  const int wn = warp / (T::WARPS_K * T::WARPS_M);
  const int n_slices = n_fft / T::BK;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < n_slices)
      load_slice<T>(ring + s * T::STAGE_FLOATS, src, row_base, vec, basis, n_fft, c0,
                    s * T::BK, tid);
    cp_async_commit();
  }
  for (int it = 0; it < n_slices; ++it) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // slice `it` landed; slot (it - 1) % STAGES is free
    const int nxt = it + T::STAGES - 1;
    if (nxt < n_slices)
      load_slice<T>(ring + (nxt % T::STAGES) * T::STAGE_FLOATS, src, row_base, vec, basis,
                    n_fft, c0, nxt * T::BK, tid);
    cp_async_commit();

    const float* As = ring + (it % T::STAGES) * T::STAGE_FLOATS;
    const float* Bs = As + T::A_FLOATS;
#pragma unroll
    for (int j = 0; j < T::KS; ++j) {
      const int kb = (wk * T::KS + j) * 8;
      uint32_t ahi[T::WM][4], alo[T::WM][4];
#pragma unroll
      for (int i = 0; i < T::WM; ++i)
        frame_fragment<T>(As, center_s, (wm * T::WM + i) * 16, kb, g, t, ahi[i], alo[i]);
      uint32_t bh[T::WN][2], bl[T::WN][2];
#pragma unroll
      for (int n = 0; n < T::WN; ++n) {
        const float* b = Bs + ((wn * T::WN + n) * 8 + g) * T::LDS + kb + t;
        const float y[2] = {b[0], b[4]};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          bh[n][q] = to_tf32(y[q]);
          bl[n][q] = to_tf32(y[q] - __uint_as_float(bh[n][q]));
        }
      }
#pragma unroll
      for (int n = 0; n < T::WN; ++n)
#pragma unroll
        for (int i = 0; i < T::WM; ++i) mma_tf32(acc[i][n], alo[i], bh[n]);
#pragma unroll
      for (int n = 0; n < T::WN; ++n)
#pragma unroll
        for (int i = 0; i < T::WM; ++i) mma_tf32(acc[i][n], ahi[i], bl[n]);
#pragma unroll
      for (int n = 0; n < T::WN; ++n)
#pragma unroll
        for (int i = 0; i < T::WM; ++i) mma_tf32(acc[i][n], ahi[i], bh[n]);
    }
  }
}

// The products of one bin tile over all samples with wgmma. Slice `it` sits
// in ring slot it % STAGES; its wgmma group reads the split heads there and
// the residuals in lo_buf[it % 2], plus this thread's frame fragments of
// parity it % 2, and completes during the next slice. So a slot, a residual
// buffer and a fragment set are reused two slices later.
template <typename T>
__device__ __forceinline__ void wgmma_slices(float (&acc)[16][4], float* ring, float* lo_buf,
                                             const float* __restrict__ src,
                                             const long long* row_base, const float* center_s,
                                             bool vec, const float* __restrict__ basis,
                                             int n_fft, long long c0, int tid) {
  constexpr int AHEAD = T::STAGES - 2;  // slices in flight past the one in use
  constexpr int SLICE = T::BC * T::BK;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int n_slices = n_fft / T::BK;
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < n_slices)
      load_slice<T>(ring + s * T::STAGE_FLOATS, src, row_base, vec, basis, n_fft, c0,
                    s * T::BK, tid);
    cp_async_commit();
  }
  uint32_t ahi[2][T::KS][4], alo[2][T::KS][4];
  auto step = [&](int it, auto parity) {
    constexpr int P = decltype(parity)::value;
    cp_async_wait<AHEAD - 1>();
    // slice `it` landed everywhere, and slice it - 2's products are complete
    // in both warpgroups: its slot is refilled, its residual buffer and
    // fragment set rewritten
    __syncthreads();
    const int nxt = it + AHEAD;
    if (nxt < n_slices)
      load_slice<T>(ring + (nxt % T::STAGES) * T::STAGE_FLOATS, src, row_base, vec, basis,
                    n_fft, c0, nxt * T::BK, tid);
    cp_async_commit();

    float* As = ring + (it % T::STAGES) * T::STAGE_FLOATS;
    float* Bh = As + T::A_FLOATS;
    float* Bl = lo_buf + P * SLICE;
#pragma unroll
    for (int i = tid; i < SLICE / 4; i += THREADS) {  // split the basis slice in place
      const float4 x = reinterpret_cast<const float4*>(Bh)[i];
      const float xs[4] = {x.x, x.y, x.z, x.w};
      float h[4], l[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        h[q] = __uint_as_float(to_tf32(xs[q]));
        l[q] = __uint_as_float(to_tf32(xs[q] - h[q]));
      }
      reinterpret_cast<float4*>(Bh)[i] = make_float4(h[0], h[1], h[2], h[3]);
      reinterpret_cast<float4*>(Bl)[i] = make_float4(l[0], l[1], l[2], l[3]);
    }
#pragma unroll
    for (int j = 0; j < T::KS; ++j)
      frame_fragment<T>(As, center_s, warp * 16, j * 8, g, t, ahi[P][j], alo[P][j]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
    __syncthreads();

    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < T::KS; ++j) {
      // samples 8j .. 8j + 7: two core-matrix columns, BC * 16 B apart
      constexpr int LBO = T::BC * 16, SBO = 128;
      const uint64_t dh = wgmma_desc(Bh + j * 2 * T::BC * 4, LBO, SBO);
      const uint64_t dl = wgmma_desc(Bl + j * 2 * T::BC * 4, LBO, SBO);
      wgmma_tf32_n128(acc, alo[P][j], dh);
      wgmma_tf32_n128(acc, ahi[P][j], dl);
      wgmma_tf32_n128(acc, ahi[P][j], dh);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  };
  for (int it = 0; it < n_slices; it += 2) {
    step(it, std::integral_constant<int, 0>());
    if (it + 1 < n_slices) step(it + 1, std::integral_constant<int, 1>());
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(THREADS, T::MIN_BLOCKS)
mel_power_kernel(const float* __restrict__ src, long long ld, int frames_per_row, int hop,
                 long long total_frames, bool vec, const float* __restrict__ center,
                 const float* __restrict__ basis, const float* __restrict__ basis_sum,
                 const float* __restrict__ melw,
                 const int* __restrict__ band_lo, const int* __restrict__ band_hi,
                 int n_fft, int n_bins, int tiles_per_group, int groups,
                 float* __restrict__ partials, float* __restrict__ out) {
  constexpr int BM = T::BM, BN = T::BN, BC = T::BC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  long long* row_base = reinterpret_cast<long long*>(smem_raw);
  int* blo_s = reinterpret_cast<int*>(row_base + BM);
  int* bhi_s = blo_s + N_MELS;
  float* center_s = reinterpret_cast<float*>(bhi_s + N_MELS);  // per frame row
  float* ring = reinterpret_cast<float*>(smem_raw + T::HEAD);
  float* red = ring;                     // [WARPS_K][BM][BC] re/im sums, between tiles
  float* Pw = ring + T::RED_FLOATS;      // [BM][PW_LD] power, between tiles

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // MMA fragment row group, column
  const int wk = warp % T::WARPS_K;
  const int wm = (warp / T::WARPS_K) % T::WARPS_M;
  const int wn = warp / (T::WARPS_K * T::WARPS_M);
  const long long f0 = static_cast<long long>(blockIdx.x) * BM;
  const int grp = blockIdx.y;
  const int n_tiles = (n_bins + BN - 1) / BN;
  const int tile_lo = grp * tiles_per_group;
  const int tile_hi = min(tile_lo + tiles_per_group, n_tiles);
  const int bin_lo = tile_lo * BN, bin_hi = min(tile_hi * BN, n_bins);
  // The block's mel sums live in its own rows of dst: with one group the
  // output, else this group's slice of the partials, holding the bands its
  // bins touch. No other block writes them.
  float* dst = groups == 1 ? out : partials + static_cast<size_t>(grp) * total_frames * N_MELS;

  for (int r = tid; r < BM; r += THREADS) {
    const long long f = f0 + r;
    long long base = -1;  // rows past the last frame read zeros
    float c = 0.f;
    if (f < total_frames) {
      const long long b = f / frames_per_row;
      base = b * ld + (f - b * frames_per_row) * hop;
      c = center[b];
    }
    row_base[r] = base;
    center_s[r] = c;
  }
  for (int m = tid; m < N_MELS; m += THREADS) {
    blo_s[m] = band_lo[m];
    bhi_s[m] = band_hi[m];
  }
  for (int idx = tid; idx < BM * N_MELS; idx += THREADS) {
    const int m = idx % N_MELS;
    const long long f = f0 + idx / N_MELS;
    if (f < total_frames && (groups == 1 || (band_lo[m] < bin_hi && band_hi[m] > bin_lo)))
      dst[f * N_MELS + m] = 0.f;
  }
  __syncthreads();

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int k0 = tile * BN;
    const long long c0 = 2LL * k0;
    float acc[T::WM][T::WN][4];
#pragma unroll
    for (int i = 0; i < T::WM; ++i)
#pragma unroll
      for (int j = 0; j < T::WN; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    if constexpr (T::WGMMA)
      wgmma_slices<T>(acc[0], ring, ring + T::STAGES * T::STAGE_FLOATS, src, row_base,
                      center_s, vec, basis, n_fft, c0, tid);
    else
      mma_slices<T>(acc, ring, src, row_base, center_s, vec, basis, n_fft, c0, tid);
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring

    // power of the tile into Pw: fragment (row g, cols 2t, 2t+1) is (re, im)
    // of bin 4 * ntile + t
    if constexpr (T::WARPS_K == 1) {
#pragma unroll
      for (int i = 0; i < T::WM; ++i)
#pragma unroll
        for (int n = 0; n < T::WN; ++n) {
          const int r = (wm * T::WM + i) * 16 + g;
          const int b = (wn * T::WN + n) * 4 + t;
          const float s_re = basis_sum[c0 + 2 * b], s_im = basis_sum[c0 + 2 * b + 1];
          const float c_lo = center_s[r], c_hi = center_s[r + 8];
          const float re0 = fmaf(c_lo, s_re, acc[i][n][0]), im0 = fmaf(c_lo, s_im, acc[i][n][1]);
          const float re1 = fmaf(c_hi, s_re, acc[i][n][2]), im1 = fmaf(c_hi, s_im, acc[i][n][3]);
          Pw[r * T::PW_LD + b] = re0 * re0 + im0 * im0;
          Pw[(r + 8) * T::PW_LD + b] = re1 * re1 + im1 * im1;
        }
    } else {
#pragma unroll
      for (int i = 0; i < T::WM; ++i)
#pragma unroll
        for (int n = 0; n < T::WN; ++n) {
          const int r = (wm * T::WM + i) * 16 + g;
          const int c = (wn * T::WN + n) * 8 + 2 * t;
          float* p = red + (wk * BM + r) * BC + c;
          p[0] = acc[i][n][0];
          p[1] = acc[i][n][1];
          p[8 * BC] = acc[i][n][2];
          p[8 * BC + 1] = acc[i][n][3];
        }
      __syncthreads();
      for (int idx = tid; idx < BM * BN; idx += THREADS) {
        const int r = idx / BN, b = idx % BN;
        float re = 0.f, im = 0.f;
#pragma unroll
        for (int w = 0; w < T::WARPS_K; ++w) {
          re += red[(w * BM + r) * BC + 2 * b];
          im += red[(w * BM + r) * BC + 2 * b + 1];
        }
        re = fmaf(center_s[r], basis_sum[c0 + 2 * b], re);
        im = fmaf(center_s[r], basis_sum[c0 + 2 * b + 1], im);
        Pw[r * T::PW_LD + b] = re * re + im * im;
      }
    }
    __syncthreads();

    // mel projection of the tile: (row, band) pairs over the bands it touches
    const int k1 = min(k0 + BN, n_bins);
    int m0 = N_MELS, m1 = 0;
    for (int m = 0; m < N_MELS; ++m)
      if (blo_s[m] < k1 && bhi_s[m] > k0) {
        m0 = min(m0, m);
        m1 = m + 1;
      }
    for (int idx = tid; idx < BM * max(m1 - m0, 0); idx += THREADS) {
      const int r = idx % BM, m = m0 + idx / BM;
      const long long f = f0 + r;
      if (f >= total_frames) continue;
      const int lo = max(blo_s[m], k0), hi = min(bhi_s[m], k1);
      float a = dst[f * N_MELS + m];
      for (int k = lo; k < hi; ++k)
        a = fmaf(Pw[r * T::PW_LD + k - k0], melw[static_cast<size_t>(k) * N_MELS + m], a);
      dst[f * N_MELS + m] = a;
    }
    __syncthreads();  // the ring and dst's sums are read again by the next tile
  }
}

// out[f, m] = the partials of band m's groups, added in group order. Group g
// holds bins [g * group_bins, (g + 1) * group_bins).
__global__ void __launch_bounds__(THREADS)
mel_group_sum(const float* __restrict__ partials, long long total_frames, int group_bins,
              const int* __restrict__ band_lo, const int* __restrict__ band_hi,
              float* __restrict__ out) {
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long n = total_frames * N_MELS;
  if (idx >= n) return;
  const int m = static_cast<int>(idx % N_MELS);
  const int lo = band_lo[m], hi = band_hi[m];
  float s = 0.f;
  if (lo < hi)
    for (int g = lo / group_bins; g <= (hi - 1) / group_bins; ++g)
      s += partials[static_cast<size_t>(g) * n + idx];
  out[idx] = s;
}

template <typename T>
int launch(const float* src, long long ld, int frames_per_row, int hop,
           long long total_frames, const float* center, const float* basis,
           const float* basis_sum, int basis_bins,
           const float* melw, const int* band_lo, const int* band_hi, int n_fft,
           int n_bins, int groups, float* partials, float* out, cudaStream_t stream) {
  const int n_tiles = (n_bins + T::BN - 1) / T::BN;
  const long long blocks = (total_frames + T::BM - 1) / T::BM;
  if (groups < 1 || groups > n_tiles || n_tiles * T::BN > basis_bins ||
      blocks > 0x7fffffffLL || (groups > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_group = (n_tiles + groups - 1) / groups;
  if ((n_tiles + per_group - 1) / per_group != groups)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = ld % 4 == 0 && hop % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      mel_power_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(groups));
  mel_power_kernel<T><<<grid, THREADS, T::BYTES, stream>>>(
      src, ld, frames_per_row, hop, total_frames, vec, center, basis, basis_sum, melw,
      band_lo, band_hi,
      n_fft, n_bins, per_group, groups, partials, out);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return static_cast<int>(err);
  const long long n = total_frames * N_MELS;
  mel_group_sum<<<static_cast<unsigned>((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      partials, total_frames, per_group * T::BN, band_lo, band_hi, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns cudaGetLastError() after
// the launches (0 on success), or cudaErrorInvalidValue for shapes or layouts
// the kernel does not take. src holds (rows, ld) floats; frame t of row b
// starts at b * ld + t * hop and spans n_fft samples; out is
// (total_frames, 128). center holds one constant per src row, taken off
// every frame of that row before the products and put back through
// basis_sum, the basis rows' sums (2 * basis_bins). basis is (2 * basis_bins,
// n_fft): row 2k holds bin k's window-premultiplied cosines, row 2k + 1 its
// sines (ops/mel_cuda.py, kernel_basis).
// tile picks the tile (0 = 16 x 8, 1 = 32 x 16, 2 = 128 x 64 frames x bins);
// groups > 1 splits the bin tiles into that many groups, whose mel partials
// go through `partials` (groups, total_frames, 128) and mel_group_sum.
extern "C" int mrgan_mel_power(const float* src, long long ld, int frames_per_row, int hop,
                               long long total_frames, const float* center,
                               const float* basis, const float* basis_sum, int basis_bins,
                               const float* melw, const int* band_lo, const int* band_hi,
                               int n_fft, int n_bins, int n_mels, int tile, int groups,
                               float* partials, float* out, void* stream) {
  if (n_mels != N_MELS || n_fft % FFT_STEP != 0 || n_fft < FFT_STEP || n_bins < 1 ||
      total_frames < 1 || frames_per_row < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MEL_TILE(I, T)                                                                   \
  if (tile == I)                                                                         \
    return launch<T>(src, ld, frames_per_row, hop, total_frames, center, basis, basis_sum, \
                     basis_bins, melw, band_lo, band_hi, n_fft, n_bins, groups, partials,  \
                     out, s);
  MEL_TILE(0, TileS)
  MEL_TILE(1, TileM)
  MEL_TILE(2, TileL)
#undef MEL_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
