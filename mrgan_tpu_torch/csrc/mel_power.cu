// Fused DFT -> power -> mel projection for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces mrgan_tpu/ops/mel_pallas.py::_mel_kernel. For every STFT frame f:
//
//     re[k]  = sum_n x_f[n] * Cw[n, k]        (window-premultiplied cosines)
//     im[k]  = sum_n x_f[n] * Sw[n, k]        (window-premultiplied sines)
//     out[m] = sum_k (re[k]^2 + im[k]^2) * melW[k, m]
//
// with n < n_fft = 2048, k < n_bins = 1025, m < 128. The log-dB, ref-max and
// top_db steps stay outside the kernel (torch elementwise ops), as on the TPU.
//
// What bounds it: 2 * 2 * 2048 * 1025 ~ 8.4 MFLOP per frame, ~404 GFLOP at
// F = 48,128 frames; at the H100's published 67 TFLOP/s in fp32 outside the
// tensor cores that is >= 6 ms. The bases (2 x 2048 x 1025 x 4 B = 16.8 MB)
// stay in the 50 MB L2, so the kernel is bound by compute on the CUDA cores.
//
// Design, written from what the TPU kernel computes rather than block by block:
// - A block owns BM frames and loops over all 1,025 bins itself, in tiles of
//   BN bins. The TPU carried the sum over bin blocks in one revisited
//   output tile because its grid runs in order; here the mel sums live in the
//   block's shared memory, so no block depends on another, there are no
//   atomics, and each mel value is summed over bins in increasing order: the
//   result is deterministic.
// - The TPU padded 1,025 bins to 1,280 for its lanes; here the ragged last
//   bin tile is masked instead.
// - Accumulation is fp32 FMA on the CUDA cores, the parity counterpart of
//   Precision.HIGHEST. wgmma, TMA and a 3xTF32 split are later work.
// - Frames are read straight from the reflect-padded audio: frame t of
//   example b starts at b * ld + t * hop. The (F, 2048) frames tensor, four
//   times the audio's bytes at hop 512, is never built. With ld = n_fft,
//   hop = n_fft and one frame per example the same kernel reads a plain
//   (F, n_fft) frames matrix.
// - 256 threads, TY along frames x TX = 256 / TY along bins; each holds a
//   TM x 4 tile of (re, im) sums in registers, so BM = TY * TM frames and
//   BN = 4 * TX bins. The next 16-deep slice of frames and bases is fetched
//   into registers while the current one is multiplied out of shared memory.
//   Each basis value read from shared memory feeds TM frames in a thread;
//   TM = 4 in both layouts, because at TM = 1 shared-memory wavefronts, not
//   FMAs, bound the block.
// - melW is sparse: bin k feeds at most two adjacent bands. Each band m is
//   summed only over its nonzero bins [band_lo[m], band_hi[m]), which equals
//   the dense power @ melW up to the order of the sum.
// - (TY, TM) is chosen by the caller from the instantiated layouts: 16 x 4
//   (64 frames, 64-bin tiles) for large batches; 4 x 4 (16 frames, 256-bin
//   tiles, the last one mostly masked) spreads a small batch over more SMs
//   and still reuses each basis value for 4 frames.

#include <cuda_runtime.h>

namespace {

constexpr int N_MELS = 128;
constexpr int THREADS = 256;
constexpr int TN = 4;           // bins per thread
constexpr int BK = 16;          // samples per step of the DFT sum
static_assert(THREADS == 2 * N_MELS, "mel stage maps two threads per band");

template <int TY, int TM>
struct Tile {
  static constexpr int TX = THREADS / TY;   // threads along bins
  static constexpr int BM = TY * TM;        // frames per block
  static constexpr int BN = TX * TN;        // bins per tile
  static constexpr int AS_LD = BM + 1;      // frames tile row, transposed [BK][BM]
  static constexpr int PW_LD = BN + 1;      // power tile row [BM][BN]
  static constexpr int A_LOADS = BM * BK / THREADS;
  static constexpr int B_LOADS = BK * BN / THREADS;
  static_assert(TX * TY == THREADS && BM * BK % THREADS == 0, "tile loads");
  // shared memory layout: row bases (long long), then floats
  static constexpr size_t ROWS = BM * sizeof(long long);
  static constexpr size_t FLOATS = BK * AS_LD + 2 * BK * BN + BM * PW_LD + BM * N_MELS;
  static constexpr size_t BYTES = ROWS + FLOATS * sizeof(float);
};

// Registers <- the BK-deep slice at sample n0: this thread's A_LOADS frame
// samples (row base < 0 marks a row past the last frame: zeros) and B_LOADS
// (cos, sin) pairs of the bin tile at k0, zero past the last bin.
template <typename T>
__device__ __forceinline__ void fetch_slice(
    const float* __restrict__ src, const long long* row_base,
    const float* __restrict__ cw, const float* __restrict__ sw, int n0, int k0,
    int n_bins, int tid, float (&a_reg)[T::A_LOADS], float (&c_reg)[T::B_LOADS],
    float (&s_reg)[T::B_LOADS]) {
#pragma unroll
  for (int j = 0; j < T::A_LOADS; ++j) {
    const int idx = tid + j * THREADS;
    const long long base = row_base[idx / BK];
    a_reg[j] = base < 0 ? 0.f : src[base + n0 + idx % BK];
  }
#pragma unroll
  for (int j = 0; j < T::B_LOADS; ++j) {
    const int idx = tid + j * THREADS;
    const int k = k0 + idx % T::BN;
    const size_t g = static_cast<size_t>(n0 + idx / T::BN) * n_bins + k;
    c_reg[j] = k < n_bins ? cw[g] : 0.f;
    s_reg[j] = k < n_bins ? sw[g] : 0.f;
  }
}

template <int TY, int TM>
__global__ void __launch_bounds__(THREADS)
mel_power_kernel(const float* __restrict__ src, long long ld, int frames_per_row,
                 int hop, long long total_frames,
                 const float* __restrict__ cw, const float* __restrict__ sw,
                 const float* __restrict__ melw,
                 const int* __restrict__ band_lo, const int* __restrict__ band_hi,
                 int n_fft, int n_bins, float* __restrict__ out) {
  using T = Tile<TY, TM>;
  constexpr int BM = T::BM, BN = T::BN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* row_base = reinterpret_cast<long long*>(smem_raw);
  float* As = reinterpret_cast<float*>(smem_raw + T::ROWS);  // [BK][AS_LD]
  float* Bc = As + BK * T::AS_LD;                             // [BK][BN]
  float* Bs = Bc + BK * BN;                                   // [BK][BN]
  float* Pw = Bs + BK * BN;                                   // [BM][PW_LD]
  float* Acc = Pw + BM * T::PW_LD;                            // [BM][N_MELS]

  const int tid = threadIdx.x;
  const int tx = tid % T::TX;
  const int ty = tid / T::TX;
  const long long f0 = static_cast<long long>(blockIdx.x) * BM;

  for (int r = tid; r < BM; r += THREADS) {
    const long long f = f0 + r;
    long long base = -1;  // rows past the last frame read zeros
    if (f < total_frames) {
      const long long b = f / frames_per_row;
      base = b * ld + (f - b * frames_per_row) * hop;
    }
    row_base[r] = base;
  }
  for (int i = tid; i < BM * N_MELS; i += THREADS) Acc[i] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < n_bins; k0 += BN) {
    float acc_re[TM][TN], acc_im[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc_re[i][j] = acc_im[i][j] = 0.f;

    float a_reg[T::A_LOADS], c_reg[T::B_LOADS], s_reg[T::B_LOADS];
    fetch_slice<T>(src, row_base, cw, sw, 0, k0, n_bins, tid, a_reg, c_reg, s_reg);
    for (int n0 = 0; n0 < n_fft; n0 += BK) {
#pragma unroll
      for (int j = 0; j < T::A_LOADS; ++j) {
        const int idx = tid + j * THREADS;
        As[(idx % BK) * T::AS_LD + idx / BK] = a_reg[j];
      }
#pragma unroll
      for (int j = 0; j < T::B_LOADS; ++j) {
        Bc[tid + j * THREADS] = c_reg[j];
        Bs[tid + j * THREADS] = s_reg[j];
      }
      __syncthreads();
      if (n0 + BK < n_fft)  // in flight during the products below
        fetch_slice<T>(src, row_base, cw, sw, n0 + BK, k0, n_bins, tid, a_reg,
                       c_reg, s_reg);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk * T::AS_LD + ty * TM + i];
        const float4 c4 = *reinterpret_cast<const float4*>(&Bc[kk * BN + tx * TN]);
        const float4 s4 = *reinterpret_cast<const float4*>(&Bs[kk * BN + tx * TN]);
        const float c[TN] = {c4.x, c4.y, c4.z, c4.w};
        const float s[TN] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc_re[i][j] = fmaf(a[i], c[j], acc_re[i][j]);
            acc_im[i][j] = fmaf(a[i], s[j], acc_im[i][j]);
          }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        Pw[(ty * TM + i) * T::PW_LD + tx * TN + j] =
            acc_re[i][j] * acc_re[i][j] + acc_im[i][j] * acc_im[i][j];
    __syncthreads();

    // mel projection of this bin tile: thread (half, m) owns rows half, half+2, ...
    {
      const int m = tid % N_MELS;
      const int half = tid / N_MELS;
      const int lo = max(band_lo[m], k0);
      const int hi = min(band_hi[m], k0 + BN);
      for (int k = lo; k < hi; ++k) {
        const float w = melw[static_cast<size_t>(k) * N_MELS + m];
        const float* p = Pw + (k - k0);
        for (int r = half; r < BM; r += 2)
          Acc[r * N_MELS + m] = fmaf(p[r * T::PW_LD], w, Acc[r * N_MELS + m]);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < BM * N_MELS; i += THREADS) {
    const long long f = f0 + i / N_MELS;
    if (f < total_frames) out[f * N_MELS + i % N_MELS] = Acc[i];
  }
}

template <int TY, int TM>
int launch(const float* src, long long ld, int frames_per_row, int hop,
           long long total_frames, const float* cw, const float* sw,
           const float* melw, const int* band_lo, const int* band_hi,
           int n_fft, int n_bins, float* out, cudaStream_t stream) {
  using T = Tile<TY, TM>;
  cudaError_t err = cudaFuncSetAttribute(
      mel_power_kernel<TY, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (total_frames + T::BM - 1) / T::BM;
  mel_power_kernel<TY, TM><<<static_cast<unsigned>(blocks), THREADS, T::BYTES, stream>>>(
      src, ld, frames_per_row, hop, total_frames, cw, sw, melw, band_lo,
      band_hi, n_fft, n_bins, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for shapes or layouts
// the kernel does not take. src holds (rows, ld) floats; frame t of row b
// starts at b * ld + t * hop and spans n_fft samples; out is
// (total_frames, 128). (ty, tm) picks the thread layout.
extern "C" int mrgan_mel_power(const float* src, long long ld, int frames_per_row,
                               int hop, long long total_frames,
                               const float* cw, const float* sw, const float* melw,
                               const int* band_lo, const int* band_hi,
                               int n_fft, int n_bins, int n_mels, int ty, int tm,
                               float* out, void* stream) {
  if (n_mels != N_MELS || n_fft % BK != 0 || n_bins < 1 || total_frames < 1 ||
      frames_per_row < 1 || (total_frames + 15) / 16 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MEL_LAYOUT(TY_, TM_)                                                     \
  if (ty == TY_ && tm == TM_)                                                    \
    return launch<TY_, TM_>(src, ld, frames_per_row, hop, total_frames, cw, sw, \
                            melw, band_lo, band_hi, n_fft, n_bins, out, s);
  MEL_LAYOUT(4, 4)
  MEL_LAYOUT(16, 4)
#undef MEL_LAYOUT
  return static_cast<int>(cudaErrorInvalidValue);
}
