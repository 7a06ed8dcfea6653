// Keras-2.0.9 Adam (train/optim.py) as one pass over a network's leaves.
//
// Not a port of a Pallas kernel: on the TPU the update is XLA's fusion of
// mrgan_tpu/train/optim.py:87-131 (one fused loop a leaf). Eager PyTorch ran
// it as about a dozen torch._foreach_* passes, each reading and writing
// whole float32 temporaries, and with bf16 moments six casts a leaf. Here
// every leaf of the network goes in one launch, and each element is read
// once (p and g in their dtypes, m and v as stored) and written once (new
// p, m and v, into new tensors).
//
// What bounds it on an H100: bytes. With bf16 moments and float32 p and g an
// element moves 20 B (28 B with float32 moments) for 12 floating point
// operations, under one a byte against the card's ~20 float32 operations a
// byte of bandwidth. So the design is about the memory stream:
// - One block takes one chunk of kChunk elements of one leaf. The leaf
//   table (seven pointers, the element count, the leaf's first chunk and
//   its flags) travels in the kernel's parameters (__grid_constant__, read
//   from the constant bank, uniform across the block): nothing is uploaded
//   before the launch. A block finds its leaf by a binary search over the
//   table's first chunks (prefix sums of each leaf's chunk count).
// - A thread issues all of its loads before any math: kUnroll 16-byte
//   loads of p and g (float32) and 16- or 8-byte loads of m and v (four
//   float32 or four bf16 values), neighbouring threads on neighbouring
//   vectors. A leaf's ragged end, or a leaf whose pointers are not aligned
//   to its vectors (views into one flat buffer: train/gan.py::grad_mean),
//   is read and written one element at a time.
// - Streaming loads and stores (ld.global.cs / st.global.cs): a step moves
//   gigabytes once through a 50 MB L2, and nothing is read twice.
//
// The arithmetic is the _foreach passes' own, in their order, each
// operation rounded once (round to nearest even; no FMA contraction, IEEE
// sqrt and division), with float32 scalars converted from the Python
// floats as torch converts a Scalar:
//   m = b1*m + (1-b1)*g;   v = b2*v + ((1-b2)*g)*g
//   m, v rounded to their stored dtype (bf16: __float2bfloat16_rn)
//   p = p - (m*lr_t) / (sqrt(v) + eps)      (m, v as stored)
// so the result equals the _foreach route's bit for bit. The gradient's
// dtype (float32, or bf16 under the bf16 weight shadows) is a flag a leaf;
// the moments' dtype selects the kernel instance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// The grid's shape, measured on an H100 (loo72's trees and the AE's, a
// launch each): 512 threads a block with 2 vectors a thread (64 registers)
// was at or near the fastest on all three; 256 x 1, 256 x 2 and 1024 x 1
// within 1-2 %, 256 x 4 and 512 x 4 (~100 registers) 4-8 % slower on the
// bf16-moment trees, 256 x 8 (178 registers) ~45 % slower.
constexpr int kThreads = 512;  // threads a block
constexpr int kUnroll = 2;     // 4-element vectors a thread
constexpr int kChunk = kThreads * 4 * kUnroll;  // elements a block: 4,096
constexpr int kMaxLeaves = 48;  // the table stays under 4 KB of parameters
constexpr int kGradBf16 = 1;    // flags: g is bf16
constexpr int kVector = 2;      // flags: every pointer on a 16-byte boundary

typedef unsigned short bf16_bits;

struct Leaf {
  const float* p;
  const void* g;
  const void* m;
  const void* v;
  float* p_out;
  void* m_out;
  void* v_out;
  long long n;  // elements
  int first;    // the leaf's first chunk in the launch
  int flags;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int n_leaves;
  float b1, omb1, b2, omb2, eps, lr;  // omb = one minus b, from the host
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16_bits x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}

// the stored value of x, and x as the parameter step reads it back
__device__ __forceinline__ float narrow(float x, float* stored) {
  *stored = x;
  return x;
}
__device__ __forceinline__ float narrow(float x, bf16_bits* stored) {
  *stored = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  return widen(*stored);
}

__device__ __forceinline__ void load4(const float* src, long long e, float (&d)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(src + e));
  d[0] = q.x;
  d[1] = q.y;
  d[2] = q.z;
  d[3] = q.w;
}
__device__ __forceinline__ void load4(const bf16_bits* src, long long e, float (&d)[4]) {
  const uint2 q = __ldcs(reinterpret_cast<const uint2*>(src + e));
  d[0] = __uint_as_float(q.x << 16);
  d[1] = __uint_as_float(q.x & 0xffff0000u);
  d[2] = __uint_as_float(q.y << 16);
  d[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* dst, long long e, const float (&s)[4]) {
  __stcs(reinterpret_cast<float4*>(dst + e), make_float4(s[0], s[1], s[2], s[3]));
}
__device__ __forceinline__ void store4(bf16_bits* dst, long long e, const bf16_bits (&s)[4]) {
  __stcs(reinterpret_cast<uint2*>(dst + e),
         make_uint2(s[0] | (static_cast<unsigned>(s[1]) << 16),
                    s[2] | (static_cast<unsigned>(s[3]) << 16)));
}

// One chunk of one leaf: kUnroll vectors a thread, loads first.
template <class MT, class GT>
__device__ __forceinline__ void adam_chunk(const Leaf& L, const Table& t, long long base) {
  const float* p = L.p;
  const GT* g = static_cast<const GT*>(L.g);
  const MT* m = static_cast<const MT*>(L.m);
  const MT* v = static_cast<const MT*>(L.v);
  const long long n = L.n;
  const bool vec = L.flags & kVector;
  float rp[kUnroll][4], rg[kUnroll][4], rm[kUnroll][4], rv[kUnroll][4];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long e = base + 4ll * (u * kThreads + threadIdx.x);
    if (vec && e + 4 <= n) {
      load4(p, e, rp[u]);
      load4(g, e, rg[u]);
      load4(m, e, rm[u]);
      load4(v, e, rv[u]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = e + k < n;
        rp[u][k] = in ? __ldcs(p + e + k) : 0.f;
        rg[u][k] = in ? widen(__ldcs(g + e + k)) : 0.f;
        rm[u][k] = in ? widen(__ldcs(m + e + k)) : 0.f;
        rv[u][k] = in ? widen(__ldcs(v + e + k)) : 0.f;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long e = base + 4ll * (u * kThreads + threadIdx.x);
    float po[4];
    MT mo[4], vo[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float gk = rg[u][k];
      const float m1 = __fadd_rn(__fmul_rn(rm[u][k], t.b1), __fmul_rn(gk, t.omb1));
      const float v1 = __fadd_rn(__fmul_rn(rv[u][k], t.b2),
                                 __fmul_rn(__fmul_rn(gk, t.omb2), gk));
      const float ms = narrow(m1, &mo[k]);
      const float vs = narrow(v1, &vo[k]);
      const float denom = __fadd_rn(__fsqrt_rn(vs), t.eps);
      po[k] = __fsub_rn(rp[u][k], __fdiv_rn(__fmul_rn(ms, t.lr), denom));
    }
    if (vec && e + 4 <= n) {
      store4(L.p_out, e, po);
      store4(static_cast<MT*>(L.m_out), e, mo);
      store4(static_cast<MT*>(L.v_out), e, vo);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (e + k < n) {
          __stcs(L.p_out + e + k, po[k]);
          __stcs(static_cast<MT*>(L.m_out) + e + k, mo[k]);
          __stcs(static_cast<MT*>(L.v_out) + e + k, vo[k]);
        }
      }
    }
  }
}

template <class MT>
__global__ void __launch_bounds__(kThreads) adam_kernel(const __grid_constant__ Table t) {
  const int c = blockIdx.x;
  int lo = 0, hi = t.n_leaves - 1;  // the last leaf whose first chunk <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].first <= c)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Leaf& L = t.leaf[lo];
  const long long base = static_cast<long long>(c - L.first) * kChunk;
  if (L.flags & kGradBf16)
    adam_chunk<MT, bf16_bits>(L, t, base);
  else
    adam_chunk<MT, float>(L, t, base);
}

template <class MT>
cudaError_t launch(const Table& table, int n_chunks, cudaStream_t stream) {
  adam_kernel<MT><<<n_chunks, kThreads, 0, stream>>>(table);
  return cudaGetLastError();
}

}  // namespace

// One launch over n_leaves leaves (at most kMaxLeaves). rows holds 10
// integers a leaf: the pointers p, g, m, v, p_out, m_out, v_out, the element
// count, the leaf's first chunk and its flags; the leaves' chunks (of
// `chunk` elements, which must be kChunk) number n_chunks in all.
extern "C" int mrgan_adam(const long long* rows, int n_leaves, int n_chunks, int chunk,
                          int moments_bf16, float b1, float one_minus_b1, float b2,
                          float one_minus_b2, float eps, float lr, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_chunks < 1 || chunk != kChunk)
    return cudaErrorInvalidValue;
  Table table{};
  for (int i = 0; i < n_leaves; ++i) {
    const long long* r = rows + 10 * i;
    table.leaf[i] = Leaf{reinterpret_cast<const float*>(r[0]),
                         reinterpret_cast<const void*>(r[1]),
                         reinterpret_cast<const void*>(r[2]),
                         reinterpret_cast<const void*>(r[3]),
                         reinterpret_cast<float*>(r[4]),
                         reinterpret_cast<void*>(r[5]),
                         reinterpret_cast<void*>(r[6]),
                         r[7],
                         static_cast<int>(r[8]),
                         static_cast<int>(r[9])};
  }
  table.n_leaves = n_leaves;
  table.b1 = b1;
  table.omb1 = one_minus_b1;
  table.b2 = b2;
  table.omb2 = one_minus_b2;
  table.eps = eps;
  table.lr = lr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return moments_bf16 ? launch<bf16_bits>(table, n_chunks, st)
                      : launch<float>(table, n_chunks, st);
}
