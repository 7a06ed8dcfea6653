"""The recurrence kernels' CUDA source (mrgan_tpu_torch/csrc/lstm_scan.cu)
built for the host and run on the CPU: every lanes-a-row variant of the
forward and backward kernels against their plain versions in
ops/lstm_cuda.py, and against each other bit for bit; and the double
backward's two kernels (lstm_scan_bwd_ext, lstm_scan_adj) against theirs.

The host build emulates the few CUDA features the source uses: a block's
32 lanes are 32 threads, __syncwarp and the shuffles meet at a barrier,
cp.async copies at once and shared memory is one array. It checks the
kernels' indexing (lanes, rows, chunks, time order, the saved layout), not
their speed or the card's rounding of tanhf. It needs g++ (C++20); where
there is none it skips."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mrgan_tpu_torch.ops import lstm_cuda

HEADER = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K> cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
inline std::barrier<>* warp_barrier = nullptr;
inline float lanes[32];
inline void __syncwarp(unsigned = 0xffffffffu) { warp_barrier->arrive_and_wait(); }
inline float exchange(float v, int from) {
  lanes[threadIdx.x] = v;
  warp_barrier->arrive_and_wait();
  const float r = lanes[from];
  warp_barrier->arrive_and_wait();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src, int width) {
  return exchange(v, (threadIdx.x / width) * width + src % width);
}
alignas(16) inline float smem[1 << 16];
template <class K, class A>
void host_launch(K kernel, dim3 grid, unsigned threads, const A& a) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> bar(threads);
      warp_barrier = &bar;
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < threads; ++t)
        ts.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          kernel(a);
        });
      for (auto& th : ts) th.join();
    }
}
"""

# the bodies written in PTX, as the host runs them
HOST_BODIES = {
    "cp_async4": "*dst = *src;",
    "cp_async16": "for (int k = 0; k < 4; ++k) dst[k] = src[k];",
    "cp_async_commit": "",
    "cp_async_wait_one": "",
}


def host_source():
    """lstm_scan.cu with its PTX bodies, its shared-memory declaration and
    its kernel launches replaced by the host emulation's."""
    s = lstm_cuda.SOURCE.read_text()
    for name, body in HOST_BODIES.items():
        i = s.index("__device__ __forceinline__ void %s(" % name)
        j = s.index("\n}\n", i) + 3
        s = s[:i] + s[i:s.index("{", i)] + "{ " + body + " }\n" + s[j:]
    s = s.replace("extern __shared__ __align__(16) float smem[];", "")
    s, n = re.subn(r"kernel<<<grid, kWarp, [^>]*>>>\(a\);",
                   "host_launch(kernel, grid, kWarp, a);", s)
    assert n == 3, n
    return s.replace("#include <cuda_runtime.h>", '#include "cuda_runtime.h"')


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' source for the host")
    d = tmp_path_factory.mktemp("lstm_host")
    (d / "cuda_runtime.h").write_text(HEADER)
    (d / "lstm_scan_host.cpp").write_text(host_source())
    so = d / "liblstm_scan_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", "-I", str(d), "-o", str(so),
         str(d / "lstm_scan_host.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mrgan_lstm_scan_fwd.argtypes = [vp] * 5 + [i32] * 7 + [vp] * 5
    lib.mrgan_lstm_scan_bwd.argtypes = [vp] * 5 + [i32] * 7 + [vp] * 2
    lib.mrgan_lstm_scan_bwd_ext.argtypes = [vp] * 7 + [i32] * 7 + [vp] * 4
    lib.mrgan_lstm_scan_adj.argtypes = [vp] * 6 + [i32] * 7 + [vp] * 4
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run(lib, units, lanes, fused, dirs, reverse, sequences, steps, rows,
         seed):
    """Both kernels on seeded inputs (through the C entry points, as the
    wrappers call them): (forward outputs, dz, the plain versions' ones)."""
    gen = torch.Generator().manual_seed(seed)
    n_folds = 2
    n_seq, gates = n_folds * dirs, 4 * units
    rand = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    wh = 0.5 * rand(n_seq, units, gates)
    if fused:
        inputs = dict(xw=None, x=rand(n_folds, steps, rows),
                      wx=rand(n_seq, gates), b=rand(n_seq, gates))
    else:
        inputs = dict(xw=rand(n_seq, steps, rows, gates), x=None, wx=None,
                      b=None)
    want = lstm_cuda.fwd_reference(inputs["xw"], wh, dirs, reverse,
                                   x=inputs["x"], wx=inputs["wx"],
                                   b=inputs["b"])
    got = [torch.empty_like(t) for t in want]
    assert lib.mrgan_lstm_scan_fwd(
        _ptr(inputs["x"]), _ptr(inputs["wx"]), _ptr(inputs["b"]),
        _ptr(inputs["xw"]), _ptr(wh), n_seq, steps, rows, units, lanes, dirs,
        int(reverse), *map(_ptr, got), None) == 0
    # without the saved set: h only, then the final state alone
    h_only, last = torch.empty_like(got[0]), torch.empty_like(got[1])
    assert lib.mrgan_lstm_scan_fwd(
        _ptr(inputs["x"]), _ptr(inputs["wx"]), _ptr(inputs["b"]),
        _ptr(inputs["xw"]), _ptr(wh), n_seq, steps, rows, units, lanes, dirs,
        int(reverse), _ptr(h_only), _ptr(last), None, None, None) == 0
    assert torch.equal(h_only, got[0]) and torch.equal(last, got[1])
    dh_seq = rand(n_seq, steps, rows, units) if sequences else None
    dh_last = rand(n_seq, rows, units)
    _, _, zs, c = want
    dz_want = lstm_cuda.bwd_reference(dh_seq, dh_last, zs, c, wh, dirs,
                                      reverse)
    dz = torch.empty_like(dz_want)
    assert lib.mrgan_lstm_scan_bwd(
        _ptr(dh_seq), _ptr(dh_last), _ptr(zs), _ptr(c), _ptr(wh), n_seq,
        steps, rows, units, lanes, dirs, int(reverse), _ptr(dz), None) == 0
    return got, dz, want, dz_want


@pytest.mark.parametrize("units", [4, 16])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dirs,reverse,sequences",
                         [(2, False, False), (1, True, True)])
def test_host_build_of_the_kernels_matches_the_plain_versions(
        host_lib, units, fused, dirs, reverse, sequences):
    """Both kernels, every lanes-a-row variant, over a partial last block
    of rows and a partial last chunk of steps: the outputs, the saved
    gates and cells and dz within rounding of the plain versions (the
    host's tanhf is not the card's), and the variants bit for bit alike."""
    steps, rows = 37, 9
    results = []
    for lanes in lstm_cuda.LANES[units]:
        got, dz, want, dz_want = _run(host_lib, units, lanes, fused, dirs,
                                      reverse, sequences, steps, rows, seed=5)
        for name, a, b in zip(("h", "h_last", "zs", "c"), got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        np.testing.assert_allclose(dz.numpy(), dz_want.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg="dz")
        results.append(got + [dz])
    for other in results[1:]:
        for a, b in zip(other, results[0]):
            assert torch.equal(a, b)


def test_unsupported_lanes_return_an_error(host_lib):
    z = torch.zeros(1)
    assert host_lib.mrgan_lstm_scan_fwd(
        None, None, None, _ptr(z), _ptr(z), 2, 1, 1, 4, 8, 2, 0, None,
        _ptr(z), None, None, None) == -1
    assert host_lib.mrgan_lstm_scan_bwd(
        None, None, _ptr(z), _ptr(z), _ptr(z), 2, 1, 1, 12, 4, 2, 0,
        _ptr(z), None) == -1
    assert host_lib.mrgan_lstm_scan_bwd_ext(
        None, None, _ptr(z), _ptr(z), _ptr(z), None, None, 2, 1, 1, 4, 8, 2,
        0, _ptr(z), None, None, None) == -1
    assert host_lib.mrgan_lstm_scan_adj(
        _ptr(z), _ptr(z), _ptr(z), _ptr(z), _ptr(z), _ptr(z), 2, 1, 1, 16, 4,
        2, 0, _ptr(z), _ptr(z), _ptr(z), None) == -1


@pytest.mark.parametrize("units,lanes", [
    (units, lanes) for units, variants in lstm_cuda.LANES.items()
    for lanes in variants])
@pytest.mark.parametrize("dirs,reverse,sequences",
                         [(2, False, False), (1, True, True)])
def test_host_build_of_the_double_backward_kernels(host_lib, units, lanes,
                                                   dirs, reverse, sequences):
    """Every lanes-a-row variant of the double backward's two kernels, over
    a partial last chunk of steps and a partial last block of rows:
    lstm_scan_bwd_ext without cotangents (its carries stored) is
    lstm_scan_bwd's dz bit for bit; with cotangents, and lstm_scan_adj,
    within rounding of the plain versions; and each result bit for bit the
    first variant's."""
    steps, rows, n_seq = 37, 9, 2 * dirs
    gen = torch.Generator().manual_seed(6)
    rand = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    wh = 0.5 * rand(n_seq, units, 4 * units)
    _, _, zs, c = lstm_cuda.fwd_reference(rand(n_seq, steps, rows,
                                               4 * units), wh, dirs, reverse)
    dh_seq = rand(n_seq, steps, rows, units) if sequences else None
    dh_last = rand(n_seq, rows, units)
    dzs, dcs, delta = rand(*zs.shape), rand(*c.shape), rand(*zs.shape)
    out = lambda *like: [torch.empty_like(t) for t in like]  # noqa: E731

    def ext(lanes, extras, carries):
        dz, e, k = out(zs, c, c)
        assert host_lib.mrgan_lstm_scan_bwd_ext(
            _ptr(dh_seq), _ptr(dh_last), _ptr(zs), _ptr(c), _ptr(wh),
            *(map(_ptr, extras) if extras else (None, None)), n_seq, steps,
            rows, units, lanes, dirs, int(reverse), _ptr(dz),
            *((_ptr(e), _ptr(k)) if carries else (None, None)), None) == 0
        return dz, e, k

    def adj(lanes, e, k):
        bars = out(c, zs, c)
        assert host_lib.mrgan_lstm_scan_adj(
            _ptr(delta), _ptr(zs), _ptr(c), _ptr(e), _ptr(k), _ptr(wh),
            n_seq, steps, rows, units, lanes, dirs, int(reverse),
            *map(_ptr, bars), None) == 0
        return bars

    def variant(lanes):
        dz, e, k = ext(lanes, None, True)
        return [dz, e, k, ext(lanes, (dzs, dcs), False)[0],
                ext(lanes, (dzs, None), False)[0]] + adj(lanes, e, k)

    got = variant(lanes)
    dz, e, k, dz_x, dz_z = got[:5]
    dz_bwd = torch.empty_like(zs)
    assert host_lib.mrgan_lstm_scan_bwd(
        _ptr(dh_seq), _ptr(dh_last), _ptr(zs), _ptr(c), _ptr(wh), n_seq,
        steps, rows, units, lanes, dirs, int(reverse), _ptr(dz_bwd),
        None) == 0
    assert torch.equal(dz, dz_bwd)
    want = lstm_cuda.bwd_ext_reference(dh_seq, dh_last, zs, c, wh, dirs,
                                       reverse, carries=True)
    for name, a, b in zip(("dz", "e", "k"), (dz, e, k), want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    for name, a, extras in (("dz with cotangents", dz_x, (dzs, dcs)),
                            ("dz with dzs alone", dz_z, (dzs, None))):
        want_x = lstm_cuda.bwd_ext_reference(dh_seq, dh_last, zs, c, wh,
                                             dirs, reverse, *extras)[0]
        np.testing.assert_allclose(a.numpy(), want_x.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    want = lstm_cuda.adj_reference(delta, zs, c, e, k, wh, dirs, reverse)
    for name, a, b in zip(("e_bar", "zs_bar", "c_bar"), got[5:], want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    first = lstm_cuda.LANES[units][0]
    if lanes != first:
        for a, b in zip(got, variant(first)):
            assert torch.equal(a, b)
