"""Keras Adam's two routes (``mrgan_tpu_torch/train/optim.py``): the CPU's
``_foreach`` passes, and the fused kernel (``csrc/adam.cu``, wrapped by
``ops/adam_cuda.py``) with its host-side leaf table, its float32 scalars and
its checks. The kernel's source is also built for the host with g++ and
held bit for bit to a float32 replay of the ``_foreach`` route's
operations, each correctly rounded as on the card. The host build emulates
the few CUDA features the source uses (the grid walked block by block and
thread by thread, streaming loads as plain ones), so it checks the kernel's
indexing and its order of operations, not its speed. Where there is no g++
those cases skip.
"""

import bisect
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mrgan_tpu_torch.ops import adam_cuda
from mrgan_tpu_torch.train import gan, mlp, optim, protocol
from mrgan_tpu_torch.variants import autoencoder, baselines, wgan

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# the two trainers' settings: the GAN's (mr_gan.py:165) and the AE's
SETTINGS = [dict(lr=6e-4, b1=0.5, b2=0.999, eps=1e-8),
            dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)]
# element counts with ragged ends: not multiples of 4 or 8, of a chunk or
# of a vector, one of a single element, and several chunks long
SIZES = [adam_cuda.CHUNK * 2 + 5, 7, 1, adam_cuda.CHUNK, 3 * 1000 + 3, 12]


def _todays_update(grads, state, params, lr, b1, b2, eps, stride):
    """``optim.update``'s body before the kernel, copied as it was: the
    formula the CPU route keeps."""
    t = state["t"] + stride
    lr_t = optim.lr_at(t, lr, b1, b2)
    p = params
    math = torch.float64 if p[0].dtype == torch.float64 else torch.float32
    g = [x.to(math) for x in grads]
    m_old, v_old = state["m"], state["v"]
    dtype = m_old[0].dtype
    m = torch._foreach_add(
        torch._foreach_mul([x.to(math) for x in m_old], b1),
        torch._foreach_mul(g, 1.0 - b1))
    v = torch._foreach_add(
        torch._foreach_mul([x.to(math) for x in v_old], b2),
        torch._foreach_mul(torch._foreach_mul(g, 1.0 - b2), g))
    m = [x.to(dtype) for x in m]
    v = [x.to(dtype) for x in v]
    denom = torch._foreach_add(
        torch._foreach_sqrt([x.to(math) for x in v]), eps)
    step = torch._foreach_div(
        torch._foreach_mul([x.to(math) for x in m], lr_t), denom)
    return torch._foreach_sub(p, step), {"m": m, "v": v, "t": t}


def _tree(seed, sizes=SIZES, grad_dtype=torch.float32):
    """A parameter tree of these leaf sizes and a gradient tree for it
    (leaves in sorted-key order, as ``tree.leaves`` walks them)."""
    gen = torch.Generator().manual_seed(seed)
    params = {"l%02d" % i: torch.randn(n, generator=gen)
              for i, n in enumerate(sizes)}
    grads = {k: (torch.randn(x.shape, generator=gen) * 10.0 ** (
        i % 5 - 3)).to(grad_dtype) for i, (k, x) in enumerate(params.items())}
    return params, grads


def _same(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("grad", sorted(DTYPES))
@pytest.mark.parametrize("moments", sorted(DTYPES))
def test_cpu_update_is_todays_foreach_formula(moments, grad):
    """Three updates at stride 2 (the shared counter) from t0 = -1: every
    leaf of p, m and v bit for bit the formula's, in both moment dtypes and
    with float32 or bf16 gradients."""
    params, _ = _tree(0)
    state = optim.init(params, DTYPES[moments], t0=-1)
    want_p = list(params.values())
    want = {"m": list(state["m"].values()), "v": list(state["v"].values()),
            "t": -1}
    for step in range(3):
        _, grads = _tree(step + 1, grad_dtype=DTYPES[grad])
        params, state = optim.update(grads, state, params, stride=2)
        want_p, want = _todays_update(list(grads.values()), want, want_p,
                                      6e-4, 0.5, 0.999, 1e-8, stride=2)
        assert state["t"] == want["t"] == 2 * step + 1
        assert _same(list(params.values()), want_p)
        assert _same(list(state["m"].values()), want["m"])
        assert _same(list(state["v"].values()), want["v"])
    assert state["m"]["l00"].dtype == DTYPES[moments]


def _leaf_of(firsts, c):
    """The kernel's search: the last leaf whose first chunk is <= c."""
    return bisect.bisect_right(firsts, c) - 1


@pytest.mark.parametrize("sizes", [
    SIZES, [5, 0, 9, 0], [adam_cuda.CHUNK - 1, adam_cuda.CHUNK + 1, 3],
    [8 * 1000 + 7] * 3])
def test_plan_takes_each_element_once(sizes):
    """One launch; each leaf's first chunk the prefix sum of the chunk
    counts before it; empty leaves left out; and walking the grid as the
    kernel does covers every element of every leaf exactly once."""
    (idx, firsts, total), = adam_cuda.plan(sizes)
    assert idx == [i for i, n in enumerate(sizes) if n]
    counts = [-(-sizes[i] // adam_cuda.CHUNK) for i in idx]
    assert firsts == list(np.cumsum([0] + counts[:-1]))
    assert total == sum(counts)
    seen = [np.zeros(sizes[i], int) for i in idx]
    for c in range(total):
        leaf = _leaf_of(firsts, c)
        base = (c - firsts[leaf]) * adam_cuda.CHUNK
        seen[leaf][base:base + adam_cuda.CHUNK] += 1
    assert all((s == 1).all() for s in seen)


def test_plan_splits_a_tree_with_more_leaves_than_a_table_holds():
    """101 leaves of sizes 1 to 101: launches of 48, 48 and 5 leaves, in
    order, each launch's first chunks starting again at 0."""
    sizes = list(range(1, 102))
    plans = adam_cuda.plan(sizes)
    assert [len(idx) for idx, _, _ in plans] == [48, 48, 5]
    assert [i for idx, _, _ in plans for i in idx] == list(range(101))
    for idx, firsts, total in plans:
        assert firsts == list(range(len(idx))) and total == len(idx)
    small = adam_cuda.plan([7, 0, 3, 9, 4], chunk=4, max_leaves=2)
    assert small == [([0, 2], [0, 2], 3), ([3, 4], [0, 3], 4)]


@pytest.mark.parametrize("setting", SETTINGS, ids=["gan", "ae"])
def test_scalars_are_torchs_float32_conversion(setting):
    """b1, 1 - b1, b2, 1 - b2, eps and lr_t as float32: what torch makes of
    the same Python floats, as a tensor and inside a multiplication of a
    float32 tensor by the Scalar (the ``_foreach`` route's own)."""
    lr_t = optim.lr_at(7, setting["lr"], setting["b1"], setting["b2"])
    got = adam_cuda.scalars(lr_t, setting["b1"], setting["b2"],
                            setting["eps"])
    python = (setting["b1"], 1.0 - setting["b1"], setting["b2"],
              1.0 - setting["b2"], setting["eps"], lr_t)
    for x, y in zip(python, got):
        assert y == torch.tensor(x, dtype=torch.float32).item()
        assert y == torch.ones(1).mul(x).item()


def test_cpu_training_never_builds_or_launches_the_kernel(monkeypatch):
    """A GAN step and an autoencoder's training on the CPU run without nvcc
    or a card: the kernel is never built and ``launches`` stays 0."""
    def refuse():
        raise AssertionError("the CPU route built the kernel")

    monkeypatch.setattr(adam_cuda, "build", refuse)
    monkeypatch.setattr(adam_cuda, "launches", 0)
    cfg = autoencoder.AeConfig(nodes=(8, 4), epochs=1, batch_size=8)
    autoencoder.train_autoencoder(torch.Generator().manual_seed(0),
                                  torch.randn(2, 16, 12), cfg)
    objects = {"o%d" % o: {"x": np.random.RandomState(o).randn(
        10, 4).astype(np.float32), "y": np.full(10, o % 6, np.int32)}
        for o in range(6)}
    gan_cfg = gan.GanConfig(epochs=1, batch_size=10,
                            opt_state_dtype="bfloat16")
    protocol.run_gan_loo(objects, 50, cfg=gan_cfg, chunk=6, device="cpu")
    assert adam_cuda.launches == 0


def _leaves(dtypes, sizes=(9, 4)):
    return [torch.zeros(n, dtype=dt) for n, dt in zip(sizes, dtypes)]


@pytest.mark.parametrize("case", ["float64", "non_contiguous", "shape",
                                  "mixed_moments", "int_grad", "count"])
def test_leaves_the_kernel_does_not_take_are_refused(case):
    """``check_leaves`` (run before any launch) refuses float64 parameters,
    a non-contiguous leaf, a moment whose shape is not its parameter's,
    moments of two dtypes, an integer gradient and lists of unequal length."""
    f32 = torch.float32
    p, g, m, v = (_leaves([f32, f32]) for _ in range(4))
    adam_cuda.check_leaves(p, g, m, v)
    if case == "float64":
        p[1] = p[1].double()
    elif case == "non_contiguous":
        m[0] = torch.zeros(9, 2)[:, 0]
    elif case == "shape":
        v[1] = torch.zeros(2, 2)
    elif case == "mixed_moments":
        m[1] = m[1].bfloat16()
    elif case == "int_grad":
        g[0] = g[0].int()
    else:
        g = g[:1]
    with pytest.raises((TypeError, ValueError)):
        adam_cuda.check_leaves(p, g, m, v)


@pytest.mark.parametrize("case", ["float64", "non_contiguous"])
def test_a_cuda_leaf_the_kernel_does_not_take_is_refused(case):
    """On the card: ``optim.update`` raises for a float64 or a
    non-contiguous CUDA leaf, before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    dt = torch.float64 if case == "float64" else torch.float32
    params = {"w": torch.zeros(6, 4, dtype=dt, device="cuda")}
    if case == "non_contiguous":
        params["w"] = params["w"].t()
    state = optim.init(params)
    before = adam_cuda.launches
    with pytest.raises((TypeError, ValueError)):
        optim.update({"w": torch.ones_like(params["w"])}, state, params)
    assert adam_cuda.launches == before


def _trainer_cell(trainer, monkeypatch):
    """One tiny CPU run of a trainer that updates through ``optim.update``
    (``trainers`` below)."""
    rng = np.random.RandomState(5)
    y = np.tile(np.arange(6), 8)
    x = (3.0 * rng.randn(6, 10)[y] + rng.randn(48, 10)).astype(np.float32)
    if trainer.startswith("gan_loo"):
        objects = {"o%d" % o: {"x": rng.randn(10, 4).astype(np.float32),
                               "y": np.full(10, o % 6, np.int32)}
                   for o in range(6)}
        cfg = gan.GanConfig(epochs=1, batch_size=10,
                            opt_state_dtype="bfloat16",
                            matmul_weight_dtype=("bfloat16" if trainer ==
                                                 "gan_loo_bf16_shadows"
                                                 else "float32"))
        protocol.run_gan_loo(objects, 50, cfg=cfg, chunk=6, device="cpu")
    elif trainer == "autoencoder":
        autoencoder.train_autoencoder(
            torch.Generator().manual_seed(0), torch.randn(2, 16, 12),
            autoencoder.AeConfig(nodes=(8, 4), epochs=1, batch_size=8))
    elif trainer == "mlp":
        mlp.run_mlp_cell(x, y, 50, cfg=mlp.MlpConfig(epochs=1, batch_size=8),
                         seed=0, n_splits=3, device="cpu")
    elif trainer.startswith("wgan"):
        small = dict(noise_size=10, batch_size=8, epochs=1, gen_hidden=8,
                     disc_width=16, disc_blocks=2)
        if trainer == "wgan_iwgan":
            cfg = wgan.WganConfig(**small)
        else:
            small.pop("gen_hidden")
            cfg = wgan.iwganlstm_config(**small, lstm_units=3,
                                        petzka_lp=True)
            init = wgan.init_params

            def scaled(*args, **kwargs):
                # the critic's head scaled so that the Petzka penalty is
                # active and its double backward trains the critic
                params = init(*args, **kwargs)
                out = params["disc"]["out"]
                params["disc"]["out"] = {**out, "w": 1000 * out["w"]}
                return params

            monkeypatch.setattr(wgan, "init_params", scaled)
        wgan.run_wgan_cell(x, y, 0.5, cfg=cfg, seed=0, n_splits=3,
                           device="cpu")
    elif trainer == "resnn":
        baselines.learn_resnn(x[:24], y[:24], x[24:], y[24:],
                              baselines.ResNNConfig(epochs=1, batch_size=8),
                              device="cpu")
    else:
        baselines.learn_bilstm(x[:24, :6], y[:24], x[24:, :6], y[24:],
                               baselines.BiLstmConfig(epochs=1, batch_size=8,
                                                      units=3, layers=2),
                               device="cpu")


@pytest.mark.parametrize("trainer", [
    "gan_loo", "gan_loo_bf16_shadows", "autoencoder", "mlp", "wgan_iwgan",
    "wgan_petzka", "resnn", "bilstm"])
def test_every_trainers_leaves_are_what_the_kernel_takes(trainer,
                                                         monkeypatch):
    """Each trainer's updates, run on the CPU, hand the kernel's wrapper
    leaves it takes (``adam_cuda.taken``: dtypes, shapes, contiguous
    parameters and moments), so that a trainer the kernel would refuse on
    the card fails here first."""
    real, calls = optim.foreach_step, []

    def checked(p, g, m, v, *args):
        calls.append(len(p))
        return real(p, adam_cuda.taken(p, g, m, v), m, v, *args)

    monkeypatch.setattr(optim, "foreach_step", checked)
    _trainer_cell(trainer, monkeypatch)
    assert calls, "the trainer made no update"


# --------------------------------------------------------------------------
# The kernel's source built for the host
# --------------------------------------------------------------------------

HEADER = r"""
#pragma once
#include <cmath>
#include <cstring>
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 threadIdx, blockIdx;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __grid_constant__
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
template <class T> inline T __ldcs(const T* p) { return *p; }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsqrt_rn(float a) { volatile float r = std::sqrt(a); return r; }
struct __nv_bfloat16 { unsigned short x; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {  // round to nearest even
  unsigned u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {0x7fff};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.x; }
template <class K, class A>
void host_launch(K kernel, unsigned grid, unsigned threads, const A& a) {
  for (unsigned b = 0; b < grid; ++b)
    for (unsigned t = 0; t < threads; ++t) {
      blockIdx = dim3(b);
      threadIdx = dim3(t);
      kernel(a);
    }
}
"""


def host_source():
    """adam.cu with the host emulation's header and launch."""
    s = adam_cuda.SOURCE.read_text()
    s = s.replace("#include <cuda_bf16.h>\n", "")
    s = s.replace("#include <cuda_runtime.h>", '#include "cuda_runtime.h"')
    s, n = re.subn(r"adam_kernel<MT><<<n_chunks, kThreads, 0, stream>>>"
                   r"\(table\);",
                   "host_launch(adam_kernel<MT>, n_chunks, kThreads, table);",
                   s)
    assert n == 1, n
    return s


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's source for the host")
    d = tmp_path_factory.mktemp("adam_host")
    (d / "cuda_runtime.h").write_text(HEADER)
    (d / "adam_host.cpp").write_text(host_source())
    so = d / "libadam_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-I", str(d), "-o", str(so), str(d / "adam_host.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    f32, i32, vp = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    lib.mrgan_adam.argtypes = [vp, i32, i32, i32, i32] + [f32] * 6 + [vp]
    lib.mrgan_adam.restype = i32
    return lib


def _flat_views(leaves):
    """The leaves as views into one flat buffer, as ``gan.grad_mean`` hands
    them to the optimizer: most start off a 16-byte boundary."""
    flat = torch.cat([x.reshape(-1) for x in leaves])
    return [t.view(x.shape) for t, x in
            zip(flat.split([x.numel() for x in leaves]), leaves)]


def _ieee_step(p, g, m, v, lr_t, b1, b2, eps, sqrt=np.sqrt):
    """``foreach_step``'s operations in its order, each rounded once to
    float32 by numpy (IEEE round to nearest, as the card rounds them), the
    moments rounded to their dtype by torch: (new p, m, v). The host build
    is held to this replay: torch's vectorised CPU sqrt is not correctly
    rounded everywhere (``test_foreach_step_on_the_cpu_is_the_replay``)."""
    b1, omb1, b2, omb2, eps, lr = map(np.float32, adam_cuda.scalars(
        lr_t, b1, b2, eps))
    out = ([], [], [])
    for pk, gk, mk, vk in zip(p, g, m, v):
        gf = gk.float().numpy()
        m1 = mk.float().numpy() * b1 + gf * omb1
        v1 = vk.float().numpy() * b2 + (gf * omb2) * gf
        ms, vs = (torch.from_numpy(x).to(mk.dtype) for x in (m1, v1))
        denom = sqrt(vs.float().numpy()) + eps
        step = (ms.float().numpy() * lr) / denom
        for lst, x in zip(out, (torch.from_numpy(pk.numpy() - step), ms, vs)):
            lst.append(x)
    return out


def _torch_sqrt(x):
    return torch.from_numpy(x).sqrt().numpy()


def test_foreach_step_on_the_cpu_is_the_replay():
    """``foreach_step`` on the CPU is the float32 replay bit for bit once the
    replay takes torch's own sqrt. (With numpy's correctly rounded sqrt
    elements may differ by an ulp where torch's vectorised sqrt is not
    correctly rounded, as on AVX-512: so the host build is held to the
    replay, not to the CPU's ``_foreach`` passes.)"""
    params, grads = _tree(0)
    p, g = list(params.values()), list(grads.values())
    m = [torch.randn(x.shape).bfloat16() for x in p]
    v = [torch.rand(x.shape).bfloat16() for x in p]
    lr_t = optim.lr_at(3, 6e-4, 0.5, 0.999)
    want = optim.foreach_step(p, g, m, v, lr_t, 0.5, 0.999, 1e-8)
    replay = _ieee_step(p, g, m, v, lr_t, 0.5, 0.999, 1e-8, sqrt=_torch_sqrt)
    for name, got, ref in zip("pmv", replay, want):
        assert _same(got, ref), name


@pytest.mark.parametrize("layout", ["aligned", "grad_views"])
@pytest.mark.parametrize("grad", ["f32", "bf16", "mixed"])
@pytest.mark.parametrize("moments", sorted(DTYPES))
@pytest.mark.parametrize("setting", SETTINGS, ids=["gan", "ae"])
def test_host_build_of_the_kernel_is_the_formula_bit_for_bit(
        host_lib, setting, moments, grad, layout):
    """Three updates through the kernel's C entry point (the wrapper's own
    leaf table and scalars) against the float32 replay of ``foreach_step``:
    every leaf of p, m and v bit for bit, over ragged chunks and vectors,
    bf16 gradients (the bf16 weight shadows' leaves: all, or the weights
    alone) and parameters and gradients that are unaligned views of one
    buffer."""
    gdt = {"f32": [torch.float32] * len(SIZES),
           "bf16": [torch.bfloat16] * len(SIZES),
           "mixed": [torch.bfloat16, torch.float32] * (len(SIZES) // 2)}[grad]
    params, _ = _tree(0)
    p = list(params.values())
    state = optim.init(params, DTYPES[moments], t0=-1)
    m, v = list(state["m"].values()), list(state["v"].values())
    lr, b1, b2, eps = (setting[k] for k in ("lr", "b1", "b2", "eps"))
    for t in (1, 3, 5):
        _, grads = _tree(t)
        g = [x.to(dt) for x, dt in zip(grads.values(), gdt)]
        if layout == "grad_views":
            g = _flat_views(g) if grad != "mixed" else g
            p = _flat_views(p)
        lr_t = optim.lr_at(t, lr, b1, b2)
        want = _ieee_step(p, g, m, v, lr_t, b1, b2, eps)
        adam_cuda.check_leaves(p, g, m, v)
        out = tuple([torch.empty_like(x) for x in xs] for xs in (p, m, v))
        assert adam_cuda.launch(host_lib, p, g, m, v, out, lr_t, b1, b2,
                                eps, None) == 1
        for name, got, ref in zip("pmv", out, want):
            assert _same(got, ref), name
        p, m, v = out


def test_host_build_splits_a_network_of_many_leaves(host_lib):
    """50 leaves (more than one launch's table holds) in two launches,
    bit for bit the float32 replay."""
    sizes = [1 + 37 * i for i in range(50)]
    params, grads = _tree(4, sizes)
    p, g = list(params.values()), list(grads.values())
    m = [torch.randn(x.shape).bfloat16() for x in p]
    v = [torch.rand(x.shape).bfloat16() for x in p]
    lr_t = optim.lr_at(1, 6e-4, 0.5, 0.999)
    want = _ieee_step(p, g, m, v, lr_t, 0.5, 0.999, 1e-8)
    out = tuple([torch.empty_like(x) for x in xs] for xs in (p, m, v))
    assert adam_cuda.launch(host_lib, p, g, m, v, out, lr_t, 0.5, 0.999,
                            1e-8, None) == 2
    for name, got, ref in zip("pmv", out, want):
        assert _same(got, ref), name


def test_host_build_refuses_a_table_it_cannot_hold(host_lib):
    """The C entry point returns an error, and launches nothing, for more
    leaves than its table holds or a chunk size it was not built for."""
    rows = np.zeros((adam_cuda.MAX_LEAVES + 1, 10), np.int64)
    consts = adam_cuda.scalars(1e-3, 0.5, 0.999, 1e-8)
    assert host_lib.mrgan_adam(rows.ctypes.data, adam_cuda.MAX_LEAVES + 1, 1,
                               adam_cuda.CHUNK, 0, *consts, None) != 0
    assert host_lib.mrgan_adam(rows.ctypes.data, 1, 1, adam_cuda.CHUNK // 2,
                               0, *consts, None) != 0
