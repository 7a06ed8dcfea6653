"""Keras Adam as one kernel launch a network (``csrc/adam.cu``).

Not a port of a Pallas kernel: on the TPU XLA fuses the update of
``mrgan_tpu/train/optim.py:87-131`` into a loop a leaf. The kernel reads
each leaf's p, g, m and v once and writes new p, m and v once, with the
arithmetic of ``train/optim.py::foreach_step`` (the reference it is held
to) rounded as there, so the two agree bit for bit. ``train/optim.py::
update`` sends CUDA leaves here and CPU leaves to ``foreach_step``.

Here, on the host: the checks (float32 parameters, float32 or bf16
gradients, float32 or bf16 moments alike across the network, one shape a
leaf, contiguous parameters and moments, one device), the float32 scalars (converted from the
Python floats as torch converts a Scalar: ``scalars``) and the leaf table
(``plan``: each leaf's first chunk, the prefix sums of the chunk counts; a
network with more leaves than one launch's table holds, ``MAX_LEAVES``,
takes several launches). The table travels in the kernel's parameters, so
nothing is copied to the card before a launch.

Built like ``ops/lstm_cuda.py``: ``nvcc`` for ``sm_90a`` into
``build/mrgan_tpu_torch/`` at first use, a plain C entry point, loaded with
``ctypes``. ``launches`` counts the kernel's launches.
"""

import ctypes
import functools
import hashlib
import operator
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from .mel_cuda import BUILD_DIR, _nvcc

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "adam.cu"
CHUNK = 4096       # elements a block: csrc/adam.cu's kChunk
MAX_LEAVES = 48    # leaves a launch's table holds: csrc/adam.cu's kMaxLeaves
GRAD_BF16, VECTOR = 1, 2  # a leaf's flags, as csrc/adam.cu names them
MOMENT_DTYPES = (torch.float32, torch.bfloat16)

launches = 0       # kernel launches since the count was last set to 0
build_log = ""     # nvcc's output (-Xptxas -v) from the build, if this process built
_lib = None


def library_path():
    """Where the built library lives, keyed by a hash of the source."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / ("libadam_%s.so" % digest)


def build():
    """Build the kernel with nvcc for sm_90a if needed; return the loaded
    library. Raises if nvcc is missing or the build fails."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name("%s.%d.tmp" % (so.name, os.getpid()))
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (%d) building %s:\n%s"
                               % (proc.returncode, SOURCE, build_log))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    f32, i32, vp = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    lib.mrgan_adam.argtypes = [vp, i32, i32, i32, i32] + [f32] * 6 + [vp]
    lib.mrgan_adam.restype = i32
    _lib = lib
    return lib


def plan(numels, chunk=CHUNK, max_leaves=MAX_LEAVES):
    """The launches for leaves of these element counts: a list of (leaf
    indices, each leaf's first chunk, the launch's chunk count). A leaf
    takes ceil(n / chunk) chunks; empty leaves take none and are left out."""
    out, idx, firsts, total = [], [], [], 0
    for i, n in enumerate(numels):
        if n == 0:
            continue
        if len(idx) == max_leaves:
            out.append((idx, firsts, total))
            idx, firsts, total = [], [], 0
        idx.append(i)
        firsts.append(total)
        total += -(-n // chunk)
    if idx:
        out.append((idx, firsts, total))
    return out


def scalars(lr_t, b1, b2, eps):
    """(b1, 1 - b1, b2, 1 - b2, eps, lr_t) in float32: each Python float
    (1 - b taken in double, as ``foreach_step`` passes it) rounded to the
    nearest float32, as torch converts a Scalar for a float32 tensor."""
    return tuple(float(np.float32(x))
                 for x in (b1, 1.0 - b1, b2, 1.0 - b2, eps, lr_t))


def check_leaves(p, g, m, v):
    """Raise unless the kernel takes these leaves: float32 parameters,
    float32 or bf16 gradients, moments of one dtype (float32 or bf16) across
    the network, one shape a leaf, contiguous, on the parameters' device.
    (Runs on every update: the checks are written out, leaf by leaf.)"""
    if not (len(p) == len(g) == len(m) == len(v)) or not p:
        raise ValueError("params, grads and moments must hold the same "
                         "number of leaves, got %d, %d, %d and %d"
                         % (len(p), len(g), len(m), len(v)))
    dev, mdt = p[0].device, m[0].dtype
    if mdt not in MOMENT_DTYPES:
        raise TypeError("the moments must be float32 or bfloat16, got %s"
                        % mdt)
    for i, (pi, gi, mi, vi) in enumerate(zip(p, g, m, v)):
        if (pi.dtype != torch.float32 or gi.dtype not in MOMENT_DTYPES
                or mi.dtype != mdt or vi.dtype != mdt):
            raise TypeError(
                "leaf %d: p must be float32, g float32 or bfloat16, m and v "
                "%s; got %s, %s, %s and %s"
                % (i, mdt, pi.dtype, gi.dtype, mi.dtype, vi.dtype))
        shape = pi.shape
        if gi.shape != shape or mi.shape != shape or vi.shape != shape:
            raise ValueError("leaf %d: p, g, m and v must have one shape, got "
                             "%s" % (i, [tuple(x.shape)
                                         for x in (pi, gi, mi, vi)]))
        if not (pi.is_contiguous() and gi.is_contiguous()
                and mi.is_contiguous() and vi.is_contiguous()):
            raise ValueError("leaf %d: p, g, m and v must be contiguous" % i)
        if (pi.device != dev or gi.device != dev or mi.device != dev
                or vi.device != dev):
            raise ValueError("leaf %d: p, g, m and v must lie on %s, leaf 0's "
                             "device" % (i, dev))


def taken(p, g, m, v):
    """The gradients as the kernel takes them, after every leaf is checked
    (``check_leaves``): a gradient handed over with other strides (a double
    backward's transpose) is copied to a contiguous one; p, m and v are
    refused unless contiguous."""
    g = [x.contiguous() for x in g]
    check_leaves(p, g, m, v)
    return g


def adam(p, g, m, v, lr_t, b1, b2, eps):
    """One Adam step over a network's leaves on the card, in one launch
    (more where it has over ``MAX_LEAVES`` leaves): (new params, new m, new
    v), each a list of new tensors; nothing is changed in place."""
    global launches
    g = taken(p, g, m, v)
    dev = p[0].device
    if dev.type != "cuda":
        raise ValueError("the Adam kernel takes CUDA tensors, got %s" % dev)
    out = tuple([torch.empty_like(x) for x in xs] for xs in (p, m, v))
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        launches += launch(lib, p, g, m, v, out, lr_t, b1, b2, eps, stream)
    else:
        with torch.cuda.device(dev):
            launches += launch(lib, p, g, m, v, out, lr_t, b1, b2, eps,
                               stream)
    return out


def launch(lib, p, g, m, v, out, lr_t, b1, b2, eps, stream):
    """Launch ``lib``'s ``mrgan_adam`` over checked leaves, writing into
    ``out`` (new p, m and v lists), once for each launch of :func:`plan`;
    returns the number of launches. Raises on a launch error."""
    consts = scalars(lr_t, b1, b2, eps)
    moments_bf16 = int(m[0].dtype == torch.bfloat16)
    plans = plan([x.numel() for x in p], CHUNK, MAX_LEAVES)
    for idx, firsts, n_chunks in plans:
        rows = []
        for i, first in zip(idx, firsts):
            ptrs = [x.data_ptr() for x in (p[i], g[i], m[i], v[i], out[0][i],
                                           out[1][i], out[2][i])]
            # vectors are 16 bytes of float32 or 8 of bf16: a 16-byte
            # boundary serves both
            flags = ((GRAD_BF16 if g[i].dtype == torch.bfloat16 else 0)
                     | (VECTOR if functools.reduce(operator.or_, ptrs) % 16
                        == 0 else 0))
            rows += ptrs + [p[i].numel(), first, flags]
        rows = np.array(rows, np.int64)
        err = lib.mrgan_adam(rows.ctypes.data, len(idx), n_chunks, CHUNK,
                             moments_bf16, *consts, stream)
        if err != 0:
            raise RuntimeError("mrgan_adam launch failed: CUDA error %d" % err)
    return len(plans)
