"""The LSTM recurrence kernels (``csrc/lstm_scan.cu``) and their plain
versions.

Not a port of a Pallas kernel: on the TPU the recurrence is a ``lax.scan``
(``mrgan_tpu/models/variant_nets.py:147-169``) that XLA compiles into one
device loop. Eager PyTorch would dispatch ~8 operations per step and
direction, ~20,000 a forward at T = 1,280, so the loop runs inside one
kernel launch per pass: ``lstm_scan_fwd`` (the forward, saving each step's
gates and cell) and ``lstm_scan_bwd`` (backpropagation through time into
the gate gradients). ``ops/lstm.py::LstmScan`` binds both to autograd.
Where the layer's input has one channel, the forward takes x with wx and b
and fuses the input projection: ``xw`` is never made. Each kernel is compiled for a few lanes a sequence row
(``LANES``); the wrapper picks one by the launch's shape
(``default_lanes``), or takes ``lanes=`` to force one. All of them compute
the same sums in the same order.

Built like ``ops/mel_cuda.py``: ``nvcc`` for ``sm_90a`` into
``build/mrgan_tpu_torch/`` at first use, a plain C entry point per kernel,
loaded with ``ctypes``. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. ``fwd_launches`` / ``bwd_launches`` count
the launches.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from . import lstm as lstm_ref
from .mel_cuda import BUILD_DIR, _nvcc

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "lstm_scan.cu"
# the kernels' compile-time unit counts (the iwganlstm critic's biLSTM(4)
# and the lstm classifier's biLSTM(16)) and, for each, the lanes a sequence
# row they are compiled for
LANES = {4: (2, 4), 16: (16,)}
UNITS = tuple(LANES)

fwd_launches = 0   # lstm_scan_fwd launches since the count was last set to 0
bwd_launches = 0   # lstm_scan_bwd launches since the count was last set to 0
build_log = ""     # nvcc's output (-Xptxas -v) from the build, if this process built
_lib = None


def library_path():
    """Where the built library lives, keyed by a hash of the source."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / ("liblstm_scan_%s.so" % digest)


def build():
    """Build the kernels with nvcc for sm_90a if needed; return the loaded
    library. Raises if nvcc is missing or the build fails."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name("%s.%d.tmp" % (so.name, os.getpid()))
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (%d) building %s:\n%s"
                               % (proc.returncode, SOURCE, build_log))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mrgan_lstm_scan_fwd.argtypes = [vp] * 5 + [i32] * 7 + [vp] * 5
    lib.mrgan_lstm_scan_bwd.argtypes = [vp] * 5 + [i32] * 7 + [vp] * 2
    lib.mrgan_lstm_scan_fwd.restype = lib.mrgan_lstm_scan_bwd.restype = i32
    _lib = lib
    return lib


def default_lanes(units, n_seq, rows):
    """The lanes a row the wrapper launches with, the fastest of
    ``chip_smoke.py``'s phase 16 on an H100 (``PERF.md`` §6). At U = 4: 4
    while a launch has few rows (a quarter of a row's step a lane; the
    iwganlstm critic's 12 x 128), 2 from a critic update's 12 x 384 on
    (half the shuffles and warps: the stores' bytes set the pace there).
    At U = 16: 16."""
    if units == 4:
        return 4 if n_seq * rows < 3072 else 2
    return 16


def _check(name, x, shape=None):
    if x.dtype != torch.float32:
        raise TypeError("%s must be float32, got %s" % (name, x.dtype))
    if not x.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError("%s must be %s, got %s" % (name, tuple(shape),
                                                    tuple(x.shape)))


def _aligned(**tensors):
    """The kernels copy and store 16-byte vectors of these."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError("%s must start on a 16-byte boundary" % name)


def _ptr(x):
    return None if x is None else x.data_ptr()


def _call(fn, dev, *args):
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("%s launch failed: CUDA error %d"
                           % (fn.__name__, err))


def _same_device(ref, **tensors):
    for name, t in tensors.items():
        if t is not None and t.device != ref.device:
            raise ValueError("%s lies on %s, the input on %s"
                             % (name, t.device, ref.device))


def _shapes(xw, wh, dirs, x=None, wx=None, b=None):
    """(S, T, B, U) of a forward's input: ``xw`` (S, T, B, 4U), or ``x``
    (F, T, B) with ``wx`` and ``b`` (S = F x dirs, 4U)."""
    if dirs not in (1, 2):
        raise ValueError("dirs must be 1 or 2, got %r" % (dirs,))
    if xw is not None:
        if x is not None or wx is not None or b is not None:
            raise ValueError("give xw, or x with wx and b, not both")
        _check("xw", xw)
        if xw.dim() != 4 or xw.shape[-1] % 4:
            raise ValueError("xw must be (S, T, B, 4U), got %s"
                             % (tuple(xw.shape),))
        n_seq, steps, rows, gates = xw.shape
        if n_seq % dirs:
            raise ValueError("dirs=%d must divide S=%d" % (dirs, n_seq))
        ref = xw
    else:
        if x is None or wx is None or b is None:
            raise ValueError("the input is xw, or x with wx and b")
        _check("x", x)
        if x.dim() != 3:
            raise ValueError("x must be (F, T, B), got %s" % (tuple(x.shape),))
        n_folds, steps, rows = x.shape
        n_seq = n_folds * dirs
        _check("wx", wx)
        if wx.dim() != 2 or wx.shape[0] != n_seq or wx.shape[1] % 4:
            raise ValueError("wx must be (S=%d, 4U), got %s"
                             % (n_seq, tuple(wx.shape)))
        gates = wx.shape[1]
        _check("b", b, (n_seq, gates))
        ref = x
    _check("wh", wh, (n_seq, gates // 4, gates))
    _same_device(ref, wh=wh, wx=wx, b=b)
    return n_seq, steps, rows, gates // 4


def _lanes(units, n_seq, rows, lanes):
    if units not in LANES:
        raise ValueError("the LSTM kernels take U in %s, got %d"
                         % (UNITS, units))
    if lanes is None:
        return default_lanes(units, n_seq, rows)
    if lanes not in LANES[units]:
        raise ValueError("U=%d is compiled for %s lanes a row, got %r"
                         % (units, LANES[units], lanes))
    return lanes


def project(x, wx, b, dirs):
    """The fused input projection's plain version: x (F, T, B) with wx and
    b (S, 4U) -> xw (S, T, B, 4U), as ``x @ wx + b`` rounds it for one
    input channel (one product, then the bias)."""
    xs = x.repeat_interleave(dirs, dim=0).unsqueeze(-1)
    return xs * wx[:, None, None, :] + b[:, None, None, :]


def fwd_reference(xw, wh, dirs, reverse=False, *, x=None, wx=None, b=None):
    """The plain version of ``lstm_scan_fwd`` with everything saved:
    (h (S, T, B, U), h_last (S, B, U), zs (S, T, B, 4U), c (S, T, B, U)),
    time-aligned. The input as :func:`lstm_scan_fwd` takes it."""
    if xw is None:
        xw = project(x, wx, b, dirs)
    rev = lstm_ref.reverse_mask(reverse, xw.shape[0], dirs, xw.device)
    h, zs, c = lstm_ref.scan(lstm_ref.processing_order(xw, rev), wh,
                             record=True)
    order = lambda a: lstm_ref.processing_order(a, rev)  # noqa: E731
    return order(h), h[:, -1], order(zs), order(c)


def lstm_scan_fwd(xw, wh, dirs, reverse=False, sequences=True, save=True, *,
                  x=None, wx=None, b=None, lanes=None):
    """The recurrence over S = folds x dirs sequences in one launch.

    The input is ``xw`` (S, T, B, 4U) float32, the input projection with
    its bias; or, where the layer's input has one channel, ``xw`` None and
    ``x`` (F, T, B) with ``wx`` and ``b`` (S, 4U), S = F x dirs (sequence
    s reads fold s // dirs): the kernel then projects each step itself.
    ``wh`` (S, U, 4U). With dirs = 2, sequence s runs backwards when s is
    odd; with dirs = 1, all follow ``reverse``. ``lanes``: the lanes a row
    (one of ``LANES[U]``; default :func:`default_lanes`). Returns (h,
    h_last, zs, c): h (S, T, B, U) every step's output, time-aligned (None
    unless ``sequences`` or ``save``); h_last (S, B, U) each sequence's
    final state; zs (S, T, B, 4U) the pre-activations of i, f and o with
    tanh(g) in the c slot, and c (S, T, B, U) the cells (both None unless
    ``save``)."""
    n_seq, steps, rows, units = _shapes(xw, wh, dirs, x, wx, b)
    ref = x if xw is None else xw
    if ref.device.type == "cpu":
        h, h_last, zs, c = fwd_reference(xw, wh, dirs, reverse, x=x, wx=wx,
                                         b=b)
        return (h if sequences or save else None, h_last,
                zs if save else None, c if save else None)
    lanes = _lanes(units, n_seq, rows, lanes)
    _aligned(xw=xw)
    global fwd_launches
    lib = build()
    new = lambda *s: torch.empty(s, dtype=torch.float32,  # noqa: E731
                                 device=ref.device)
    h = new(n_seq, steps, rows, units) if sequences or save else None
    h_last = new(n_seq, rows, units)
    zs = new(n_seq, steps, rows, 4 * units) if save else None
    c = new(n_seq, steps, rows, units) if save else None
    if steps and rows:
        _call(lib.mrgan_lstm_scan_fwd, ref.device, _ptr(x), _ptr(wx), _ptr(b),
              _ptr(xw), wh.data_ptr(), n_seq, steps, rows, units, lanes, dirs,
              int(bool(reverse)), _ptr(h), h_last.data_ptr(), _ptr(zs),
              _ptr(c))
        fwd_launches += 1
    else:
        h_last.zero_()
    return h, h_last, zs, c


def bwd_reference(dh_seq, dh_last, zs, c, wh, dirs, reverse=False):
    """The plain version of ``lstm_scan_bwd``: the same walk back through
    time as a Python loop."""
    n_seq, steps, rows, gates = zs.shape
    units = gates // 4
    rev = lstm_ref.reverse_mask(reverse, n_seq, dirs, zs.device)
    order = lambda a: lstm_ref.processing_order(a, rev)  # noqa: E731
    zs_p, c_p = order(zs), order(c)
    dh_p = None if dh_seq is None else order(dh_seq)
    wh_t = wh.transpose(1, 2)
    hs, hsd = lstm_ref.hard_sigmoid, lstm_ref.hard_sigmoid_grad
    dh_rec = zs.new_zeros((n_seq, rows, units))
    dc = torch.zeros_like(dh_rec)
    dz = torch.empty_like(zs_p)
    for p in reversed(range(steps)):
        dh = dh_rec
        if dh_p is not None:
            dh = dh + dh_p[:, p]
        if p == steps - 1 and dh_last is not None:
            dh = dh + dh_last
        zi, zf, g, zo = zs_p[:, p].split(units, dim=-1)
        c_prev = c_p[:, p - 1] if p else torch.zeros_like(dc)
        tc = torch.tanh(c_p[:, p])
        dc = dc + dh * hs(zo) * (1 - tc * tc)
        dz[:, p] = torch.cat([dc * g * hsd(zi), dc * c_prev * hsd(zf),
                              dc * hs(zi) * (1 - g * g),
                              dh * tc * hsd(zo)], dim=-1)
        dc = dc * hs(zf)
        dh_rec = torch.bmm(dz[:, p], wh_t)
    return order(dz)


def lstm_scan_bwd(dh_seq, dh_last, zs, c, wh, dirs, reverse=False, *,
                  lanes=None):
    """Backpropagation through time of :func:`lstm_scan_fwd` in one launch.

    ``dh_seq`` (S, T, B, U) the gradient of every step's output, or None;
    ``dh_last`` (S, B, U) the gradient of the final states, or None; ``zs``,
    ``c`` as the forward saved them; ``wh`` (S, U, 4U); ``lanes`` as the
    forward takes it. Returns dz (S, T, B, 4U), the gradient of each step's
    gate pre-activations, time-aligned: dx, dwx, dwh and db are products of
    it (``ops/lstm.py::LstmScan``)."""
    _check("zs", zs)
    if zs.dim() != 4 or zs.shape[-1] % 4:
        raise ValueError("zs must be (S, T, B, 4U), got %s"
                         % (tuple(zs.shape),))
    n_seq, steps, rows, gates = zs.shape
    units = gates // 4
    if dirs not in (1, 2) or n_seq % dirs:
        raise ValueError("dirs must be 1 or 2 and divide S=%d, got %r"
                         % (n_seq, dirs))
    _check("wh", wh, (n_seq, units, gates))
    _check("c", c, (n_seq, steps, rows, units))
    for name, g, shape in (("dh_seq", dh_seq, (n_seq, steps, rows, units)),
                           ("dh_last", dh_last, (n_seq, rows, units))):
        if g is not None:
            _check(name, g, shape)
    _same_device(zs, c=c, wh=wh, dh_seq=dh_seq, dh_last=dh_last)
    if zs.device.type == "cpu":
        return bwd_reference(dh_seq, dh_last, zs, c, wh, dirs, reverse)
    lanes = _lanes(units, n_seq, rows, lanes)
    _aligned(zs=zs, c=c, dh_seq=dh_seq, dh_last=dh_last)
    global bwd_launches
    lib = build()
    dz = torch.empty_like(zs)
    if steps and rows:
        _call(lib.mrgan_lstm_scan_bwd, zs.device, _ptr(dh_seq), _ptr(dh_last),
              zs.data_ptr(), c.data_ptr(), wh.data_ptr(), n_seq, steps, rows,
              units, lanes, dirs, int(bool(reverse)), dz.data_ptr())
        bwd_launches += 1
    return dz
