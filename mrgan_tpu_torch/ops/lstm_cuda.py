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

A double backward (the Petzka penalty with the biLSTM critic) runs two
more kernels of the same source and design (the same lanes-a-row
variants, step inputs staged by ``cp.async``): ``lstm_scan_bwd_ext``,
the backward kernel compiled with per-step cotangents on the saved gates
and cells added (or its carries stored for ``lstm_scan_adj``), and
``lstm_scan_adj``, the backward's own VJP, a recurrence forward in time
over the adjoints of the backward's carries.

Built like ``ops/mel_cuda.py``: ``nvcc`` for ``sm_90a`` into
``build/mrgan_tpu_torch/`` at first use, a plain C entry point per kernel,
loaded with ``ctypes``. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. ``fwd_launches`` / ``bwd_launches`` / ``ext_launches`` /
``adj_launches`` count the launches. On the CPU the plain versions also
take float64 (every tensor of a call in one type), for gradient checks.
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
ext_launches = 0   # lstm_scan_bwd_ext launches, likewise
adj_launches = 0   # lstm_scan_adj launches, likewise
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
    lib.mrgan_lstm_scan_bwd_ext.argtypes = [vp] * 7 + [i32] * 7 + [vp] * 4
    lib.mrgan_lstm_scan_adj.argtypes = [vp] * 6 + [i32] * 7 + [vp] * 4
    for fn in (lib.mrgan_lstm_scan_fwd, lib.mrgan_lstm_scan_bwd,
               lib.mrgan_lstm_scan_bwd_ext, lib.mrgan_lstm_scan_adj):
        fn.restype = i32
    _lib = lib
    return lib


def default_lanes(units, n_seq, rows):
    """The lanes a row the wrapper launches with, the fastest of
    ``chip_smoke.py``'s phases 16 and 31 on an H100 (``PERF.md`` §6), for
    the first order and the second alike. At U = 4: 4 while a launch has
    few rows (a quarter of a row's step a lane; the iwganlstm critic's and
    the Petzka penalty's 12 x 128), 2 from a critic update's 12 x 384 on
    (half the shuffles and warps: the stores' bytes set the pace there).
    At U = 16: 16."""
    if units == 4:
        return 4 if n_seq * rows < 3072 else 2
    return 16


def _dtype(ref):
    """The type every tensor of a call takes: float32, or float64 where the
    call's reference input is a float64 CPU tensor (the plain versions)."""
    if ref.device.type == "cpu" and ref.dtype == torch.float64:
        return torch.float64
    return torch.float32


def _check(name, x, shape=None, dtype=torch.float32):
    if x.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, x.dtype))
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
        dtype = _dtype(xw)
        _check("xw", xw, dtype=dtype)
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
        dtype = _dtype(x)
        _check("x", x, dtype=dtype)
        if x.dim() != 3:
            raise ValueError("x must be (F, T, B), got %s" % (tuple(x.shape),))
        n_folds, steps, rows = x.shape
        n_seq = n_folds * dirs
        _check("wx", wx, dtype=dtype)
        if wx.dim() != 2 or wx.shape[0] != n_seq or wx.shape[1] % 4:
            raise ValueError("wx must be (S=%d, 4U), got %s"
                             % (n_seq, tuple(wx.shape)))
        gates = wx.shape[1]
        _check("b", b, (n_seq, gates), dtype)
        ref = x
    _check("wh", wh, (n_seq, gates // 4, gates), dtype)
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


def bwd_ext_reference(dh_seq, dh_last, zs, c, wh, dirs, reverse=False,
                      dzs=None, dcs=None, carries=False):
    """The plain version of ``lstm_scan_bwd_ext`` (and, without ``dzs``,
    ``dcs`` and ``carries``, of ``lstm_scan_bwd``): the walk back through
    time as a Python loop. Returns (dz, e, k), e and k None unless
    ``carries``."""
    n_seq, steps, rows, gates = zs.shape
    units = gates // 4
    rev = lstm_ref.reverse_mask(reverse, n_seq, dirs, zs.device)
    order = lambda a: lstm_ref.processing_order(a, rev)  # noqa: E731
    zs_p, c_p = order(zs), order(c)
    dh_p = None if dh_seq is None else order(dh_seq)
    dzs_p = None if dzs is None else order(dzs)
    dcs_p = None if dcs is None else order(dcs)
    wh_t = wh.transpose(1, 2)
    hs, hsd = lstm_ref.hard_sigmoid, lstm_ref.hard_sigmoid_grad
    dh_rec = zs.new_zeros((n_seq, rows, units))
    dc = torch.zeros_like(dh_rec)
    dz = torch.empty_like(zs_p)
    e = torch.empty_like(c_p) if carries else None
    k = torch.empty_like(c_p) if carries else None
    for p in reversed(range(steps)):
        dh = dh_rec
        if dh_p is not None:
            dh = dh + dh_p[:, p]
        if p == steps - 1 and dh_last is not None:
            dh = dh + dh_last
        zi, zf, g, zo = zs_p[:, p].split(units, dim=-1)
        c_prev = c_p[:, p - 1] if p else torch.zeros_like(dc)
        tc = torch.tanh(c_p[:, p])
        if dcs_p is not None:
            dc = dc + dcs_p[:, p]
        dc = dc + dh * hs(zo) * (1 - tc * tc)
        d = [dc * g * hsd(zi), dc * c_prev * hsd(zf), dc * hs(zi),
             dh * tc * hsd(zo)]
        if dzs_p is not None:
            d = [a + b for a, b in zip(d, dzs_p[:, p].split(units, dim=-1))]
        d[2] = d[2] * (1 - g * g)
        dz[:, p] = torch.cat(d, dim=-1)
        if carries:
            e[:, p], k[:, p] = dh, dc
        dc = dc * hs(zf)
        dh_rec = torch.bmm(dz[:, p], wh_t)
    return (order(dz), None if e is None else order(e),
            None if k is None else order(k))


def bwd_reference(dh_seq, dh_last, zs, c, wh, dirs, reverse=False):
    """The plain version of ``lstm_scan_bwd``: the same walk back through
    time as a Python loop."""
    return bwd_ext_reference(dh_seq, dh_last, zs, c, wh, dirs, reverse)[0]


def _saved_shapes(zs, c, wh, dirs, **per_step):
    """(S, T, B, U) of a backward's saved ``zs`` (S, T, B, 4U), checking
    ``c``, ``wh`` and the optional inputs: "dh_last" (S, B, U), those
    named "dzs" or "delta" (S, T, B, 4U), the others (S, T, B, U)."""
    dtype = _dtype(zs)
    _check("zs", zs, dtype=dtype)
    if zs.dim() != 4 or zs.shape[-1] % 4:
        raise ValueError("zs must be (S, T, B, 4U), got %s"
                         % (tuple(zs.shape),))
    n_seq, steps, rows, gates = zs.shape
    units = gates // 4
    if dirs not in (1, 2) or n_seq % dirs:
        raise ValueError("dirs must be 1 or 2 and divide S=%d, got %r"
                         % (n_seq, dirs))
    _check("wh", wh, (n_seq, units, gates), dtype)
    _check("c", c, (n_seq, steps, rows, units), dtype)
    for name, g in per_step.items():
        if g is None:
            continue
        shape = ((n_seq, rows, units) if name == "dh_last" else
                 (n_seq, steps, rows, gates if name in ("dzs", "delta")
                  else units))
        _check(name, g, shape, dtype)
    _same_device(zs, c=c, wh=wh, **per_step)
    return n_seq, steps, rows, units


def lstm_scan_bwd(dh_seq, dh_last, zs, c, wh, dirs, reverse=False, *,
                  lanes=None):
    """Backpropagation through time of :func:`lstm_scan_fwd` in one launch.

    ``dh_seq`` (S, T, B, U) the gradient of every step's output, or None;
    ``dh_last`` (S, B, U) the gradient of the final states, or None; ``zs``,
    ``c`` as the forward saved them; ``wh`` (S, U, 4U); ``lanes`` as the
    forward takes it. Returns dz (S, T, B, 4U), the gradient of each step's
    gate pre-activations, time-aligned: dx, dwx, dwh and db are products of
    it (``ops/lstm.py::LstmScan``)."""
    n_seq, steps, rows, units = _saved_shapes(
        zs, c, wh, dirs, dh_seq=dh_seq, dh_last=dh_last)
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


def lstm_scan_bwd_ext(dh_seq, dh_last, zs, c, wh, dirs, reverse=False, *,
                      dzs=None, dcs=None, carries=False, lanes=None):
    """:func:`lstm_scan_bwd` with per-step cotangents entering: ``dzs``
    (S, T, B, 4U) on the saved zi, zf, tanh(g) and zo, ``dcs`` (S, T, B,
    U) on the cells, either may be None; with ``carries`` the backward's
    output gradient e and cell gradient k of every step are stored too.
    ``lanes`` as :func:`lstm_scan_bwd` takes it. Returns (dz, e, k),
    time-aligned, e and k (S, T, B, U) or None. One launch of the backward
    kernel compiled for what is given (``ext_launches`` counts it); without
    ``dzs`` and ``dcs`` its dz is :func:`lstm_scan_bwd`'s bit for bit."""
    n_seq, steps, rows, units = _saved_shapes(
        zs, c, wh, dirs, dh_seq=dh_seq, dh_last=dh_last, dzs=dzs, dcs=dcs)
    if zs.device.type == "cpu":
        return bwd_ext_reference(dh_seq, dh_last, zs, c, wh, dirs, reverse,
                                 dzs, dcs, carries)
    lanes = _lanes(units, n_seq, rows, lanes)
    _aligned(zs=zs, c=c, dh_seq=dh_seq, dh_last=dh_last, dzs=dzs, dcs=dcs)
    global ext_launches
    lib = build()
    dz = torch.empty_like(zs)
    e = torch.empty_like(c) if carries else None
    k = torch.empty_like(c) if carries else None
    if steps and rows:
        _call(lib.mrgan_lstm_scan_bwd_ext, zs.device, _ptr(dh_seq),
              _ptr(dh_last), zs.data_ptr(), c.data_ptr(), wh.data_ptr(),
              _ptr(dzs), _ptr(dcs), n_seq, steps, rows, units, lanes, dirs,
              int(bool(reverse)), dz.data_ptr(), _ptr(e), _ptr(k))
        ext_launches += 1
    return dz, e, k


def adj_reference(delta, zs, c, e, k, wh, dirs, reverse=False):
    """The plain version of ``lstm_scan_adj``: the VJP of the backward
    (without cotangents entering) as a Python loop forward in time.
    Returns (e_bar, zs_bar, c_bar), time-aligned."""
    n_seq, steps, rows, gates = zs.shape
    units = gates // 4
    rev = lstm_ref.reverse_mask(reverse, n_seq, dirs, zs.device)
    order = lambda a: lstm_ref.processing_order(a, rev)  # noqa: E731
    delta_p, zs_p, c_p, e_p, k_p = map(order, (delta, zs, c, e, k))
    hs, hsd = lstm_ref.hard_sigmoid, lstm_ref.hard_sigmoid_grad
    e_bar = torch.empty_like(c_p)
    zs_bar = torch.empty_like(zs_p)
    c_bar = torch.zeros_like(c_p)
    eb = zs.new_zeros((n_seq, rows, units))
    kb = torch.zeros_like(eb)
    for p in range(steps):
        D = (delta_p[:, p] + torch.bmm(eb, wh)).split(units, dim=-1)
        zi, zf, g, zo = zs_p[:, p].split(units, dim=-1)
        c_prev = c_p[:, p - 1] if p else torch.zeros_like(eb)
        e, k = e_p[:, p], k_p[:, p]
        tc = torch.tanh(c_p[:, p])
        dtc, dtg = 1 - tc * tc, 1 - g * g
        kb_new = (kb * hs(zf) + D[0] * g * hsd(zi) + D[1] * c_prev * hsd(zf)
                  + D[2] * hs(zi) * dtg)
        eb = kb_new * hs(zo) * dtc + D[3] * tc * hsd(zo)
        zs_bar[:, p] = torch.cat([
            D[2] * k * dtg * hsd(zi), kb * k * hsd(zf),
            D[0] * k * hsd(zi) - 2 * g * D[2] * k * hs(zi),
            kb_new * e * dtc * hsd(zo)], dim=-1)
        c_bar[:, p] += dtc * (D[3] * e * hsd(zo) - 2 * tc * kb_new * e * hs(zo))
        if p:
            c_bar[:, p - 1] += D[1] * k * hsd(zf)
        e_bar[:, p] = eb
        kb = kb_new
    return order(e_bar), order(zs_bar), order(c_bar)


def lstm_scan_adj(delta, zs, c, e, k, wh, dirs, reverse=False, *,
                  lanes=None):
    """The VJP of :func:`lstm_scan_bwd` in one launch, a recurrence forward
    in time: ``delta`` (S, T, B, 4U) the cotangent on dz; ``zs``, ``c``
    as the forward saved them; ``e``, ``k`` the backward's carries
    (:func:`lstm_scan_bwd_ext` with ``carries``); ``wh`` (S, U, 4U);
    ``lanes`` as :func:`lstm_scan_bwd` takes it. Returns (e_bar, zs_bar,
    c_bar), time-aligned: the cotangent on e (the incoming output
    gradients; with dz it also gives the recurrent weights',
    ``ops/lstm.py``), on the saved gates (S, T, B, 4U) and on the cells
    (S, T, B, U)."""
    n_seq, steps, rows, units = _saved_shapes(zs, c, wh, dirs, delta=delta,
                                              e=e, k=k)
    if zs.device.type == "cpu":
        return adj_reference(delta, zs, c, e, k, wh, dirs, reverse)
    lanes = _lanes(units, n_seq, rows, lanes)
    _aligned(delta=delta, zs=zs, c=c, e=e, k=k)
    global adj_launches
    lib = build()
    e_bar, zs_bar, c_bar = (torch.empty_like(t) for t in (c, zs, c))
    if steps and rows:
        _call(lib.mrgan_lstm_scan_adj, zs.device, delta.data_ptr(),
              zs.data_ptr(), c.data_ptr(), e.data_ptr(), k.data_ptr(),
              wh.data_ptr(), n_seq, steps, rows, units, lanes, dirs,
              int(bool(reverse)), e_bar.data_ptr(), zs_bar.data_ptr(),
              c_bar.data_ptr())
        adj_launches += 1
    return e_bar, zs_bar, c_bar
