"""The Keras-2.0.9 LSTM recurrence, every fold and direction at once.

Port of the ``lax.scan`` in ``mrgan_tpu/models/variant_nets.py:142-185``:
gate order i, f, c, o; ``c = f*c + i*tanh(g)``, ``h = o*tanh(c)``; the
recurrent activation is Keras's ``hard_sigmoid``. A reverse sequence walks
t = T-1 ... 0 and returns time-aligned outputs, and its final state is the
one at t = 0, as ``lax.scan(reverse=True)`` gives them.

Layout: S = folds x directions independent sequences. The input projection
``xw = x @ wx + b`` is one ``torch.matmul`` over all steps, (S, T, B, 4U)
time-major; the recurrence then adds ``h @ wh`` step by step.

On a CPU tensor the recurrence is the plain loop ``lstm_scan_reference``
under autograd. On a CUDA tensor it is ``LstmScan``, whose forward and
backward are the hand-written kernels of ``csrc/lstm_scan.cu``
(``ops/lstm_cuda.py``); the forward fuses the input projection where the
input has one channel, and the input and weight gradients are plain
products of the backward's per-step gate gradients. Both are twice
differentiable, as the Petzka penalty needs: ``LstmScan``'s second
backward runs two more kernels, the backward's adjoint forward in time and
the backward with per-step cotangents entering.
"""

import torch


def hard_sigmoid(x):
    """clip(0.2x + 0.5, 0, 1), written as max then min so that its gradient
    on a clip edge is halved, as ``jax.grad`` of ``jnp.clip`` gives it (0.1
    at x = -2.5 and 2.5)."""
    y = 0.2 * x + 0.5
    return torch.minimum(torch.maximum(y, y.new_zeros(())), y.new_ones(()))


def hard_sigmoid_grad(z):
    """d hard_sigmoid / dz: 0.2 inside, 0.1 on a clip edge, 0 outside, in
    z's type."""
    y = 0.2 * z + 0.5
    inside = torch.where((y > 0) & (y < 1), z.new_tensor(0.2),
                         z.new_tensor(0.0))
    return torch.where((y == 0) | (y == 1), z.new_tensor(0.1), inside)


def reverse_mask(reverse, n_seq, dirs=1, device=None):
    """(S,) bool: which of the S sequences walk backwards. With two
    directions, sequence s = fold * 2 + d runs backwards for d = 1;
    with one, every sequence follows ``reverse``."""
    if dirs == 2:
        return (torch.arange(n_seq, device=device) % 2) == 1
    return torch.full((n_seq,), bool(reverse), device=device)


def processing_order(a, rev):
    """Flip the time axis (1) of the sequences marked in ``rev``: time order
    <-> the order each sequence is walked in (its own inverse)."""
    if not bool(rev.any()):
        return a
    if bool(rev.all()):
        return a.flip(1)
    return torch.where(rev.view(-1, *([1] * (a.dim() - 1))), a.flip(1), a)


def scan(xw_p, wh, record=False):
    """The recurrence over (S, T, B, 4U) inputs in processing order.
    Returns the (S, T, B, U) outputs in processing order, and with
    ``record`` also what the backward reads: the pre-activations of i, f
    and o with tanh(g) between them, (S, T, B, 4U), and the cells c,
    (S, T, B, U)."""
    n_seq, steps, rows, gates = xw_p.shape
    units = gates // 4
    h = xw_p.new_zeros((n_seq, rows, units))
    c = torch.zeros_like(h)
    hs, zs, cs = [], [], []
    for p in range(steps):
        z = xw_p[:, p] + torch.bmm(h, wh)
        zi, zf, zg, zo = z.split(units, dim=-1)
        g = torch.tanh(zg)
        c = hard_sigmoid(zf) * c + hard_sigmoid(zi) * g
        h = hard_sigmoid(zo) * torch.tanh(c)
        hs.append(h)
        if record:
            zs.append(torch.cat([zi, zf, g, zo], dim=-1))
            cs.append(c)
    h_seq = torch.stack(hs, dim=1)
    if not record:
        return h_seq
    return h_seq, torch.stack(zs, dim=1), torch.stack(cs, dim=1)


def lstm_scan_reference(xw, wh, reverse=False, return_sequences=True):
    """The plain recurrence, a Python loop over t: ``xw`` (S, T, B, 4U) the
    input projection with its bias, ``wh`` (S, U, 4U), ``reverse`` a bool or
    an (S,) bool tensor. Returns (S, T, B, U) time-aligned outputs, or the
    final state (S, B, U): at t = T-1, or t = 0 for a reverse sequence."""
    rev = reverse if torch.is_tensor(reverse) else reverse_mask(
        reverse, xw.shape[0], device=xw.device)
    h = scan(processing_order(xw, rev), wh)
    if return_sequences:
        return processing_order(h, rev)
    return h[:, -1]


def _previous(h, rev):
    """h_{t-1} in each sequence's own order, zero before its first step:
    (S, T, B, U) time-aligned."""
    zero = torch.zeros_like(h[:, :1])
    down = torch.cat([zero, h[:, :-1]], dim=1)
    up = torch.cat([h[:, 1:], zero], dim=1)
    return torch.where(rev.view(-1, 1, 1, 1), up, down)


def _seq_weights(wh):
    """(F, dirs, U, 4U) -> (S, U, 4U)."""
    return wh.reshape(-1, *wh.shape[-2:])


def _step_sums(a, dz):
    """sum over the steps of a_{t-1}^T dz_t per sequence, in each
    sequence's own order: (S, T, B, U) and (S, T, B, 4U) -> (S, U, 4U),
    summed over each step's rows, then over the steps (the recurrent
    weights' gradient, with a = h, and its adjoint's, with a = e_bar)."""
    n_seq, steps, rows, units = a.shape
    per_step = torch.bmm(a.reshape(-1, rows, units).transpose(1, 2),
                         dz.reshape(-1, rows, 4 * units))
    return per_step.view(n_seq, steps, units, 4 * units).sum(dim=1)


class _ScanBackward(torch.autograd.Function):
    """The backward kernel as a function of its inputs: (dh_seq, dh_last,
    zs, c, wh) -> dz, with optional per-step cotangents ``dzs`` / ``dcs``
    entering (what the forward's backward receives in a double backward).
    Without them, and unless ``twice`` (it is itself to be differentiated),
    it is ``lstm_scan_bwd``; otherwise ``lstm_scan_bwd_ext``, which with
    ``twice`` also stores the carries its own backward, ``lstm_scan_adj``,
    reads."""

    @staticmethod
    def forward(ctx, dh_seq, dh_last, zs, c, wh, dzs, dcs, dirs, reverse,
                twice):
        from . import lstm_cuda

        ctx.set_materialize_grads(False)
        if dzs is None and dcs is None and not twice:
            return lstm_cuda.lstm_scan_bwd(dh_seq, dh_last, zs, c, wh, dirs,
                                           reverse)
        dz, e, k = lstm_cuda.lstm_scan_bwd_ext(
            dh_seq, dh_last, zs, c, wh, dirs, reverse, dzs=dzs, dcs=dcs,
            carries=twice)
        if twice:
            if dzs is not None or dcs is not None:
                raise NotImplementedError("the recurrence is twice "
                                          "differentiable, not three times")
            ctx.save_for_backward(zs, c, wh, e, k, dz)
            ctx.dirs, ctx.reverse = dirs, reverse
        return dz

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ddz):
        from . import lstm_cuda

        if ddz is None:
            return (None,) * 10
        zs, c, wh, e, k, dz = ctx.saved_tensors
        e_bar, zs_bar, c_bar = lstm_cuda.lstm_scan_adj(
            ddz.contiguous(), zs, c, e, k, wh, ctx.dirs, ctx.reverse)
        rev = reverse_mask(ctx.reverse, zs.shape[0], ctx.dirs, zs.device)
        need = ctx.needs_input_grad
        return (e_bar if need[0] else None,
                processing_order(e_bar, rev)[:, -1] if need[1] else None,
                zs_bar, c_bar,
                _step_sums(_previous(e_bar, rev), dz) if need[4] else None,
                None, None, None, None, None)


class _ScanForward(torch.autograd.Function):
    """The forward kernel with everything it saves as outputs: (x, wx, wh,
    b) -> (h, h_last, zs, c), S = F x dirs sequences. Its backward runs
    :class:`_ScanBackward` and takes dx, dwx, dwh and db as products of dz
    (``torch.einsum`` and ``torch.bmm``: fixed order, no atomics), all of
    which autograd differentiates again: under ``create_graph`` the
    backward is recorded, and its gradient reaches the saved gates and
    cells as cotangents on these outputs, which the backward then takes in
    (``lstm_scan_bwd_ext``)."""

    @staticmethod
    def forward(ctx, x, wx, wh, b, dirs, reverse):
        from . import lstm_cuda

        ctx.set_materialize_grads(False)
        h, h_last, zs, c = lstm_cuda.lstm_scan_fwd(
            wh=_seq_weights(wh), dirs=dirs, reverse=reverse,
            **_fwd_inputs(x, wx, b, dirs))
        ctx.dirs, ctx.reverse = dirs, reverse
        ctx.save_for_backward(x, wx, wh, h, zs, c)
        return h, h_last, zs, c

    @staticmethod
    def backward(ctx, dh, dh_last, dzs, dcs):
        x, wx, wh, h, zs, c = ctx.saved_tensors
        n_seq, steps, rows, units = h.shape
        n_folds, dirs = wx.shape[:2]
        if dh is None and dh_last is None and dzs is None and dcs is None:
            return (None,) * 6
        # under create_graph this backward is recorded, to be differentiated
        twice = torch.is_grad_enabled() and any(
            t.requires_grad for t in (dh, dh_last, zs, c, wh)
            if t is not None)
        dz = _ScanBackward.apply(
            None if dh is None else dh.contiguous(),
            None if dh_last is None else dh_last.contiguous(), zs, c,
            _seq_weights(wh), None if dzs is None else dzs.contiguous(),
            None if dcs is None else dcs.contiguous(), dirs, ctx.reverse,
            twice)
        dz5 = dz.view(n_folds, dirs, steps, rows, 4 * units)
        dx = dwx = dwh = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.einsum("fdtbg,fdig->ftbi", dz5, wx)
        # the weight gradients are sums over all T x B steps and rows, taken
        # in two levels: over the rows of each step, then over the steps
        if ctx.needs_input_grad[1]:
            dwx = torch.einsum("ftbi,fdtbg->fdtig", x, dz5).sum(dim=2)
        if ctx.needs_input_grad[2]:
            rev = reverse_mask(ctx.reverse, n_seq, dirs, h.device)
            dwh = _step_sums(_previous(h, rev), dz).view(wh.shape)
        if ctx.needs_input_grad[3]:
            db = dz5.sum(dim=3).sum(dim=2)
        return dx, dwx, dwh, db, None, None


def _fwd_inputs(x, wx, b, dirs):
    """The forward kernel's input: x, wx and b where in = 1 (it projects
    each step itself), else ``xw = x @ wx + b`` by one ``torch.matmul``."""
    n_folds, steps, rows, in_dim = x.shape
    gates = wx.shape[-1]
    if in_dim == 1:
        return dict(xw=None, x=x.view(n_folds, steps, rows),
                    wx=wx.reshape(n_folds * dirs, gates).contiguous(),
                    b=b.reshape(n_folds * dirs, gates).contiguous())
    xw = torch.matmul(x.unsqueeze(1), wx.unsqueeze(2)) + b[:, :, None, None]
    return dict(xw=xw.reshape(n_folds * dirs, steps, rows, gates))


class LstmScan:
    """The recurrence of F folds x ``dirs`` directions through the kernels.

    ``LstmScan.apply(x, wx, wh, b, dirs, reverse, return_sequences)``:
    ``x`` (F, T, B, in) time-major, ``wx`` (F, dirs, in, 4U), ``wh`` (F,
    dirs, U, 4U), ``b`` (F, dirs, 4U). Output: (F, dirs, T, B, U), or the
    final states (F, dirs, B, U). Where in = 1 the forward kernel takes x,
    wx and b and projects each step itself; otherwise ``xw = x @ wx + b``
    is one ``torch.matmul``. With a gradient to take, the forward kernel
    saves each step's gates and cell; the backward kernel walks them back
    into the gate gradients dz (S, T, B, 4U), and dx, dwx, dwh and db are
    products of dz. Twice differentiable: under ``create_graph`` the
    backward is recorded, and a second backward runs ``lstm_scan_adj`` and
    ``lstm_scan_bwd_ext`` (``ops/lstm_cuda.py``). On a CPU tensor the
    wrappers run the kernels' plain versions."""

    @staticmethod
    def apply(x, wx, wh, b, dirs, reverse, return_sequences):
        from . import lstm_cuda

        n_folds, steps, rows, _ = x.shape
        units = wh.shape[-2]
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, wx, wh, b)):
            h, h_last, _, _ = _ScanForward.apply(x, wx, wh, b, dirs, reverse)
        else:
            h, h_last, _, _ = lstm_cuda.lstm_scan_fwd(
                wh=_seq_weights(wh), dirs=dirs, reverse=reverse,
                sequences=return_sequences, save=False,
                **_fwd_inputs(x, wx, b, dirs))
        if return_sequences:
            return h.view(n_folds, dirs, steps, rows, units)
        return h_last.view(n_folds, dirs, rows, units)


def _layer(wx, wh, b, xs, dirs, reverse, return_sequences, plain):
    """(F, B, T, in) through stacked (F, dirs, ...) weights -> (F, B, T,
    dirs*U) with the directions' outputs side by side, or (F, B, dirs*U):
    the plain loop under autograd, or ``LstmScan``."""
    x = xs.transpose(1, 2)  # (F, T, B, in)
    n_folds, steps, rows, _ = x.shape
    units = wh.shape[-2]
    if plain:
        n_seq = n_folds * dirs
        xw = torch.matmul(x.unsqueeze(1), wx.unsqueeze(2)) + b[:, :, None, None]
        rev = reverse_mask(reverse, n_seq, dirs, xs.device)
        h = lstm_scan_reference(xw.reshape(n_seq, steps, rows, 4 * units),
                                wh.reshape(n_seq, units, 4 * units), rev,
                                return_sequences)
        h = h.view(n_folds, dirs, *h.shape[1:])
    else:
        h = LstmScan.apply(x.contiguous(), wx, wh, b, dirs, reverse,
                           return_sequences)
    if return_sequences:  # (F, dirs, T, B, U) -> (F, B, T, dirs * U)
        return h.permute(0, 3, 2, 1, 4).reshape(n_folds, rows, steps, -1)
    return h.permute(0, 2, 1, 3).reshape(n_folds, rows, -1)


def lstm(params, xs, reverse=False, return_sequences=True):
    """One direction: ``params`` {"wx" (F, in, 4U), "wh" (F, U, 4U), "b"
    (F, 4U)}, ``xs`` (F, B, T, in) -> (F, B, T, U) or (F, B, U)."""
    return _layer(params["wx"].unsqueeze(1), params["wh"].unsqueeze(1),
                  params["b"].unsqueeze(1), xs, 1, reverse, return_sequences,
                  xs.device.type == "cpu")


def _both(params):
    return [torch.stack([params["fwd"][k], params["bwd"][k]], dim=1)
            for k in ("wx", "wh", "b")]


def bilstm(params, xs, return_sequences=True):
    """Both directions in one scan: ``params`` {"fwd", "bwd"} of
    :func:`lstm`'s, ``xs`` (F, B, T, in) -> [forward | backward] outputs,
    (F, B, T, 2U) or (F, B, 2U). The kernels on a CUDA tensor, the plain
    loop on a CPU tensor."""
    return _layer(*_both(params), xs, 2, False, return_sequences,
                  xs.device.type == "cpu")


def bilstm_reference(params, xs, return_sequences=True):
    """:func:`bilstm` through the plain loop on any device: what the
    kernels are held to on the card."""
    return _layer(*_both(params), xs, 2, False, return_sequences, True)
