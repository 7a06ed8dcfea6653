"""The port's Keras-semantics LSTM recurrence (ops/lstm.py, the plain
versions of the kernels in ops/lstm_cuda.py) vs the JAX package's lax.scan
(mrgan_tpu/models/variant_nets.py), on the CPU: outputs and gradients, both
directions, with and without return_sequences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrgan_tpu.models import variant_nets as jax_vnets
from mrgan_tpu_torch.models import variant_nets as vnets
from mrgan_tpu_torch.ops import lstm, lstm_cuda

T, B, U = 37, 5, 3
TOL = 1e-5  # fp32: the scan's sums run in another order than XLA's


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _folds(init, n_folds, *args):
    """n_folds JAX parameter trees (numpy) and the port's fold-stacked one."""
    trees = [_np(init(jax.random.PRNGKey(10 + f), *args))
             for f in range(n_folds)]
    stacked = jax.tree.map(lambda *a: np.stack(a), *trees)
    return trees, vnets.params_from_jax(stacked)


def _inputs(n_folds, in_dim, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n_folds, B, T, in_dim).astype(np.float32)
    return xs, rng


def _grads_vs_jax(jax_fn, port_fn, trees, params, xs, out_shape, rng):
    """Outputs and the gradients of sum(out * w) w.r.t. every parameter and
    the input, the port's against jax.grad per fold."""
    w = rng.randn(*out_shape).astype(np.float32)
    p = jax.tree.map(lambda a: a.detach().requires_grad_(), params)
    x = torch.tensor(xs, requires_grad=True)
    out = port_fn(p, x)
    leaves = jax.tree.leaves(p)
    grads = torch.autograd.grad((out * torch.tensor(w)).sum(), [x] + leaves)
    gx, gp = grads[0], jax.tree.unflatten(jax.tree.structure(p), grads[1:])
    @jax.jit
    def reference(tree, x, w):
        want, vjp = jax.vjp(jax_fn, tree, x)
        return (want, *vjp(w))

    for f, tree in enumerate(trees):
        want, jgp, jgx = reference(tree, xs[f], w[f])
        np.testing.assert_allclose(out[f].detach().numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(gx[f].numpy(), np.asarray(jgx), rtol=TOL,
                                   atol=TOL)
        for got, ref in zip(jax.tree.leaves(gp), jax.tree.leaves(jgp)):
            np.testing.assert_allclose(got[f].numpy(), np.asarray(ref),
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("in_dim", [1, 6])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("return_sequences", [True, False])
def test_lstm_matches_jax(in_dim, reverse, return_sequences):
    trees, params = _folds(jax_vnets.lstm_init, 2, in_dim, U)
    xs, rng = _inputs(2, in_dim)
    shape = (2, B, T, U) if return_sequences else (2, B, U)
    _grads_vs_jax(
        lambda t, x: jax_vnets.lstm_apply(t, x, reverse, return_sequences),
        lambda p, x: vnets.lstm_apply(p, x, reverse, return_sequences),
        trees, params, xs, shape, rng)


@pytest.mark.parametrize("in_dim", [1, 6])
@pytest.mark.parametrize("return_sequences", [True, False])
def test_bilstm_matches_jax(in_dim, return_sequences):
    trees, params = _folds(jax_vnets.bilstm_init, 2, in_dim, U)
    xs, rng = _inputs(2, in_dim, seed=1)
    shape = (2, B, T, 2 * U) if return_sequences else (2, B, 2 * U)
    _grads_vs_jax(
        lambda t, x: jax_vnets.bilstm_apply(t, x, return_sequences),
        lambda p, x: vnets.bilstm_apply(p, x, return_sequences),
        trees, params, xs, shape, rng)


def _through_kernels(params, xs, dirs, reverse, return_sequences):
    """The LstmScan Function (the kernels' plain versions on the CPU),
    laid out like ops.lstm._layer's result."""
    if dirs == 2:
        w = lstm._both(params)
    else:
        w = [params[k].unsqueeze(1) for k in ("wx", "wh", "b")]
    h = lstm.LstmScan.apply(xs.transpose(1, 2).contiguous(), *w, dirs,
                            reverse, return_sequences)
    n_folds = xs.shape[0]
    if return_sequences:
        return h.permute(0, 3, 2, 1, 4).reshape(n_folds, B, T, -1)
    return h.permute(0, 2, 1, 3).reshape(n_folds, B, -1)


@pytest.mark.parametrize("in_dim", [1, 6])
@pytest.mark.parametrize("return_sequences", [True, False])
def test_kernel_function_matches_jax(in_dim, return_sequences):
    """The autograd Function whose forward and backward are the kernels on
    the card: the plain versions of both kernels, the products of dz
    outside them, against jax.grad."""
    trees, params = _folds(jax_vnets.bilstm_init, 2, in_dim, U)
    xs, rng = _inputs(2, in_dim, seed=2)
    shape = (2, B, T, 2 * U) if return_sequences else (2, B, 2 * U)
    _grads_vs_jax(
        lambda t, x: jax_vnets.bilstm_apply(t, x, return_sequences),
        lambda p, x: _through_kernels(p, x, 2, False, return_sequences),
        trees, params, xs, shape, rng)
    trees, params = _folds(jax_vnets.lstm_init, 1, in_dim, U)
    _grads_vs_jax(
        lambda t, x: jax_vnets.lstm_apply(t, x, True, return_sequences),
        lambda p, x: _through_kernels(p, x, 1, True, return_sequences),
        trees, params, xs[:1], (1,) + shape[1:-1] + (U,), rng)


@pytest.mark.parametrize("x", [-2.5, 2.5, 0.0, 2.4, -3.0, 3.0])
def test_hard_sigmoid_gradient_matches_jax_at_the_clip_edges(x):
    want = float(jax.grad(jax_vnets.hard_sigmoid)(jnp.float32(x)))
    t = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    lstm.hard_sigmoid(t).backward()
    assert t.grad.item() == want
    # the rule the backward kernel (and its plain version) applies
    assert lstm.hard_sigmoid_grad(torch.tensor(x)).item() == want
    if x in (-2.5, 2.5):
        assert want == pytest.approx(0.1)


def test_plain_kernel_versions_agree_with_autograd():
    """lstm_scan_bwd's plain version on both gradient inputs at once, a
    mixed batch of directions, against autograd of the plain loop."""
    rng = np.random.RandomState(3)
    n_seq, units = 4, 2
    xw = torch.tensor(rng.randn(n_seq, T, B, 4 * units).astype(np.float32),
                      requires_grad=True)
    wh = torch.tensor(rng.randn(n_seq, units, 4 * units).astype(np.float32))
    h, h_last, zs, c = lstm_cuda.lstm_scan_fwd(xw.detach(), wh, dirs=2)
    rev = lstm.reverse_mask(False, n_seq, 2)
    want = lstm.lstm_scan_reference(xw, wh, rev, True)
    np.testing.assert_array_equal(h.numpy(), want.detach().numpy())
    np.testing.assert_array_equal(
        h_last.numpy(),
        lstm.lstm_scan_reference(xw, wh, rev, False).detach().numpy())
    dh_seq = torch.tensor(rng.randn(*h.shape).astype(np.float32))
    dh_last = torch.tensor(rng.randn(*h_last.shape).astype(np.float32))
    loss = (want * dh_seq).sum() + (
        lstm.lstm_scan_reference(xw, wh, rev, False) * dh_last).sum()
    want_dz, = torch.autograd.grad(loss, xw)
    dz = lstm_cuda.lstm_scan_bwd(dh_seq, dh_last, zs, c, wh, dirs=2)
    np.testing.assert_allclose(dz.numpy(), want_dz.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_wrappers_check_their_inputs_and_never_fall_back():
    xw = torch.zeros((2, T, B, 16))
    wh = torch.zeros((2, 4, 16))
    with pytest.raises(TypeError):
        lstm_cuda.lstm_scan_fwd(xw.double(), wh, 2)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_scan_fwd(xw, torch.zeros((2, 4, 12)), 2)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_scan_fwd(xw, wh, 3)
    # a tensor off the CPU goes to the kernel, which this machine cannot
    # build: it raises rather than running the plain loop
    with pytest.raises(RuntimeError, match="nvcc"):
        lstm_cuda.lstm_scan_fwd(xw.to("meta"), wh.to("meta"), 2)
    assert lstm_cuda.fwd_launches == lstm_cuda.bwd_launches == 0


def _fused_vs_jax(jax_fn, trees, xs, dirs, reverse, return_sequences, rng):
    """The fused (in = 1) plain version of the forward kernel, called as the
    wrapper takes it (x, wx, b), and the backward's on what it saved,
    against jax.vjp of ``jax_fn``: the outputs, and dx, dwx, dwh and db as
    ``LstmScan`` takes them from dz."""
    n_folds = len(trees)
    order = ("fwd", "bwd") if dirs == 2 else (None,)

    def leaf(tree, d, k):
        return tree[d][k] if d else tree[k]

    stack = lambda k: torch.tensor(np.stack(  # noqa: E731
        [leaf(t, d, k) for t in trees for d in order]))
    wx, wh, b = stack("wx")[:, 0], stack("wh"), stack("b")
    x = torch.tensor(xs[..., 0]).transpose(1, 2).contiguous()  # (F, T, B)
    h, h_last, zs, c = lstm_cuda.lstm_scan_fwd(None, wh, dirs, reverse,
                                               x=x, wx=wx, b=b)
    n_seq = n_folds * dirs
    want_shape = (n_folds, B, T, dirs * U) if return_sequences else (
        n_folds, B, dirs * U)
    w = rng.randn(*want_shape).astype(np.float32)
    if return_sequences:
        got = h.view(n_folds, dirs, T, B, U).permute(0, 3, 2, 1, 4)
        dh = torch.tensor(w).view(n_folds, B, T, dirs, U).permute(
            0, 3, 2, 1, 4).reshape(n_seq, T, B, U).contiguous()
        args = (dh, None)
    else:
        got = h_last.view(n_folds, dirs, B, U).permute(0, 2, 1, 3)
        dh = torch.tensor(w).view(n_folds, B, dirs, U).permute(
            0, 2, 1, 3).reshape(n_seq, B, U).contiguous()
        args = (None, dh)
    dz = lstm_cuda.lstm_scan_bwd(*args, zs, c, wh, dirs, reverse)
    dx = torch.einsum("fdtbg,fdg->fbt", dz.view(n_folds, dirs, T, B, 4 * U),
                      wx.view(n_folds, dirs, 4 * U))
    rev = lstm.reverse_mask(reverse, n_seq, dirs)
    h_prev = lstm._previous(h, rev)
    dwh = torch.einsum("stbu,stbg->sug", h_prev, dz)
    dwx = torch.einsum("ftb,fdtbg->fdg", x,
                       dz.view(n_folds, dirs, T, B, 4 * U)).reshape(n_seq, -1)
    db = dz.sum(dim=(1, 2))

    @jax.jit
    def reference(tree, x, w):
        want, vjp = jax.vjp(jax_fn, tree, x)
        return (want, *vjp(w))

    for f, tree in enumerate(trees):
        want, jgp, jgx = reference(tree, xs[f], w[f])
        np.testing.assert_allclose(
            got[f].reshape(want.shape).numpy(), np.asarray(want), rtol=TOL,
            atol=TOL)
        np.testing.assert_allclose(dx[f].numpy(), np.asarray(jgx)[..., 0],
                                   rtol=TOL, atol=TOL)
        for i, d in enumerate(order):
            s = f * dirs + i
            for name, g in (("wx", dwx[s][None]), ("wh", dwh[s]),
                            ("b", db[s])):
                np.testing.assert_allclose(
                    g.numpy(), np.asarray(leaf(jgp, d, name)), rtol=TOL,
                    atol=TOL, err_msg="%s %s" % (d, name))


@pytest.mark.parametrize("dirs,reverse", [(1, False), (1, True), (2, False)])
@pytest.mark.parametrize("return_sequences", [True, False])
def test_fused_plain_versions_match_jax(dirs, reverse, return_sequences):
    """Where the input has one channel the forward kernel takes x, wx and
    b: its plain version, and the backward's, against lstm_apply /
    bilstm_apply and jax.grad."""
    rng = np.random.RandomState(4)
    xs = rng.randn(2, B, T, 1).astype(np.float32)
    if dirs == 2:
        trees, _ = _folds(jax_vnets.bilstm_init, 2, 1, U)
        fn = lambda t, x: jax_vnets.bilstm_apply(t, x, return_sequences)  # noqa: E731
    else:
        trees, _ = _folds(jax_vnets.lstm_init, 2, 1, U)
        fn = lambda t, x: jax_vnets.lstm_apply(t, x, reverse,  # noqa: E731
                                               return_sequences)
    _fused_vs_jax(fn, trees, xs, dirs, reverse, return_sequences, rng)


def test_fused_projection_is_the_matmul_route():
    """The fused forward's plain version projects x as torch.matmul and the
    bias add round it: bit for bit the same recurrence."""
    rng = np.random.RandomState(5)
    n_folds, dirs, units = 2, 2, 4
    x = torch.tensor(rng.randn(n_folds, T, B).astype(np.float32))
    wx = torch.tensor(rng.randn(n_folds * dirs, 4 * units).astype(np.float32))
    b = torch.tensor(rng.randn(n_folds * dirs, 4 * units).astype(np.float32))
    wh = torch.tensor(rng.randn(n_folds * dirs, units, 4 * units)
                      .astype(np.float32))
    xw = (torch.matmul(x.unsqueeze(-1).unsqueeze(1),
                       wx.view(n_folds, dirs, 1, 1, -1))
          + b.view(n_folds, dirs, 1, 1, -1)).reshape(n_folds * dirs, T, B, -1)
    fused = lstm_cuda.lstm_scan_fwd(None, wh, dirs, x=x, wx=wx, b=b)
    for got, want in zip(fused, lstm_cuda.lstm_scan_fwd(xw, wh, dirs)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrappers_raise_on_inputs_they_do_not_take():
    """Unit counts, lanes a row, shapes and types the kernels do not take
    raise before any launch, on the CPU as on a device tensor; a device
    tensor (meta here) never takes the plain version."""
    x, wx, b = (torch.zeros((1, T, B)), torch.zeros((2, 16)),
                torch.zeros((2, 16)))
    wh, zs, c = (torch.zeros((2, 4, 16)), torch.zeros((2, T, B, 16)),
                 torch.zeros((2, T, B, 4)))
    meta = lambda *ts: [t.to("meta") for t in ts]  # noqa: E731
    # a unit count and lanes a row the kernels are not compiled for
    with pytest.raises(ValueError, match="U in"):
        lstm_cuda.lstm_scan_fwd(*meta(torch.zeros((2, T, B, 12)),
                                      torch.zeros((2, 3, 12))), 2)
    with pytest.raises(ValueError, match="lanes"):
        lstm_cuda.lstm_scan_fwd(None, *meta(wh), 2, x=meta(x)[0],
                                wx=meta(wx)[0], b=meta(b)[0], lanes=8)
    with pytest.raises(ValueError, match="lanes"):
        lstm_cuda.lstm_scan_bwd(None, None, *meta(zs, c, wh), 2, lanes=3)
    # shapes, types and mixed inputs
    with pytest.raises(ValueError, match="not both"):
        lstm_cuda.lstm_scan_fwd(torch.zeros((2, T, B, 16)), wh, 2, x=x,
                                wx=wx, b=b)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_scan_fwd(None, wh, 2, x=x, wx=torch.zeros((1, 16)),
                                b=b)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_scan_fwd(None, wh, 2, x=x.unsqueeze(-1), wx=wx, b=b)
    with pytest.raises(TypeError):
        lstm_cuda.lstm_scan_fwd(None, wh, 2, x=x.double(), wx=wx, b=b)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_scan_bwd(None, torch.zeros((2, B, 3)), zs, c, wh, 2)
    with pytest.raises(TypeError):
        lstm_cuda.lstm_scan_bwd(None, None, zs, c.double(), wh, 2)
    # device tensors go to the kernel, which this machine cannot build
    before = (lstm_cuda.fwd_launches, lstm_cuda.bwd_launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        lstm_cuda.lstm_scan_fwd(None, *meta(wh), 2, x=meta(x)[0],
                                wx=meta(wx)[0], b=meta(b)[0], lanes=4)
    with pytest.raises(RuntimeError, match="nvcc"):
        lstm_cuda.lstm_scan_bwd(None, None, *meta(zs, c, wh), 2, lanes=2)
    assert (lstm_cuda.fwd_launches, lstm_cuda.bwd_launches) == before


def test_default_lanes_are_compiled_variants():
    for units, lanes in lstm_cuda.LANES.items():
        for n_seq, rows in ((2, 1), (2, 128), (12, 128), (12, 384)):
            assert lstm_cuda.default_lanes(units, n_seq, rows) in lanes


@pytest.mark.parametrize("in_dim,units,dirs,reverse,return_sequences", [
    (1, 2, 2, False, False),   # the iwganlstm critic's layout
    (1, 4, 1, True, True),
    (2, 2, 1, True, False),
    (2, 4, 2, False, True),
    (1, 4, 2, False, True),
    (2, 2, 1, False, True),
])
def test_lstm_scan_is_twice_differentiable(in_dim, units, dirs, reverse,
                                           return_sequences):
    """gradgradcheck of LstmScan in float64 on the CPU: the second backward
    through the plain versions of lstm_scan_adj and lstm_scan_bwd_ext (and
    the products of dz, differentiated by autograd), every input kept off
    the hard-sigmoid edges (|0.2 z| well below 2.5)."""
    gen = torch.Generator().manual_seed(in_dim * 100 + units * 10 + dirs)

    def rand(scale, *shape):
        return (scale * torch.randn(shape, generator=gen,
                                    dtype=torch.float64)).requires_grad_()

    n_folds, steps, rows = 1, 4, 2
    x = rand(0.5, n_folds, steps, rows, in_dim)
    wx = rand(0.3, n_folds, dirs, in_dim, 4 * units)
    wh = rand(0.3, n_folds, dirs, units, 4 * units)
    b = rand(0.3, n_folds, dirs, 4 * units)
    assert torch.autograd.gradgradcheck(
        lambda *a: lstm.LstmScan.apply(*a, dirs, reverse, return_sequences),
        (x, wx, wh, b))


def test_first_backward_is_unchanged_under_create_graph():
    """The backward that a double backward records (lstm_scan_bwd_ext,
    storing its carries) gives the gradients of the first-order route
    (lstm_scan_bwd) bit for bit."""
    trees, params = _folds(jax_vnets.bilstm_init, 2, 1, 4)
    xs = torch.tensor(_inputs(2, 1, seed=8)[0], requires_grad=True)
    leaves = [xs] + jax.tree.leaves(
        jax.tree.map(lambda a: a.requires_grad_(), params))
    grads = []
    for create_graph in (False, True):
        out = _through_kernels(params, xs, 2, False, False)
        grads.append(torch.autograd.grad(out.square().sum(), leaves,
                                         create_graph=create_graph))
    for a, b in zip(*grads):
        assert torch.equal(a, b.detach())


def test_double_backward_wrappers_check_and_never_fall_back():
    zs, c, wh = (torch.zeros((2, T, B, 16)), torch.zeros((2, T, B, 4)),
                 torch.zeros((2, 4, 16)))
    with pytest.raises(ValueError):
        lstm_cuda.lstm_scan_bwd_ext(None, None, zs, c, wh, 2,
                                    dzs=torch.zeros((2, T, B, 4)))
    with pytest.raises(TypeError):
        lstm_cuda.lstm_scan_adj(zs, zs, c, c.double(), c, wh, 2)
    meta = lambda *ts: [t.to("meta") for t in ts]  # noqa: E731
    with pytest.raises(ValueError, match="U in"):
        lstm_cuda.lstm_scan_adj(*meta(torch.zeros((2, T, B, 12)),
                                      torch.zeros((2, T, B, 12)),
                                      torch.zeros((2, T, B, 3)),
                                      torch.zeros((2, T, B, 3)),
                                      torch.zeros((2, T, B, 3)),
                                      torch.zeros((2, 3, 12))), 2)
    with pytest.raises(ValueError, match="lanes a row"):
        lstm_cuda.lstm_scan_bwd_ext(None, None, *meta(zs, c, wh), 2,
                                    carries=True, lanes=8)
    with pytest.raises(ValueError, match="lanes a row"):
        lstm_cuda.lstm_scan_adj(*meta(zs, zs, c, c, c, wh), 2, lanes=16)
    before = (lstm_cuda.ext_launches, lstm_cuda.adj_launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        lstm_cuda.lstm_scan_bwd_ext(None, None, *meta(zs, c, wh), 2,
                                    carries=True)
    with pytest.raises(RuntimeError, match="nvcc"):
        lstm_cuda.lstm_scan_adj(*meta(zs, zs, c, c, c, wh), 2)
    assert (lstm_cuda.ext_launches, lstm_cuda.adj_launches) == before
