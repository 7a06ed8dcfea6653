"""The variant zoo's ``LinearSVC()`` (SVM kernel 4, others/wganlpctsemi.py:
214) solved on the device, without scikit-learn's liblinear.

The problem is liblinear's L2-regularised squared-hinge SVM, one-vs-rest
over the classes (a single problem for two), C = 1, with the intercept a
constant-1 feature whose weight is regularised like the others
(``intercept_scaling=1``): for each class k and labels y_i = +1 on its rows,
-1 elsewhere,

    min_w  0.5 |w|^2 + C sum_i max(0, 1 - y_i w.[x_i, 1])^2.

The objective is strictly convex, so its optimum is unique; scikit-learn
reaches it to its ``tol=1e-4`` by dual coordinate descent (shuffled by an
unseeded ``rand``) or by a trust-region Newton method in the primal,
picked by shape. Here every class is solved at once by a generalised Newton
method in float64 (Mangasarian 2002, "A finite Newton method for
classification"): the Hessian of the active rows, I + 2C X_A'X_A, is
(d+1)^2 and solved directly (Cholesky), the step is halved until the
Armijo condition holds, and the loop stops where the gradient is below
``TOL`` of its first value, or the active sets repeat under a full step
(then the step was the exact optimum of the quadratic they define).
"""

import torch

C = 1.0         # LinearSVC()'s
TOL = 1e-12     # of the first gradient's norm: well below scikit-learn's
MAX_ITER = 100  # Newton steps (finite convergence takes ~10)


def _objective(w, xa, ysign):
    margin = torch.clamp(1.0 - ysign * torch.einsum("nd,kd->kn", xa, w),
                         min=0.0)
    return 0.5 * (w * w).sum(-1) + C * (margin * margin).sum(-1), margin


class LinearSVC:
    """``LinearSVC()`` on the device of its inputs: ``fit`` (n, d) float
    rows and (n,) labels, then ``decision_function``, ``predict`` and
    ``score``. ``coef_`` (K, d) and ``intercept_`` (K,) as scikit-learn
    lays them out (K = 1 for two classes, whose positive side is the
    second class), float64 tensors."""

    def fit(self, x, y):
        xa = torch.cat([x.to(torch.float64),
                        x.new_ones((x.shape[0], 1), dtype=torch.float64)], 1)
        y = torch.as_tensor(y, device=x.device)
        self.classes_ = torch.unique(y)
        targets = (self.classes_[1:] if len(self.classes_) == 2
                   else self.classes_)
        ysign = torch.where(y[None] == targets[:, None], 1.0, -1.0).to(
            torch.float64)
        w = xa.new_zeros((len(targets), xa.shape[1]))
        eye = torch.eye(xa.shape[1], dtype=torch.float64, device=x.device)
        f, margin = _objective(w, xa, ysign)
        active, g0 = None, None
        for it in range(MAX_ITER):
            grad = w - 2.0 * C * torch.einsum("kn,nd->kd", ysign * margin, xa)
            gnorm = grad.norm(dim=-1)
            if g0 is None:
                g0 = gnorm.clamp(min=1e-300)
            if bool((gnorm <= TOL * g0).all()):
                break
            now = margin > 0
            if active is not None and bool((now == active).all()) and full:
                break
            active = now
            xs = xa[None] * now[..., None].to(torch.float64)  # (K, n, d+1)
            hess = eye + 2.0 * C * torch.matmul(xa.T[None], xs)
            step = -torch.cholesky_solve(
                grad.unsqueeze(-1), torch.linalg.cholesky(hess)).squeeze(-1)
            slope = (grad * step).sum(-1)
            t = torch.ones_like(f)
            for _ in range(60):  # Armijo: halve each class's step as needed
                f_new, m_new = _objective(w + t[:, None] * step, xa, ysign)
                bad = f_new > f + 1e-4 * t * slope
                if not bool(bad.any()):
                    break
                t = torch.where(bad, t / 2, t)
            full = bool((t == 1).all())
            w = w + t[:, None] * step
            f, margin = f_new, m_new
        self.n_iter_ = it + 1
        self.coef_, self.intercept_ = w[:, :-1], w[:, -1]
        return self

    def decision_function(self, x):
        return (torch.matmul(x.to(torch.float64), self.coef_.T)
                + self.intercept_)

    def predict(self, x):
        dec = self.decision_function(x)
        if len(self.classes_) == 2:
            return self.classes_[(dec[:, 0] > 0).long()]
        return self.classes_[dec.argmax(dim=-1)]

    def score(self, x, y):
        y = torch.as_tensor(y, device=x.device)
        return float((self.predict(x) == y).to(torch.float64).mean())
