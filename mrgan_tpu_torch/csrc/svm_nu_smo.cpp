// Native SMO solver for the nu-SVC dual on a precomputed kernel matrix.
//
// The nu-SVC of the variant zoo's SVM kernels 2 and 3 (NuSVC(kernel="rbf")
// and NuSVC(kernel="linear"), nu = 0.5, others/wganlpctsemi.py:204-214),
// which the reference reaches through scikit-learn's libsvm. Written after
// libsvm's Solver_NU and solve_nu_svc (Chang and Lin 2001, "Training
// nu-support vector classifiers"): for labels y in {+1, -1} and per-row
// bounds 0 <= a_i <= 1 it solves
//     min_a  0.5 a'Qa   s.t.  y'a = 0,  e'a = nu l,
// Q_ij = y_i y_j K_ij. Both equalities hold along any step that moves two
// alphas of one label, so the working set is a maximal violating pair
// within one label, the second row picked by the second-order gain (Fan,
// Chen, Lin 2005), as libsvm's Solver_NU::select_working_set does. No
// shrinking: it changes the path, not the optimum. Gradient in double; K
// stays float32 (it arrives straight from device memory).
//
// Exported C ABI (ctypes): svm_nu_smo_train().

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {
constexpr double kTau = 1e-12;
constexpr double kUpper = 1.0;  // every row's bound (unit sample weights)
}  // namespace

extern "C" {

// gram: n*n row-major float32 kernel matrix K
// y:    n labels, strictly +1 / -1, both present
// nu:   the fraction bound in (0, 1]; the caller checks it is feasible,
//       nu * l / 2 <= min(l+, l-), as libsvm's svm_check_parameter does
// tol:  stopping tolerance on the larger within-label violation (1e-3 is
//       scikit-learn's)
// max_iter: iteration cap (<= 0 means 10,000,000)
// coef_out: n doubles, a_i y_i / r; b_out: 1 double, -rho / r: the
//           decision is f(x) = sum_i coef_i K(x_i, x) + b, as libsvm scales
//           its nu-SVC solution into a C-SVC one (r its margin)
// returns iterations used, or -1 if the cap was hit before convergence
int64_t svm_nu_smo_train(const float* gram, const int8_t* y, int64_t n,
                         double nu, double tol, int64_t max_iter,
                         double* coef_out, double* b_out) {
  if (max_iter <= 0) max_iter = 10000000;
  // a feasible start: nu l / 2 spread over each label's rows in order
  double nu_l = 0.0;
  for (int64_t t = 0; t < n; ++t) nu_l += nu * kUpper;
  double left_pos = nu_l / 2, left_neg = nu_l / 2;
  std::vector<double> alpha(n);
  for (int64_t t = 0; t < n; ++t) {
    double& left = y[t] > 0 ? left_pos : left_neg;
    alpha[t] = std::min(kUpper, left);
    left -= alpha[t];
  }
  // G = Q a (the linear term is 0)
  std::vector<double> G(n, 0.0);
  for (int64_t s = 0; s < n; ++s) {
    if (alpha[s] <= 0.0) continue;
    const float* Ks = gram + s * n;
    for (int64_t t = 0; t < n; ++t) G[t] += alpha[s] * y[s] * y[t] * Ks[t];
  }
  auto at_upper = [&](int64_t t) { return alpha[t] >= kUpper; };
  auto at_lower = [&](int64_t t) { return alpha[t] <= 0.0; };

  int64_t iter = 0;
  for (; iter < max_iter; ++iter) {
    // i: the most violating row of each label that can move up (in -y G)
    double gmax_p = -HUGE_VAL, gmax_n = -HUGE_VAL;
    int64_t ip = -1, in = -1;
    for (int64_t t = 0; t < n; ++t) {
      if (y[t] > 0) {
        if (!at_upper(t) && -G[t] >= gmax_p) { gmax_p = -G[t]; ip = t; }
      } else {
        if (!at_lower(t) && G[t] >= gmax_n) { gmax_n = G[t]; in = t; }
      }
    }
    // j: of the rows of the same label that can move down, the one whose
    // step with i decreases the objective most
    double gmax_p2 = -HUGE_VAL, gmax_n2 = -HUGE_VAL, best = HUGE_VAL;
    int64_t j = -1;
    const float* Kp = ip >= 0 ? gram + ip * n : nullptr;
    const float* Kn = in >= 0 ? gram + in * n : nullptr;
    for (int64_t t = 0; t < n; ++t) {
      double diff, quad;
      if (y[t] > 0) {
        if (at_lower(t)) continue;
        gmax_p2 = std::max(gmax_p2, G[t]);
        diff = gmax_p + G[t];
        if (diff <= 0.0) continue;
        quad = (double)Kp[ip] + gram[t * n + t] - 2.0 * Kp[t];
      } else {
        if (at_upper(t)) continue;
        gmax_n2 = std::max(gmax_n2, -G[t]);
        diff = gmax_n - G[t];
        if (diff <= 0.0) continue;
        quad = (double)Kn[in] + gram[t * n + t] - 2.0 * Kn[t];
      }
      const double gain = -(diff * diff) / (quad > 0.0 ? quad : kTau);
      if (gain <= best) { best = gain; j = t; }
    }
    if (std::max(gmax_p + gmax_p2, gmax_n + gmax_n2) < tol || j < 0) break;
    const int64_t i = y[j] > 0 ? ip : in;

    // the two-variable step of one label (libsvm's y_i == y_j update)
    const float* Ki = gram + i * n;
    const float* Kj = gram + j * n;
    const double old_ai = alpha[i], old_aj = alpha[j];
    double quad = (double)Ki[i] + Kj[j] - 2.0 * Ki[j];
    if (quad <= 0.0) quad = kTau;
    const double delta = (G[i] - G[j]) / quad;
    const double sum = alpha[i] + alpha[j];
    alpha[i] -= delta;
    alpha[j] += delta;
    if (sum > kUpper) {
      if (alpha[i] > kUpper) { alpha[i] = kUpper; alpha[j] = sum - kUpper; }
    } else {
      if (alpha[j] < 0.0) { alpha[j] = 0.0; alpha[i] = sum; }
    }
    if (sum > kUpper) {
      if (alpha[j] > kUpper) { alpha[j] = kUpper; alpha[i] = sum - kUpper; }
    } else {
      if (alpha[i] < 0.0) { alpha[i] = 0.0; alpha[j] = sum; }
    }
    // G_t += Q_ti da_i + Q_tj da_j (y_i = y_j)
    const double dai = alpha[i] - old_ai, daj = alpha[j] - old_aj;
    for (int64_t t = 0; t < n; ++t)
      G[t] += y[t] * y[i] * (Ki[t] * dai + Kj[t] * daj);
  }

  // r1, r2: each label's -y G level over its free rows, or the middle of
  // its feasible interval where it has none (libsvm's calculate_rho)
  double r[2];
  for (int side = 0; side < 2; ++side) {
    const int8_t label = side == 0 ? 1 : -1;
    double ub = HUGE_VAL, lb = -HUGE_VAL, free_sum = 0.0;
    int64_t n_free = 0;
    for (int64_t t = 0; t < n; ++t) {
      if (y[t] != label) continue;
      if (at_upper(t)) lb = std::max(lb, G[t]);
      else if (at_lower(t)) ub = std::min(ub, G[t]);
      else { free_sum += G[t]; ++n_free; }
    }
    r[side] = n_free > 0 ? free_sum / n_free : (ub + lb) / 2;
  }
  const double scale = (r[0] + r[1]) / 2, rho = (r[0] - r[1]) / 2;
  for (int64_t t = 0; t < n; ++t) coef_out[t] = alpha[t] * y[t] / scale;
  *b_out = -rho / scale;
  return iter >= max_iter ? -1 : iter;
}

}  // extern "C"
