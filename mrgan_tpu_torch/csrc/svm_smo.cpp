// Native SMO solver for the C-SVC dual on a precomputed kernel matrix.
//
// The framework computes RBF Gram matrices on the TPU (mrgan_tpu/train/
// svm.py rbf_kernel — the O(n^2 d) part); this solver replaces the libsvm
// dependency for the tiny convex dual solve (reference mr_svm.py:106
// reaches libsvm through sklearn.svm.SVC). Binary solver only: one-vs-one
// multiclass voting lives in Python, mirroring libsvm's decomposition.
//
// Algorithm: sequential minimal optimization with maximal-violating-pair
// working-set selection (Fan, Chen, Lin 2005, "Working Set Selection Using
// Second Order Information" — the WSS1 baseline), solving
//     min_a  0.5 a'Qa - e'a   s.t.  y'a = 0,  0 <= a_i <= C,
// where Q_ij = y_i y_j K_ij. Gradient kept in double; K stays float32
// (it arrives straight from device memory).
//
// Exported C ABI (ctypes): svm_smo_train().

#include <cmath>
#include <cstdint>
#include <vector>

namespace {
constexpr double kTau = 1e-12;

inline bool in_up(double a, int8_t y, double C) {
  return y > 0 ? a < C : a > 0.0;
}
inline bool in_low(double a, int8_t y, double C) {
  return y > 0 ? a > 0.0 : a < C;
}
}  // namespace

extern "C" {

// gram: n*n row-major float32 kernel matrix K
// y:    n labels, strictly +1 / -1
// C, tol: C-SVC cost and stopping tolerance (libsvm defaults: tol=1e-3)
// max_iter: iteration cap (<=0 means 10,000,000, libsvm's cap)
// alpha_out: n doubles; b_out: 1 double, decision f(x) = sum_i a_i y_i
//            K(x_i, x) + b
// returns iterations used, or -1 if the cap was hit before convergence
int64_t svm_smo_train(const float* gram, const int8_t* y, int64_t n,
                      double C, double tol, int64_t max_iter,
                      double* alpha_out, double* b_out) {
  if (max_iter <= 0) max_iter = 10000000;
  std::vector<double> alpha(n, 0.0);
  // G_i = d/da_i [0.5 a'Qa - e'a] = (Qa)_i - 1; zero alpha => -1
  std::vector<double> G(n, -1.0);

  int64_t iter = 0;
  for (; iter < max_iter; ++iter) {
    // maximal violating pair: i = argmax_{I_up} -y G, j = argmin_{I_low}
    int64_t i = -1, j = -1;
    double gmax = -HUGE_VAL, gmin = HUGE_VAL;
    for (int64_t t = 0; t < n; ++t) {
      const double v = -y[t] * G[t];
      if (in_up(alpha[t], y[t], C) && v > gmax) { gmax = v; i = t; }
      if (in_low(alpha[t], y[t], C) && v < gmin) { gmin = v; j = t; }
    }
    if (i < 0 || j < 0 || gmax - gmin < tol) break;

    const float* Ki = gram + i * n;
    const float* Kj = gram + j * n;
    const double kii = Ki[i], kjj = Kj[j], kij = Ki[j];
    const double old_ai = alpha[i], old_aj = alpha[j];

    if (y[i] != y[j]) {
      // Q_ii + Q_jj - 2 y_i y_j Q_ij with Q_ij = y_i y_j K_ij = -K_ij, as
      // libsvm's QD[i] + QD[j] + 2 Q_i[j]
      double quad = kii + kjj - 2.0 * kij;
      if (quad <= 0.0) quad = kTau;
      const double delta = (-G[i] - G[j]) / quad;
      const double diff = alpha[i] - alpha[j];
      alpha[i] += delta;
      alpha[j] += delta;
      // project back onto the box along the y'a = const line
      if (diff > 0.0) {
        if (alpha[j] < 0.0) { alpha[j] = 0.0; alpha[i] = diff; }
      } else {
        if (alpha[i] < 0.0) { alpha[i] = 0.0; alpha[j] = -diff; }
      }
      if (diff > 0.0) {
        if (alpha[i] > C) { alpha[i] = C; alpha[j] = C - diff; }
      } else {
        if (alpha[j] > C) { alpha[j] = C; alpha[i] = C + diff; }
      }
    } else {
      double quad = kii + kjj - 2.0 * kij;
      if (quad <= 0.0) quad = kTau;
      const double delta = (G[i] - G[j]) / quad;
      const double sum = alpha[i] + alpha[j];
      alpha[i] -= delta;
      alpha[j] += delta;
      if (sum > C) {
        if (alpha[i] > C) { alpha[i] = C; alpha[j] = sum - C; }
      } else {
        if (alpha[j] < 0.0) { alpha[j] = 0.0; alpha[i] = sum; }
      }
      if (sum > C) {
        if (alpha[j] > C) { alpha[j] = C; alpha[i] = sum - C; }
      } else {
        if (alpha[i] < 0.0) { alpha[i] = 0.0; alpha[j] = sum; }
      }
    }

    // rank-2 gradient update: G_t += Q_ti da_i + Q_tj da_j
    const double dai = alpha[i] - old_ai, daj = alpha[j] - old_aj;
    if (dai != 0.0 || daj != 0.0) {
      const double ci = y[i] * dai, cj = y[j] * daj;
      for (int64_t t = 0; t < n; ++t)
        G[t] += y[t] * (ci * Ki[t] + cj * Kj[t]);
    }
  }

  // b from the KKT conditions: -y_i G_i == b for every free SV; otherwise
  // the midpoint of the feasible interval (gmax/gmin of the final state)
  double b_sum = 0.0;
  int64_t n_free = 0;
  double ub = HUGE_VAL, lb = -HUGE_VAL;
  for (int64_t t = 0; t < n; ++t) {
    const double v = -y[t] * G[t];
    if (alpha[t] > 0.0 && alpha[t] < C) { b_sum += v; ++n_free; }
    if (in_up(alpha[t], y[t], C)) lb = v > lb ? v : lb;
    if (in_low(alpha[t], y[t], C)) ub = v < ub ? v : ub;
  }
  *b_out = n_free > 0 ? b_sum / n_free : (lb + ub) / 2.0;
  for (int64_t t = 0; t < n; ++t) alpha_out[t] = alpha[t];
  return iter >= max_iter ? -1 : iter;
}

}  // extern "C"
