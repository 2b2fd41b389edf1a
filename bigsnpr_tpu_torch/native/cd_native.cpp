// Coordinate-descent elastic-net path fits (gaussian + binomial IRLS).
//
// A copy of the JAX package's bigsnpr_tpu/native/cd_native.cpp for the
// port's linalg/penalized.py, built with g++ at first use. The stacking
// step big_spReg is the one hot loop that cannot vectorize: cyclic CD
// updates each coordinate against the *current* residual. The reference
// keeps this in C++ for the same reason (bigstatsr src/biglasso/*, used by
// R/SCT.R:266-304 stacking). Same update order, same early-stop rule, same
// validation-loss selection, same global work budget as the JAX package's.
//
// One change: the residual paths take the whole standardized matrix X,
// column-major with leading dimension ldx, and the fold's training and
// validation rows as ascending index lists (rows, vrows), where the JAX
// package copies X[rows] and X[vrows] for every fold. Rows are visited in
// the same order, so every sum is the same; the K folds share one matrix
// (at 15,000 x 30,800 the copies alone were ~33 GB).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline double soft(double x, double t) {
  double a = std::fabs(x) - t;
  return a > 0 ? (x > 0 ? a : -a) : 0.0;
}

inline double dot(const double* a, const double* b, int64_t n) {
  double s = 0.0;
  for (int64_t i = 0; i < n; ++i) s += a[i] * b[i];
  return s;
}

inline void axpy(double c, const double* x, double* y, int64_t n) {
  for (int64_t i = 0; i < n; ++i) y[i] += c * x[i];
}

// the same over the rows `rows` of column x
inline double dot_rows(const double* x, const int64_t* rows, const double* b,
                       int64_t n) {
  double s = 0.0;
  for (int64_t i = 0; i < n; ++i) s += x[rows[i]] * b[i];
  return s;
}

inline void axpy_rows(double c, const double* x, const int64_t* rows,
                      double* y, int64_t n) {
  for (int64_t i = 0; i < n; ++i) y[i] += c * x[rows[i]];
}

}  // namespace

extern "C" {

// returns 0 on success. best_beta must hold p doubles.
// X: (ldx, p) column-major; rows (n,) the training rows, vrows (nval,)
// the validation rows, both ascending; y / yval their responses.
int cd_gaussian_path(const double* X, int64_t ldx, const int64_t* rows,
                     const double* y, int64_t n, int64_t p,
                     const double* lambdas, int64_t nlam, double alpha,
                     const int64_t* vrows, const double* yval, int64_t nval,
                     int64_t n_abort, double tol, int64_t maxit,
                     double* best_beta, double* best_intercept,
                     double* best_loss, int64_t* best_li) {
  std::vector<double> beta(p, 0.0), r(n), xsq(p);
  double intercept = 0.0;
  for (int64_t i = 0; i < n; ++i) intercept += y[i];
  intercept /= n;
  for (int64_t i = 0; i < n; ++i) r[i] = y[i] - intercept;
  for (int64_t j = 0; j < p; ++j) {
    const double* xj = X + j * ldx;
    double s = 0.0;
    for (int64_t i = 0; i < n; ++i) s += xj[rows[i]] * xj[rows[i]];
    xsq[j] = s / n;
  }

  *best_loss = HUGE_VAL;
  *best_li = 0;
  std::memset(best_beta, 0, sizeof(double) * p);
  *best_intercept = 0.0;
  int64_t best_at = 0;
  bool have_best = false;

  std::vector<int64_t> active;
  active.reserve(p);
  for (int64_t li = 0; li < nlam; ++li) {
    double l1 = lambdas[li] * alpha, l2 = lambdas[li] * (1.0 - alpha);

    auto update_j = [&](int64_t j) -> double {
      const double* xj = X + j * ldx;
      double bj = beta[j];
      double rho = dot_rows(xj, rows, r.data(), n) / n + xsq[j] * bj;
      double nb = soft(rho, l1) / (xsq[j] + l2);
      if (nb != bj) {
        axpy_rows(bj - nb, xj, rows, r.data(), n);
        beta[j] = nb;
        return std::fabs(nb - bj);
      }
      return 0.0;
    };
    auto recenter = [&]() {
      double di = 0.0;
      for (int64_t i = 0; i < n; ++i) di += r[i];
      di /= n;
      if (di != 0.0) {
        intercept += di;
        for (int64_t i = 0; i < n; ++i) r[i] -= di;
      }
    };

    // active-set CD: a full pass (also the KKT check) collects the
    // nonzero set, then cheap inner passes iterate only that set to
    // convergence — same fixed point as plain cyclic CD, a fraction of
    // the full n*p sweeps (glmnet's covariance-free active strategy).
    // Work is bounded by a GLOBAL budget of `maxit` full-pass
    // equivalents (an active pass costs |active|/p of the budget) so a
    // near-collinear design (e.g. nested C+T threshold scores in SCT
    // stacking) degrades to the python fallback's maxit sweeps, not
    // maxit^2 of them.
    double used = 0.0, budget = static_cast<double>(maxit);
    while (used < budget) {
      double max_d = 0.0;
      active.clear();
      for (int64_t j = 0; j < p; ++j) {
        double d = update_j(j);
        if (d > max_d) max_d = d;
        if (beta[j] != 0.0) active.push_back(j);
      }
      recenter();
      used += 1.0;
      if (max_d < tol) break;
      double frac = active.empty()
                        ? 1.0
                        : static_cast<double>(active.size()) /
                              static_cast<double>(p);
      while (used < budget) {
        double max_di = 0.0;
        for (int64_t j : active) {
          double d = update_j(j);
          if (d > max_di) max_di = d;
        }
        recenter();
        used += frac;
        if (max_di < tol) break;
      }
    }
    // validation loss
    double loss = 0.0;
    for (int64_t i = 0; i < nval; ++i) {
      double pred = intercept;
      for (int64_t j = 0; j < p; ++j)
        if (beta[j] != 0.0) pred += X[j * ldx + vrows[i]] * beta[j];
      double e = yval[i] - pred;
      loss += e * e;
    }
    loss /= nval;
    if (loss < *best_loss) {
      *best_loss = loss;
      std::memcpy(best_beta, beta.data(), sizeof(double) * p);
      *best_intercept = intercept;
      *best_li = li;
      best_at = li;
      have_best = true;
    }
    if (li - best_at >= n_abort) break;
  }
  return have_best ? 0 : 1;
}

// Covariance-mode (Gram) gaussian path: when n >> p, CD passes against
// the p x p Gram cost O(p^2) independent of n (glmnet's "covariance
// updating"). Same fixed point and selection rule as cd_gaussian_path.
//
//   G    = Xtr' Xtr / n_tr   (standardized-columns Gram, p x p)
//   xty  = Xtr' ytr / n_tr
//   c    = column means of Xtr (global standardization leaves per-fold
//          means slightly nonzero)
//   Gval/xvty/cv: same for the validation fold; yv2 = mean(yval^2)
int cd_gaussian_gram_path(const double* G, const double* xty,
                          const double* c, double ybar, int64_t p,
                          const double* lambdas, int64_t nlam, double alpha,
                          const double* Gval, const double* xvty,
                          const double* cv, double yvbar, double yv2,
                          int64_t n_abort, double tol, int64_t maxit,
                          double* best_beta, double* best_intercept,
                          double* best_loss, int64_t* best_li) {
  std::vector<double> beta(p, 0.0), q(p, 0.0);  // q = G beta
  double intercept = ybar;  // beta = 0 start
  *best_loss = HUGE_VAL;
  *best_li = 0;
  std::memset(best_beta, 0, sizeof(double) * p);
  *best_intercept = 0.0;
  int64_t best_at = 0;
  bool have_best = false;

  std::vector<int64_t> active;
  active.reserve(p);
  for (int64_t li = 0; li < nlam; ++li) {
    double l1 = lambdas[li] * alpha, l2 = lambdas[li] * (1.0 - alpha);

    auto update_j = [&](int64_t j) -> double {
      const double* gj = G + j * p;
      double bj = beta[j];
      double rho = xty[j] - q[j] + gj[j] * bj - intercept * c[j];
      double nb = soft(rho, l1) / (gj[j] + l2);
      if (nb != bj) {
        axpy(nb - bj, gj, q.data(), p);
        beta[j] = nb;
        return std::fabs(nb - bj);
      }
      return 0.0;
    };
    auto recenter = [&]() { intercept = ybar - dot(c, beta.data(), p); };

    double used = 0.0, budget = static_cast<double>(maxit);
    while (used < budget) {
      double max_d = 0.0;
      active.clear();
      for (int64_t j = 0; j < p; ++j) {
        double d = update_j(j);
        if (d > max_d) max_d = d;
        if (beta[j] != 0.0) active.push_back(j);
      }
      recenter();
      used += 1.0;
      if (max_d < tol) break;
      double frac = active.empty()
                        ? 1.0
                        : static_cast<double>(active.size()) /
                              static_cast<double>(p);
      while (used < budget) {
        double max_di = 0.0;
        for (int64_t j : active) {
          double d = update_j(j);
          if (d > max_di) max_di = d;
        }
        recenter();
        used += frac;
        if (max_di < tol) break;
      }
    }
    // validation loss = mean((yval - b0 - Xval beta)^2), expanded in
    // Gram terms so Xval never enters this function
    double bgb = 0.0, bxy = 0.0, bcv = 0.0;
    for (int64_t j = 0; j < p; ++j) {
      if (beta[j] == 0.0) continue;
      bxy += beta[j] * xvty[j];
      bcv += beta[j] * cv[j];
      const double* gvj = Gval + j * p;
      double s = 0.0;
      for (int64_t k : active)
        s += gvj[k] * beta[k];
      bgb += beta[j] * s;
    }
    double loss = yv2 - 2.0 * intercept * yvbar - 2.0 * bxy +
                  2.0 * intercept * bcv + intercept * intercept + bgb;
    if (loss < *best_loss) {
      *best_loss = loss;
      std::memcpy(best_beta, beta.data(), sizeof(double) * p);
      *best_intercept = intercept;
      *best_li = li;
      best_at = li;
      have_best = true;
    }
    if (li - best_at >= n_abort) break;
  }
  return have_best ? 0 : 1;
}

int cd_binomial_path(const double* X, int64_t ldx, const int64_t* rows,
                     const double* y, int64_t n, int64_t p,
                     const double* lambdas, int64_t nlam, double alpha,
                     const int64_t* vrows, const double* yval, int64_t nval,
                     int64_t n_abort, double tol, int64_t maxit,
                     double* best_beta, double* best_intercept,
                     double* best_loss, int64_t* best_li) {
  std::vector<double> beta(p, 0.0), eta(n), mu(n), w(n), r(n);
  double ybar = 0.0;
  for (int64_t i = 0; i < n; ++i) ybar += y[i];
  ybar /= n;
  double lo = ybar < 1e-9 ? 1e-9 : ybar;
  double hi = (1.0 - ybar) < 1e-9 ? 1e-9 : (1.0 - ybar);
  double intercept = std::log(lo / hi);

  *best_loss = HUGE_VAL;
  *best_li = 0;
  std::memset(best_beta, 0, sizeof(double) * p);
  *best_intercept = 0.0;
  int64_t best_at = 0;
  bool have_best = false;

  for (int64_t li = 0; li < nlam; ++li) {
    double l1 = lambdas[li] * alpha, l2 = lambdas[li] * (1.0 - alpha);
    for (int64_t it = 0; it < maxit; ++it) {
      // IRLS weights at the current (beta, intercept)
      for (int64_t i = 0; i < n; ++i) eta[i] = intercept;
      for (int64_t j = 0; j < p; ++j)
        if (beta[j] != 0.0) axpy_rows(beta[j], X + j * ldx, rows, eta.data(), n);
      double wsum = 0.0;
      for (int64_t i = 0; i < n; ++i) {
        mu[i] = 1.0 / (1.0 + std::exp(-eta[i]));
        double wi = mu[i] * (1.0 - mu[i]);
        w[i] = wi > 1e-6 ? wi : 1e-6;
        wsum += w[i];
        r[i] = (y[i] - mu[i]) / w[i];  // z - eta
      }
      double max_d = 0.0;
      for (int64_t j = 0; j < p; ++j) {
        const double* xj = X + j * ldx;
        double bj = beta[j];
        double wxx = 0.0, rho = 0.0;
        for (int64_t i = 0; i < n; ++i) {
          const double x = xj[rows[i]];
          wxx += w[i] * x * x;
          rho += w[i] * x * r[i];
        }
        wxx /= n;
        rho = rho / n + wxx * bj;
        double nb = soft(rho, l1) / (wxx + l2);
        if (nb != bj) {
          axpy_rows(bj - nb, xj, rows, r.data(), n);
          beta[j] = nb;
          double d = std::fabs(nb - bj);
          if (d > max_d) max_d = d;
        }
      }
      double di = 0.0;
      for (int64_t i = 0; i < n; ++i) di += w[i] * r[i];
      di /= wsum;
      intercept += di;
      for (int64_t i = 0; i < n; ++i) r[i] -= di;
      if (max_d < tol && std::fabs(di) < tol) break;
    }
    double loss = 0.0;
    for (int64_t i = 0; i < nval; ++i) {
      double pred = intercept;
      for (int64_t j = 0; j < p; ++j)
        if (beta[j] != 0.0) pred += X[j * ldx + vrows[i]] * beta[j];
      double m = 1.0 / (1.0 + std::exp(-pred));
      if (m < 1e-9) m = 1e-9;
      if (m > 1.0 - 1e-9) m = 1.0 - 1e-9;
      loss -= yval[i] * std::log(m) + (1.0 - yval[i]) * std::log(1.0 - m);
    }
    loss /= nval;
    if (loss < *best_loss) {
      *best_loss = loss;
      std::memcpy(best_beta, beta.data(), sizeof(double) * p);
      *best_intercept = intercept;
      *best_li = li;
      best_at = li;
      have_best = true;
    }
    if (li - best_at >= n_abort) break;
  }
  return have_best ? 0 : 1;
}

}  // extern "C"
