// Lawson-Hanson active-set non-negative least squares.
//
// Native replacement for the reference's scipy.optimize.nnls dependency
// (Fortran Lawson-Hanson invoked at reference snnls/snnls.py:87 and
// snnls/orthopursuit.py:40).  The TPU compute path uses the on-chip FISTA
// solver (ops/nnls.py); this exact host-side solver serves the host
// `optimize()` path and as a correctness oracle, with no Fortran runtime.
//
// Solves  min_x ||A x - b||_2  s.t.  x >= 0,
// A: m x n row-major doubles.  Standard algorithm (Lawson & Hanson 1974,
// ch. 23) with normal-equation Cholesky solves on the passive set.
//
// Build: g++ -O3 -march=native -shared -fPIC nnls.cpp -o libbcnnls.so

#include <cmath>
#include <cstring>
#include <vector>

namespace {

// Solve (Ap^T Ap) z = Ap^T b restricted to passive columns via Cholesky.
// Returns false if the normal matrix is numerically singular.
// ATA/ATb: optional precomputed full normal-equation blocks (null to skip).
bool solve_passive(const double* A, const double* b, int m, int n,
                   const double* ATA, const double* ATb,
                   const std::vector<int>& passive, std::vector<double>& z) {
    const int k = static_cast<int>(passive.size());
    std::vector<double> G(static_cast<size_t>(k) * k, 0.0);
    std::vector<double> c(k, 0.0);
    for (int i = 0; i < k; ++i) {
        const int ci = passive[i];
        for (int j = i; j < k; ++j) {
            const int cj = passive[j];
            double s;
            if (ATA != nullptr) {
                s = ATA[static_cast<size_t>(ci) * n + cj];
            } else {
                s = 0.0;
                for (int r = 0; r < m; ++r)
                    s += A[static_cast<size_t>(r) * n + ci] *
                         A[static_cast<size_t>(r) * n + cj];
            }
            G[static_cast<size_t>(i) * k + j] = s;
            G[static_cast<size_t>(j) * k + i] = s;
        }
        double s;
        if (ATb != nullptr) {
            s = ATb[ci];
        } else {
            s = 0.0;
            for (int r = 0; r < m; ++r)
                s += A[static_cast<size_t>(r) * n + ci] * b[r];
        }
        c[i] = s;
    }
    // Cholesky G = L L^T with a tiny ridge for numerical safety
    std::vector<double> L(static_cast<size_t>(k) * k, 0.0);
    for (int i = 0; i < k; ++i) {
        for (int j = 0; j <= i; ++j) {
            double s = G[static_cast<size_t>(i) * k + j];
            for (int p = 0; p < j; ++p)
                s -= L[static_cast<size_t>(i) * k + p] *
                     L[static_cast<size_t>(j) * k + p];
            if (i == j) {
                if (s <= 0.0) return false;
                L[static_cast<size_t>(i) * k + i] = std::sqrt(s);
            } else {
                L[static_cast<size_t>(i) * k + j] =
                    s / L[static_cast<size_t>(j) * k + j];
            }
        }
    }
    // forward/back substitution
    std::vector<double> y(k);
    for (int i = 0; i < k; ++i) {
        double s = c[i];
        for (int p = 0; p < i; ++p)
            s -= L[static_cast<size_t>(i) * k + p] * y[p];
        y[i] = s / L[static_cast<size_t>(i) * k + i];
    }
    z.assign(k, 0.0);
    for (int i = k - 1; i >= 0; --i) {
        double s = y[i];
        for (int p = i + 1; p < k; ++p)
            s -= L[static_cast<size_t>(p) * k + i] * z[p];
        z[i] = s / L[static_cast<size_t>(i) * k + i];
    }
    return true;
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 if maxiter was reached, 2 on numerical failure.
// x (n) receives the solution; rnorm (1) the residual norm.
int bc_nnls(const double* A, const double* b, int m, int n, int maxiter,
            double* x, double* rnorm) {
    if (maxiter <= 0) maxiter = 3 * n;
    std::vector<char> in_passive(n, 0);
    std::vector<int> passive;
    std::vector<double> resid(b, b + m);
    std::vector<double> w(n), z;
    std::memset(x, 0, sizeof(double) * n);

    // precompute the normal-equation blocks when the memory cost is modest:
    // turns each inner Cholesky rebuild from O(k^2 m) into O(k^2)
    std::vector<double> ATA_buf, ATb_buf;
    const double* ATA = nullptr;
    const double* ATb = nullptr;
    if (static_cast<long long>(n) * n <= 8LL * 1024 * 1024) {
        ATA_buf.assign(static_cast<size_t>(n) * n, 0.0);
        ATb_buf.assign(n, 0.0);
        for (int r = 0; r < m; ++r) {
            const double* row = A + static_cast<size_t>(r) * n;
            for (int i = 0; i < n; ++i) {
                const double ri = row[i];
                if (ri == 0.0) continue;
                double* out = &ATA_buf[static_cast<size_t>(i) * n];
                for (int j = i; j < n; ++j) out[j] += ri * row[j];
                ATb_buf[i] += ri * b[r];
            }
        }
        for (int i = 0; i < n; ++i)
            for (int j = 0; j < i; ++j)
                ATA_buf[static_cast<size_t>(i) * n + j] =
                    ATA_buf[static_cast<size_t>(j) * n + i];
        ATA = ATA_buf.data();
        ATb = ATb_buf.data();
    }

    const double tol = 1e-10;
    int iters = 0;

    while (true) {
        // w = A^T resid
        double wmax = -1.0;
        int t = -1;
        for (int j = 0; j < n; ++j) {
            if (in_passive[j]) continue;
            double s = 0.0;
            for (int r = 0; r < m; ++r)
                s += A[static_cast<size_t>(r) * n + j] * resid[r];
            w[j] = s;
            if (s > wmax) { wmax = s; t = j; }
        }
        if (t < 0 || wmax <= tol) break;   // KKT satisfied

        in_passive[t] = 1;
        passive.push_back(t);

        // inner loop: restore feasibility on the passive set
        while (true) {
            if (++iters > maxiter) { *rnorm = -1.0; return 1; }
            if (!solve_passive(A, b, m, n, ATA, ATb, passive, z)) { *rnorm = -1.0; return 2; }
            bool all_pos = true;
            for (size_t i = 0; i < passive.size(); ++i)
                if (z[i] <= tol) { all_pos = false; break; }
            if (all_pos) {
                for (size_t i = 0; i < passive.size(); ++i) x[passive[i]] = z[i];
                break;
            }
            // step toward z until the first variable hits zero
            double alpha = 2.0;
            for (size_t i = 0; i < passive.size(); ++i) {
                if (z[i] <= tol) {
                    const double xi = x[passive[i]];
                    const double a = xi / (xi - z[i]);
                    if (a < alpha) alpha = a;
                }
            }
            if (alpha > 1.0) alpha = 1.0;
            for (size_t i = 0; i < passive.size(); ++i) {
                const int j = passive[i];
                x[j] += alpha * (z[i] - x[j]);
            }
            // drop zeroed variables from the passive set
            std::vector<int> next;
            next.reserve(passive.size());
            for (size_t i = 0; i < passive.size(); ++i) {
                const int j = passive[i];
                if (x[j] > tol) {
                    next.push_back(j);
                } else {
                    x[j] = 0.0;
                    in_passive[j] = 0;
                }
            }
            passive.swap(next);
            if (passive.empty()) break;
        }

        // resid = b - A x
        for (int r = 0; r < m; ++r) {
            double s = b[r];
            for (size_t i = 0; i < passive.size(); ++i) {
                const int j = passive[i];
                s -= A[static_cast<size_t>(r) * n + j] * x[j];
            }
            resid[r] = s;
        }
    }

    double s = 0.0;
    for (int r = 0; r < m; ++r) s += resid[r] * resid[r];
    *rnorm = std::sqrt(s);
    return 0;
}

}  // extern "C"
