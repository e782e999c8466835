// Native batched block-sandwich executor.
//
// Copied from block2_preview_tpu/native/sandwich.cpp and templated over
// the value type (double, and complex128 for the complex environments of
// real-time evolution; coefficients stay real).  Counterpart of
// block2's threaded BatchGEMM engine for the
// environment-blocking recursion (reference src/core/batch_gemm.hpp:237,847
// and threading.hpp:74-136: operator/quanta-level OpenMP nesting).  The
// Python plan compiler (ops/blocking_plan.py) emits flat pools + exact-dim
// contribution lists grouped by output block; this kernel executes
//   out[g] += coef * op(MB, E, MK)
// with OpenMP parallelism over output groups (no write conflicts by
// construction, the same conflict-free partitioning as SeqTypes::Tasked).
//
// Built at first use by native/__init__.py (g++ -O3 -march=native -fopenmp
// -shared -fPIC) into build/native/.

#include <complex>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// direction 0 ("left"):  out(dx,dy) += coef * MB^T(dl,dx) E(dl,dk) MK(dk,dy)
// direction 1 ("right"): out(dx,dy) += coef * MB(dx,dl) E(dl,dk) MK^T(dy,dk)
// V is double, or std::complex<double> for complex site tensors and
// environments (time evolution); the MPO coefficients stay real.
template <typename V>
void sandwich(
    int direction, int64_t n_contrib,
    const V *epool, const V *bpool, const V *kpool,
    const int64_t *eoff, const int64_t *boff, const int64_t *koff,
    const int32_t *dl, const int32_t *dx, const int32_t *dk,
    const int32_t *dy, const double *coef,
    const int64_t *out_off,      // flat offset of this contribution's block
    const int64_t *grp_starts,   // group boundaries (sorted by out block)
    int64_t n_grp, V *out) {
#pragma omp parallel
    {
        std::vector<V> tmp;
#pragma omp for schedule(dynamic, 8)
        for (int64_t g = 0; g < n_grp; g++) {
            for (int64_t c = grp_starts[g]; c < grp_starts[g + 1]; c++) {
                const int X = dx[c], L = dl[c], K = dk[c], Y = dy[c];
                const V *MB = bpool + boff[c];
                const V *E = epool + eoff[c];
                const V *MK = kpool + koff[c];
                V *o = out + out_off[c];
                const double cf = coef[c];
                if ((size_t)(X * K) > tmp.size())
                    tmp.resize((size_t)(X * K));
                V *T = tmp.data();
                std::memset((void *)T, 0, sizeof(V) * (size_t)(X * K));
                if (direction == 0) {
                    // T(X,K) = MB^T(L,X)^T * E(L,K)
                    for (int l = 0; l < L; l++) {
                        const V *mbl = MB + (size_t)l * X;
                        const V *el = E + (size_t)l * K;
                        for (int x = 0; x < X; x++) {
                            const V m = mbl[x];
                            if (m == 0.0)
                                continue;
                            V *tx = T + (size_t)x * K;
                            for (int k = 0; k < K; k++)
                                tx[k] += m * el[k];
                        }
                    }
                    // out(X,Y) += cf * T(X,K) * MK(K,Y)
                    for (int x = 0; x < X; x++) {
                        const V *tx = T + (size_t)x * K;
                        V *ox = o + (size_t)x * Y;
                        for (int k = 0; k < K; k++) {
                            const V t = cf * tx[k];
                            if (t == 0.0)
                                continue;
                            const V *mkk = MK + (size_t)k * Y;
                            for (int y = 0; y < Y; y++)
                                ox[y] += t * mkk[y];
                        }
                    }
                } else {
                    // T(X,K) = MB(X,L) * E(L,K)
                    for (int x = 0; x < X; x++) {
                        const V *mbx = MB + (size_t)x * L;
                        V *tx = T + (size_t)x * K;
                        for (int l = 0; l < L; l++) {
                            const V m = mbx[l];
                            if (m == 0.0)
                                continue;
                            const V *el = E + (size_t)l * K;
                            for (int k = 0; k < K; k++)
                                tx[k] += m * el[k];
                        }
                    }
                    // out(X,Y) += cf * T(X,K) * MK(Y,K)^T
                    for (int x = 0; x < X; x++) {
                        const V *tx = T + (size_t)x * K;
                        V *ox = o + (size_t)x * Y;
                        for (int y = 0; y < Y; y++) {
                            const V *mky = MK + (size_t)y * K;
                            V acc = 0.0;
                            for (int k = 0; k < K; k++)
                                acc += tx[k] * mky[k];
                            ox[y] += cf * acc;
                        }
                    }
                }
            }
        }
    }
}

// Fused-operator assembly: out[out_off[c] + r*out_cols[c] + q] +=
//   coef[c] * E[eoff[c] + r*d2[c] + q]   (grouped by output block)
// Scatter env blocks into fused operator buffers.  rs/cs are the flat
// strides between consecutive env rows/cols in the output — both 1-based
// contiguous for multiplicity-1 site quanta, strided when several basis
// states share a quantum (trivial-symmetry qubits, big sites).
template <typename V>
void assemble(
    int64_t n_contrib, const V *epool, const int64_t *eoff,
    const int32_t *d1, const int32_t *d2, const double *coef,
    const int64_t *out_off, const int64_t *rs, const int64_t *cs,
    const int64_t *grp_starts, int64_t n_grp, V *out) {
#pragma omp parallel for schedule(dynamic, 16)
    for (int64_t g = 0; g < n_grp; g++) {
        for (int64_t c = grp_starts[g]; c < grp_starts[g + 1]; c++) {
            const int R = d1[c], Cc = d2[c];
            const int64_t S = rs[c], T = cs[c];
            const V *e = epool + eoff[c];
            V *o = out + out_off[c];
            const double cf = coef[c];
            if (T == 1) {
                for (int r = 0; r < R; r++) {
                    const V *er = e + (size_t)r * Cc;
                    V *orow = o + (size_t)r * S;
                    for (int q = 0; q < Cc; q++)
                        orow[q] += cf * er[q];
                }
            } else {
                for (int r = 0; r < R; r++) {
                    const V *er = e + (size_t)r * Cc;
                    V *orow = o + (size_t)r * S;
                    for (int q = 0; q < Cc; q++)
                        orow[(size_t)q * T] += cf * er[q];
                }
            }
        }
    }
}

}  // namespace

// Entry points: double (sandwich_exec / assemble_exec) and complex128
// (the _z twins; pools are interleaved (re, im) pairs, as numpy stores
// complex128).
#define SANDWICH_ENTRY(NAME, V)                                              \
    extern "C" void NAME(                                                    \
        int direction, int64_t n_contrib, const V *epool, const V *bpool,    \
        const V *kpool, const int64_t *eoff, const int64_t *boff,            \
        const int64_t *koff, const int32_t *dl, const int32_t *dx,           \
        const int32_t *dk, const int32_t *dy, const double *coef,            \
        const int64_t *out_off, const int64_t *grp_starts, int64_t n_grp,    \
        V *out) {                                                            \
        sandwich<V>(direction, n_contrib, epool, bpool, kpool, eoff, boff,   \
                    koff, dl, dx, dk, dy, coef, out_off, grp_starts, n_grp,  \
                    out);                                                    \
    }
#define ASSEMBLE_ENTRY(NAME, V)                                              \
    extern "C" void NAME(                                                    \
        int64_t n_contrib, const V *epool, const int64_t *eoff,              \
        const int32_t *d1, const int32_t *d2, const double *coef,            \
        const int64_t *out_off, const int64_t *rs, const int64_t *cs,        \
        const int64_t *grp_starts, int64_t n_grp, V *out) {                  \
        assemble<V>(n_contrib, epool, eoff, d1, d2, coef, out_off, rs, cs,   \
                    grp_starts, n_grp, out);                                 \
    }

SANDWICH_ENTRY(sandwich_exec, double)
SANDWICH_ENTRY(sandwich_exec_z, std::complex<double>)
ASSEMBLE_ENTRY(assemble_exec, double)
ASSEMBLE_ENTRY(assemble_exec_z, std::complex<double>)
