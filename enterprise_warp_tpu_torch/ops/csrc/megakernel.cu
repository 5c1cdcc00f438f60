// Likelihood megakernels and the fused preconditioner for NVIDIA Hopper
// (sm_90a), plain C interface.
//
// Three kernels share one set of block-level device routines:
//
//   the solve pipeline   replaces  enterprise_warp_tpu/ops/megakernel.py:
//                                  _mega_solve_kernel (pallas_call in
//                                  _mega_solve_raw)
//   the likelihood       replaces  enterprise_warp_tpu/ops/megakernel.py:
//   pipeline                       _mega_like_kernel (pallas_call in
//                                  _mega_like_raw)
//   the preconditioner   replaces  enterprise_warp_tpu/ops/cholfuse.py:
//                                  _chol_kernel (pallas_call in
//                                  _pallas_fused_raw)
//
// Per walker, on an equilibrated float32 Sn (n x n) and right-hand side
// Bn (n x k), the solve chain is:
//   1. three-tier jittered right-looking Cholesky Sn + j I = U^T U
//      (tier 2 re-factors with j2 only in blocks whose tier-1 factor went
//      non-finite; tier 3 is the identity);
//   2. V = U^-1 by back substitution;
//   3. the preconditioner solve Z0 = V V^T Bn and `refine` float32
//      residual passes Z += V V^T (Bn - Sn Z);
//   4. the divergence guard: keep Z only if its true residual is no
//      larger than the first pass's, else Z0, once per walker over all k
//      columns (up to KMAX columns, steps 3 and 4 run as skinny products
//      a row a thread or a warp; a wider right-hand side runs them as
//      tiled block products over all its columns at once);
//   5. ld = 2 sum log diag U + the 4-term trace expansion of
//      E = V^T (Sn - U^T U) V, applied only when ||E||_F^2 < 0.09.
// The likelihood pipeline first forms Sn = s (Ss^T Ss) s + diag(ivb), with
// Ss = S sqrt(w) from the shared (ntoa, nb) basis, then runs the chain on
// it (below, after the solve pipeline).
// The preconditioner runs steps 1 and 2 and forms E, and writes the trio
// (U, V, E) out: the preconditioner of the classic chain, whose
// refinement and logdet stay in float64 outside (ops/kernel.py). It has
// two designs, one block per walker each, chosen by the order:
// chol_precond_smem_kernel with the walker's matrices in shared memory
// for n <= PRECOND_SMEM_MAXN (the gradient path's n = 60), and
// chol_precond_kernel, every matrix in a global workspace, above it. The
// solve kernel runs the chain as a pipeline of phase launches (below,
// after the preconditioner). Every product is a float32 FMA loop, except
// the shared-memory preconditioner's D = Sn - U^T U, summed in float64:
// no tensor cores, no TF32 (the reference's dots run at
// Precision.HIGHEST).
//
// Bound on an H100 SXM: float32 work outside the tensor cores, peak
// 67 TFLOP/s. Counting only what the function needs, the solve chain is
// ~4 n^3 FLOP per walker: n^3/3 per Cholesky tier, n^3/3 for the
// triangular inverse, n^3/3 for U^T U (triangle times triangle), n^3
// each for V^T D and (V^T D) V, n^3 for the symmetric E E, plus the skinny
// solves. At the main path's shape (8 walkers, n = 250) that is
// ~0.53 GFLOP, ~8 us at peak, against ~2 MB of input and output (~0.6 us
// at 3.35 TB/s): operations bound. The likelihood kernel at (8 walkers,
// nb = 120, ntoa = 122) adds the symmetric ntoa nb^2 Gram: ~0.077 GFLOP,
// ~1.2 us at peak. The preconditioner kernel is the chain without E E and
// the solves, ~3 n^3 per walker: at the gradient path's shape (64 walkers,
// n = 60) 41 MFLOP, 0.62 us at peak, against one (64, 60, 60) input and
// three such outputs, 3.69 MB, 1.10 us at 3.35 TB/s: bytes bound. Neither
// bound is what holds it back: a walker is 14 KB per matrix and ~0.65
// MFLOP, and its time goes to the factor's and the inverse's 2n serial
// steps. Its shared-memory design keeps those steps off the block
// barrier and off global memory (below, after chol_precond_kernel).
// (chip_smoke.py computes every bound from each run's inputs.)
//
// What holds the solve kernel back on this card is not that bound but
// occupancy and serial depth. Run as one block per walker (the earlier
// mega_solve_kernel, still here as the A/B baseline), 8 walkers keep 8 of
// 132 SMs busy, and each SM works alone through the factorization and the
// inverse (2n barriered steps, the inverse's dependent FMA loops over V in
// L2) and four full n^3 products as 16 sequential 64 x 64 tiles. The
// pipeline spreads what parallelizes across walkers and tiles: each of
// the four products is one launch over a (64 x 64 output tile, walker)
// grid that skips the depth tiles where a triangular operand is zero
// (128 blocks at (8, 250)), and the inverse is one launch over a
// (32-column tile, walker) grid with its column tile in shared memory
// (64 blocks at (8, 250)). The factor, the skinny solves and the trace
// sums stay one block per walker; the factor's n barriered steps are then
// the longest serial chain. The likelihood pipeline reuses those phases
// and puts two of its own in front: the Gram on a (32 x 32 output tile,
// walker) grid, and the factor with the walker's whole working matrix in
// shared memory (nb <= 192); it runs the refine phase beside the logdet
// products on a second stream. The preconditioner's order is small enough
// for the opposite choice: one block holds the whole walker, and the
// steps of its factor and its inverse need no block barrier.

#include <cuda_runtime.h>
#include <math.h>

#include <mutex>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int MAXN = 448;    // largest matrix order (the reference's cap)
constexpr int KMAX = 8;      // widest right-hand-side panel
constexpr int TILE = 64;     // block GEMM output tile
constexpr int KT = 16;       // block GEMM depth step

struct Smem {
  float As[KT][TILE + 1];
  float Bs[KT][TILE + 1];
  float lvec[MAXN];
  float rhs[MAXN * KMAX];
  float red[NT / 32];
  int flag[2];   // one non-finite flag per Cholesky tier
};

__device__ float block_sum(float v, Smem& sm) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sm.red[wid] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = (threadIdx.x < NT / 32) ? sm.red[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
    if (threadIdx.x == 0) sm.red[0] = t;
  }
  __syncthreads();
  const float r = sm.red[0];
  __syncthreads();
  return r;
}

__device__ inline float fma_acc(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ inline double fma_acc(double a, double b, double c) {
  return fma(a, b, c);
}

// C (M x N, ldc) = C0 + alpha * op(A) op(B)   (C0 may be null: C = alpha AB)
// op(A)(i, m) = ta ? A[m * lda + i] : A[i * lda + m]
// op(B)(m, j) = tb ? B[j * ldb + m] : B[m * ldb + j]
// 64 x 64 output tiles, 4 x 4 outputs per thread, depth steps of 16. The
// products are summed, and C0 added, in Acc (float, or double for the
// refinement's residual), and C is rounded to float once.
template <typename Acc>
__device__ void block_gemm_acc(int M, int N, int K, const float* A, int lda,
                               bool ta, const float* B, int ldb, bool tb,
                               float* C, int ldc, float alpha,
                               const float* C0, int ldc0, Smem& sm) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tilesM = (M + TILE - 1) / TILE, tilesN = (N + TILE - 1) / TILE;
  for (int tile = 0; tile < tilesM * tilesN; ++tile) {
    const int i0 = (tile / tilesN) * TILE, j0 = (tile % tilesN) * TILE;
    Acc acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0;
    for (int k0 = 0; k0 < K; k0 += KT) {
#pragma unroll
      for (int r = 0; r < (TILE * KT) / NT; ++r) {
        const int e = tid + r * NT;
        int il, ml;
        if (ta) { il = e % TILE; ml = e / TILE; }
        else    { ml = e % KT;   il = e / KT; }
        const int i = i0 + il, m = k0 + ml;
        float v = 0.f;
        if (i < M && m < K) v = ta ? A[(size_t)m * lda + i] : A[(size_t)i * lda + m];
        sm.As[ml][il] = v;
        int jl, ml2;
        if (tb) { ml2 = e % KT;   jl = e / KT; }
        else    { jl = e % TILE;  ml2 = e / TILE; }
        const int j = j0 + jl, m2 = k0 + ml2;
        float u = 0.f;
        if (j < N && m2 < K) u = tb ? B[(size_t)j * ldb + m2] : B[(size_t)m2 * ldb + j];
        sm.Bs[ml2][jl] = u;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        float ar[4], br[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) ar[a] = sm.As[kk][ty + 16 * a];
#pragma unroll
        for (int b = 0; b < 4; ++b) br[b] = sm.Bs[kk][tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a][b] = fma_acc((Acc)ar[a], (Acc)br[b], acc[a][b]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      if (i >= M) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = j0 + tx + 16 * b;
        if (j >= N) continue;
        C[(size_t)i * ldc + j] = (float)(
            C0 ? fma_acc((Acc)alpha, acc[a][b], (Acc)C0[(size_t)i * ldc0 + j])
               : (Acc)alpha * acc[a][b]);
      }
    }
  }
  __syncthreads();
}

__device__ void block_gemm(int M, int N, int K, const float* A, int lda,
                           bool ta, const float* B, int ldb, bool tb,
                           float* C, int ldc, float alpha, const float* C0,
                           int ldc0, Smem& sm) {
  block_gemm_acc<float>(M, N, K, A, lda, ta, B, ldb, tb, C, ldc, alpha, C0,
                        ldc0, sm);
}

// The right-hand side is walked in panels of at most KMAX columns, so that
// sm.rhs and the per-row register accumulators keep their size whatever k
// is. A panel of a row-major (n x ld) matrix starts at column c0; callers
// pass the pointer offset by c0 and the panel width kp.

// sm.rhs (n x kp, dense) = the panel src (n x kp, row stride ld).
__device__ void load_rhs(const float* src, int n, int ld, int kp, Smem& sm) {
  for (int e = threadIdx.x; e < n * kp; e += NT) {
    const int m = e / kp;
    sm.rhs[e] = src[(size_t)m * ld + (e - m * kp)];
  }
  __syncthreads();
}

// C[i][c] = sum_m A[m * lda + i] * rhs[m][c] (C row stride ldc); `upper`: A
// upper triangular (only m <= i contribute). One thread per output row.
__device__ void skinny_t(int rows, int K, const float* A, int lda, int k,
                         bool upper, float* C, int ldc, Smem& sm) {
  for (int i = threadIdx.x; i < rows; i += NT) {
    float acc[KMAX];
#pragma unroll
    for (int c = 0; c < KMAX; ++c) acc[c] = 0.f;
    const int mend = upper ? min(i + 1, K) : K;
    for (int m = 0; m < mend; ++m) {
      const float a = A[(size_t)m * lda + i];
#pragma unroll
      for (int c = 0; c < KMAX; ++c)
        if (c < k) acc[c] = fmaf(a, sm.rhs[m * k + c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < KMAX; ++c)
      if (c < k) C[(size_t)i * ldc + c] = acc[c];
  }
  __syncthreads();
}

// C[i][c] = (sub ? sub[i][c] - acc : acc), acc = sum_m A[i * lda + m] rhs[m][c]
// (sub and C row stride ldc); `upper`: A upper triangular (only m >= i
// contribute). One warp per row.
__device__ void skinny_n(int rows, int K, const float* A, int lda, int k,
                         bool upper, const float* sub, float* C, int ldc,
                         Smem& sm) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int i = wid; i < rows; i += NT / 32) {
    float acc[KMAX];
#pragma unroll
    for (int c = 0; c < KMAX; ++c) acc[c] = 0.f;
    const float* Ai = A + (size_t)i * lda;
    for (int m = (upper ? i : 0) + lane; m < K; m += 32) {
      const float a = Ai[m];
#pragma unroll
      for (int c = 0; c < KMAX; ++c)
        if (c < k) acc[c] = fmaf(a, sm.rhs[m * k + c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < KMAX; ++c)
      for (int o = 16; o > 0; o >>= 1) acc[c] += __shfl_down_sync(0xffffffffu, acc[c], o);
    if (lane == 0) {
      const size_t r = (size_t)i * ldc;
#pragma unroll
      for (int c = 0; c < KMAX; ++c)
        if (c < k) C[r + c] = sub ? sub[r + c] - acc[c] : acc[c];
    }
  }
  __syncthreads();
}

// The refinement's residual R = sub - A rhs (A n x n, the panel in sm.rhs,
// kp <= KMAX columns; sub and R of row stride ldc), one warp per row as in
// skinny_n, but the products summed in double and the difference rounded
// to float once. A float32 residual leaves the refined Z at float32's
// floor, cond(Sn) eps |Z|, one pass's value or another's at random; this
// one takes Z to its float32 rounding (PERF.md, PR 13).
__device__ void residual_f64(int n, const float* A, int kp, const float* sub,
                             float* C, int ldc, Smem& sm) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int i = wid; i < n; i += NT / 32) {
    double acc[KMAX];
#pragma unroll
    for (int c = 0; c < KMAX; ++c) acc[c] = 0.0;
    const float* Ai = A + (size_t)i * n;
    for (int m = lane; m < n; m += 32) {
      const double a = Ai[m];
#pragma unroll
      for (int c = 0; c < KMAX; ++c)
        if (c < kp) acc[c] = fma(a, (double)sm.rhs[m * kp + c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < KMAX; ++c)
      for (int o = 16; o > 0; o >>= 1) acc[c] += __shfl_down_sync(0xffffffffu, acc[c], o);
    if (lane == 0) {
      const size_t r = (size_t)i * ldc;
#pragma unroll
      for (int c = 0; c < KMAX; ++c)
        if (c < kp) C[r + c] = (float)((double)sub[r + c] - acc[c]);
    }
  }
  __syncthreads();
}

// Right-looking Cholesky of Sn + jit I into the upper factor U (row k of U
// is column k of L). X is the working copy; only its upper triangle is
// maintained. Returns false as soon as a factor entry is non-finite (the
// reference's "any non-finite in U" test for the tier ladder). `tier` picks
// the flag slot; the caller zeroes both slots once, behind a barrier, so no
// thread can reset a flag another thread has still to read.
__device__ bool chol_upper(const float* Sn, float jit, float* X, float* U,
                           int n, int tier, Smem& sm) {
  for (int e = threadIdx.x; e < n * n; e += NT) {
    const int i = e / n, j = e - i * n;
    X[e] = Sn[e] + (i == j ? jit : 0.f);
    U[e] = 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int k = 0; k < n; ++k) {
    const float dkk = X[(size_t)k * n + k];
    const float ipiv = 1.0f / sqrtf(dkk);
    for (int j = k + threadIdx.x; j < n; j += NT) {
      const float v = X[(size_t)k * n + j] * ipiv;
      sm.lvec[j] = v;
      U[(size_t)k * n + j] = v;
      if (!isfinite(v)) sm.flag[tier] = 1;
    }
    __syncthreads();
    if (sm.flag[tier]) return false;
    for (int i = k + 1 + wid; i < n; i += NT / 32) {
      const float li = sm.lvec[i];
      float* Xi = X + (size_t)i * n;
      for (int j = i + lane; j < n; j += 32) Xi[j] = fmaf(-li, sm.lvec[j], Xi[j]);
    }
    __syncthreads();
  }
  return true;
}

// V = U^-1 (upper) by back substitution: row i from rows > i.
__device__ void backsub_inv(const float* U, float* V, int n, Smem& sm) {
  for (int e = threadIdx.x; e < n * n; e += NT) V[e] = 0.f;
  __syncthreads();
  for (int i = n - 1; i >= 0; --i) {
    for (int m = i + threadIdx.x; m < n; m += NT) sm.lvec[m] = U[(size_t)i * n + m];
    __syncthreads();
    const float dii = sm.lvec[i];
    for (int j = i + threadIdx.x; j < n; j += NT) {
      float acc = 0.f;
      for (int m = i + 1; m <= j; ++m) acc = fmaf(sm.lvec[m], V[(size_t)m * n + j], acc);
      V[(size_t)i * n + j] = ((i == j ? 1.f : 0.f) - acc) / dii;
    }
    __syncthreads();
  }
}

// out = V (V^T R) on one panel of kp <= KMAX columns: R and out panels of
// row stride ld in global memory, Tb (n x kp, dense) scratch.
__device__ void psolve(const float* V, const float* R, float* Tb, float* out,
                       int n, int ld, int kp, Smem& sm) {
  load_rhs(R, n, ld, kp, sm);
  skinny_t(n, n, V, n, kp, true, Tb, kp, sm);
  load_rhs(Tb, n, kp, kp, sm);
  skinny_n(n, n, V, n, kp, true, nullptr, out, ld, sm);
}

// Sum of squares of one (n x kp) panel of row stride ld, over the block.
__device__ float panel_sq(const float* R, int n, int ld, int kp, Smem& sm) {
  float p = 0.f;
  for (int e = threadIdx.x; e < n * kp; e += NT) {
    const int m = e / kp;
    const float r = R[(size_t)m * ld + (e - m * kp)];
    p = fmaf(r, r, p);
  }
  return block_sum(p, sm);
}

__device__ __host__ inline long long solve_ws(int n, int k) {
  return 5LL * n * n + 5LL * n * k;
}

// The shared chain (steps 1-5 above) for one walker.
__device__ void solve_chain(const float* Sn, const float* Bw, float* Zout,
                            float* ldout, int* tierout, float* ws, int n,
                            int k, float j1, float j2, int refine, Smem& sm) {
  const size_t nn = (size_t)n * n, nk = (size_t)n * k;
  float* X = ws;
  float* U = X + nn;
  float* V = U + nn;
  float* W1 = V + nn;
  float* W2 = W1 + nn;
  float* Tb = W2 + nn;
  float* Z0 = Tb + nk;
  float* Zc = Z0 + nk;
  float* R = Zc + nk;
  float* D = R + nk;

  if (threadIdx.x == 0) sm.flag[0] = sm.flag[1] = 0;
  __syncthreads();
  int tier = 1;
  bool ok = chol_upper(Sn, j1, X, U, n, 0, sm);
  if (!ok) {
    tier = 2;
    ok = chol_upper(Sn, j2, X, U, n, 1, sm);
  }
  if (!ok) {
    tier = 3;
    for (int e = threadIdx.x; e < (int)nn; e += NT) {
      const int i = e / n, j = e - i * n;
      U[e] = (i == j) ? 1.f : 0.f;
    }
    __syncthreads();
  }
  backsub_inv(U, V, n, sm);

  // preconditioner solve, refinement, divergence guard
  psolve(V, Bw, Tb, Z0, n, k, k, sm);
  for (int e = threadIdx.x; e < (int)nk; e += NT) Zc[e] = Z0[e];
  __syncthreads();
  float res_pre = 0.f;
  for (int it = 0; it < refine; ++it) {
    load_rhs(Zc, n, k, k, sm);
    skinny_n(n, n, Sn, n, k, false, Bw, R, k, sm);
    if (it == 0) res_pre = panel_sq(R, n, k, k, sm);
    psolve(V, R, Tb, D, n, k, k, sm);
    for (int e = threadIdx.x; e < (int)nk; e += NT) Zc[e] += D[e];
    __syncthreads();
  }
  load_rhs(Zc, n, k, k, sm);
  skinny_n(n, n, Sn, n, k, false, Bw, R, k, sm);
  const float res_ref = panel_sq(R, n, k, k, sm);
  if (refine == 0) res_pre = res_ref;
  const bool keep = res_ref <= res_pre;   // NaN -> keep the plain solve
  for (int e = threadIdx.x; e < (int)nk; e += NT) Zout[e] = keep ? Zc[e] : Z0[e];

  // logdet: E = V^T (Sn - U^T U) V and its 4-term trace expansion
  block_gemm(n, n, n, U, n, true, U, n, false, W1, n, -1.f, Sn, n, sm);
  block_gemm(n, n, n, V, n, true, W1, n, false, W2, n, 1.f, nullptr, 0, sm);
  block_gemm(n, n, n, W2, n, false, V, n, false, W1, n, 1.f, nullptr, 0, sm);
  block_gemm(n, n, n, W1, n, false, W1, n, false, X, n, 1.f, nullptr, 0, sm);
  const float* E = W1;
  const float* E2 = X;
  float tr = 0.f, see_t = 0.f, s2e_t = 0.f, s22_t = 0.f, see = 0.f, sld = 0.f;
  for (int e = threadIdx.x; e < (int)nn; e += NT) {
    const int i = e / n, j = e - i * n;
    const size_t et = (size_t)j * n + i;
    const float eij = E[e];
    if (i == j) {
      tr += eij;
      sld += logf(U[e]);
    }
    see_t = fmaf(eij, E[et], see_t);
    s2e_t = fmaf(E2[e], E[et], s2e_t);
    s22_t = fmaf(E2[e], E2[et], s22_t);
    see = fmaf(eij, eij, see);
  }
  tr = block_sum(tr, sm);
  see_t = block_sum(see_t, sm);
  s2e_t = block_sum(s2e_t, sm);
  s22_t = block_sum(s22_t, sm);
  see = block_sum(see, sm);
  sld = block_sum(sld, sm);
  float corr = tr - see_t / 2.0f + s2e_t / 3.0f - s22_t / 4.0f;
  if (!(see < 0.09f)) corr = 0.f;
  if (threadIdx.x == 0) {
    *ldout = 2.0f * sld + corr;
    *tierout = tier;
  }
}

__global__ void __launch_bounds__(NT)
mega_solve_kernel(const float* __restrict__ Sn, const float* __restrict__ Bn,
                  float* Z, float* ld, int* tier, float* ws, int n, int k,
                  float j1, float j2, int refine) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  const size_t nn = (size_t)n * n, nk = (size_t)n * k;
  solve_chain(Sn + b * nn, Bn + b * nk, Z + b * nk, ld + b, tier + b,
              ws + (size_t)b * solve_ws(n, k), n, k, j1, j2, refine, sm);
}

// The one-block Gram prologue of one walker: Ss = S sqrt(w) (rows) into the
// global scratch Ss, G = Ss^T Ss, Sn = s G s + diag(ivb).
__device__ void like_gram_block(const float* S, const float* wb,
                                const float* sb, const float* ivbb,
                                float* Snb, float* Ss, int ntoa, int nb,
                                Smem& sm) {
  for (int e = threadIdx.x; e < ntoa * nb; e += NT) {
    const int t = e / nb;
    Ss[e] = S[e] * sqrtf(wb[t]);
  }
  __syncthreads();
  block_gemm(nb, nb, ntoa, Ss, nb, true, Ss, nb, false, Snb, nb, 1.f, nullptr, 0, sm);
  // Sigma assembly on the equilibrated scales: Sn = s G s + diag(ivb)
  for (int e = threadIdx.x; e < nb * nb; e += NT) {
    const int i = e / nb, j = e - i * nb;
    const float g = __fmul_rn(__fmul_rn(Snb[e], sb[i]), sb[j]);
    Snb[e] = __fadd_rn(g, i == j ? ivbb[i] : 0.f);
  }
  __syncthreads();
}

__device__ __host__ inline long long like_single_block_ws(int ntoa, int nb,
                                                          int k) {
  return solve_ws(nb, k) + (long long)nb * nb + (long long)ntoa * nb;
}

// The earlier single-launch likelihood kernel: one block per walker runs
// the Gram prologue and the whole chain (solve_chain). Kept only as the A/B
// baseline of chip_smoke.py.
__global__ void __launch_bounds__(NT)
mega_like_kernel(const float* __restrict__ S, const float* __restrict__ w,
                 const float* __restrict__ s, const float* __restrict__ ivb,
                 const float* __restrict__ Bn, float* Z, float* ld, int* tier,
                 float* ws, int ntoa, int nb, int k, float j1, float j2,
                 int refine) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  const size_t nn = (size_t)nb * nb, nk = (size_t)nb * k;
  float* wsb = ws + (size_t)b * like_single_block_ws(ntoa, nb, k);
  float* Snb = wsb + solve_ws(nb, k);
  like_gram_block(S, w + (size_t)b * ntoa, s + (size_t)b * nb,
                  ivb + (size_t)b * nb, Snb, Snb + nn, ntoa, nb, sm);
  solve_chain(Snb, Bn + b * nk, Z + b * nk, ld + b, tier + b, wsb, nb, k, j1,
              j2, refine, sm);
}

// The Gram prologue alone, one block per walker, into the (B, nb, nb) Sn
// buffer (Ss: B ntoa nb floats of scratch): the Gram phase of
// chip_smoke.py's Stage A table.
__global__ void __launch_bounds__(NT)
like_gram_block_kernel(const float* __restrict__ S,
                       const float* __restrict__ w,
                       const float* __restrict__ s,
                       const float* __restrict__ ivb, float* Sn, float* Ss,
                       int ntoa, int nb) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  like_gram_block(S, w + (size_t)b * ntoa, s + (size_t)b * nb,
                  ivb + (size_t)b * nb, Sn + (size_t)b * nb * nb,
                  Ss + (size_t)b * ntoa * nb, ntoa, nb, sm);
}

// Workspace of one preconditioner walker: X, the Cholesky working copy,
// reused for V^T (Sn - U^T U) once the factor is done.
__device__ __host__ inline long long chol_ws(int n) { return (long long)n * n; }

// The large-order preconditioner (n > PRECOND_SMEM_MAXN): one block per
// walker on the block-level routines, every matrix in global memory.
__global__ void __launch_bounds__(NT)
chol_precond_kernel(const float* __restrict__ Sn, float* U, float* V,
                    float* E, int* tier, float* ws, int n, float j1,
                    float j2) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  const size_t nn = (size_t)n * n;
  const float* S = Sn + b * nn;
  float* Ub = U + b * nn;
  float* Vb = V + b * nn;
  float* Eb = E + b * nn;
  float* X = ws + (size_t)b * chol_ws(n);

  if (threadIdx.x == 0) sm.flag[0] = sm.flag[1] = 0;
  __syncthreads();
  int t = 1;
  bool ok = chol_upper(S, j1, X, Ub, n, 0, sm);
  if (!ok) {
    t = 2;
    ok = chol_upper(S, j2, X, Ub, n, 1, sm);
  }
  if (!ok) {
    t = 3;
    for (int e = threadIdx.x; e < (int)nn; e += NT) {
      const int i = e / n, j = e - i * n;
      Ub[e] = (i == j) ? 1.f : 0.f;
    }
    __syncthreads();
  }
  backsub_inv(Ub, Vb, n, sm);
  // E = V^T (Sn - U^T U) V; the residual D = Sn - U^T U is staged in E
  block_gemm(n, n, n, Ub, n, true, Ub, n, false, Eb, n, -1.f, S, n, sm);
  block_gemm(n, n, n, Vb, n, true, Eb, n, false, X, n, 1.f, nullptr, 0, sm);
  block_gemm(n, n, n, X, n, false, Vb, n, false, Eb, n, 1.f, nullptr, 0, sm);
  if (threadIdx.x == 0) tier[b] = t;
}

// Above 48 KB a block's dynamic shared memory must be asked for, once per
// device and kernel.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, bool (&ready)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  return 0;
}

// ---- the preconditioner with its walker resident in shared memory ------
//
// chol_precond_smem_kernel, one block per walker, n <= PRECOND_SMEM_MAXN.
// Three buffers hold the walker:
//   X   U, row-major, zeros below the diagonal; K once U is written out
//   Vt  V = U^-1 transposed, Vt[j][m] = V[m][j]; before the inverse, the
//       factor's transposed working copy Ut, Ut[j][m] = U[m][j]
//   Ds  Sn, then D = Sn - U^T U in place (row stride n)
// X and Vt have row stride precond_ldt(n) and zeros past column n. Nothing
// else of the walker touches global memory: Sn is read once, U, V and E
// are written once each, coalesced (E straight from the product's
// registers). Phases, split by block barriers:
//   1. factor   on the first ceil(n / 32) warps, a column a thread, row by
//               row in Ut; each entry's fmaf chain is the one
//               chol_upper's rank-1 steps apply to it, in the same order,
//               so U is chol_upper's bit for bit. One barrier of those
//               warps a row, no block barrier. The tier ladder as in
//               chol_precond_kernel: tier 2 re-loads Sn + j2 I only in a
//               block whose tier 1 went non-finite, tier 3 is the
//               identity. Then U into X.
//   2. inverse  on the same warps, thread j < n runs column j of
//               backsub_inv (V[i][j] from the diagonal up, its sum over m
//               ascending), so V is backsub_inv's bit for bit, with no
//               synchronisation between rows: a column depends only on
//               itself. Its time is the last column's chain of short
//               sums, each waiting on the division before it.
//      and D    at the same time on the other warps, 4 x 4 register
//               micro-tiles of 64 x 64 output tiles: each entry summed in
//               float64 (exact float32 products) over m <= min(i, j) and
//               rounded once. D is the Cholesky residual, a cancellation
//               of nearly equal terms: summed in float32 its rounding,
//               multiplied by |V|^2 in V^T D V, was most of E's distance
//               from float64 on ill-conditioned walkers (chip_smoke.py
//               prints E's error product by product).
//   3. K = V^T D, 4. E = K V   float32, block_gemm's per-entry order (one
//               fmaf accumulator, m ascending; the depth where V is
//               exactly zero is skipped).
// The template argument PHASES stops the chain after phase 1..4 so that
// chip_smoke.py can time each phase by difference (after phase 2 or 3, E
// receives D or K); the package launches only the whole chain, PHASES = 4.
//
// Sums of float32 FMAs here may take extra terms that are exact zeros
// (padding, a triangle's zeros, a V entry not formed yet, a masked term):
// a sum that starts at +0 is never -0, and adding +0 or -0 to it changes
// no bit, so the sum is the one without those terms.

constexpr int PRECOND_SMEM_MAXN = 128;
constexpr int PRECOND_PHASES = 4;
static_assert(PRECOND_SMEM_MAXN <= NT - 32,
              "the factor and the inverse take a column a thread, and D "
              "needs a warp of its own");

// Row stride of X, Vt and Ut: the least stride >= n whose quarter is odd,
// so rows are 16-byte aligned and eight threads reading 16 bytes each from
// eight consecutive rows hit 32 distinct banks.
__device__ __host__ inline int precond_ldt(int n) { return ((n + 3) & ~7) + 4; }

// X and Vt (n rows of precond_ldt(n)), Ds (n x n), and 32 floats a masked
// block may read past the last row of Ut or X.
size_t precond_smem(int n) {
  return sizeof(float) *
         (2 * (size_t)n * precond_ldt(n) + (size_t)n * n + 32);
}

// bar.sync / bar.red.or over the factor's threads (named barrier 1,
// `threads` a multiple of 32); the second also returns whether any of them
// passed true.
__device__ inline void factor_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

__device__ inline bool factor_any(bool p, int threads) {
  int r;
  asm volatile(
      "{\n\t.reg .pred pi, po;\n\tsetp.ne.s32 pi, %1, 0;\n\t"
      "bar.red.or.pred po, 1, %2, pi;\n\tselp.s32 %0, 1, 0, po;\n}"
      : "=r"(r)
      : "r"((int)p), "r"(threads)
      : "memory");
  return r != 0;
}

// Terms m0 .. m0 + 4 Q - 1 of the chains x (column j) and xkk (column k):
// 2 Q 16-byte loads first, then the FMAs in order; MASKED zeroes the
// operands of the terms at m >= k.
template <int Q, bool MASKED>
__device__ inline void chain_block(const float* Uk, const float* Uj, int m0,
                                   int k, float& x, float& xkk) {
  float4 a[Q], c[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    a[q] = *reinterpret_cast<const float4*>(Uk + m0 + 4 * q);
    c[q] = *reinterpret_cast<const float4*>(Uj + m0 + 4 * q);
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float av[4] = {a[q].x, a[q].y, a[q].z, a[q].w};
    const float cv[4] = {c[q].x, c[q].y, c[q].z, c[q].w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool live = !MASKED || m0 + 4 * q + r < k;
      const float ak = live ? av[r] : 0.f, cj = live ? cv[r] : 0.f;
      x = fmaf(-ak, cj, x);
      xkk = fmaf(-ak, ak, xkk);
    }
  }
}

// chol_upper's factor, row by row, on threads 0 .. 32 ceil(n / 32) - 1
// (thread j owns column j), in the transposed working copy Ut (row stride
// ldt) that holds Sn + jit I's upper triangle on entry (Ut[j][k] = X[k][j],
// j >= k). Step k forms row k of U from the rows above it,
//   x_kj = X[k][j] - sum_{m < k} U[m][k] U[m][j]   (j >= k),
//   U[k][j] = x_kj / sqrt(x_kk)                      (x_kj * ipiv),
// each x_kj one fmaf chain over m ascending, fmaf(-U[m][k], U[m][j], x):
// the operations chol_upper's rank-1 steps apply to entry (k, j), in the
// same order, so U is chol_upper's bit for bit. Both operands of a term
// run along rows of Ut, so 32 terms come in as 16 16-byte loads ahead of
// their FMAs (a chain holds no store). Every thread forms x_kk
// itself (the same chain on the same operands), so the pivot needs no
// broadcast; U's diagonal, which no chain reads, is stored after the last
// step, so no thread overwrites an x_kk another still reads, and the next
// row's x and x_kk are fetched before the row's barrier. One barrier a
// row; every eighth (and the last) also votes on whether a row since the
// last vote held a non-finite entry: the factor fails exactly when
// chol_upper's does, a few rows later at most. Threads past n, and columns
// already done, compute on clamped operands and store nothing.
__device__ bool chol_upper_cols(float* Ut, int n, int ldt) {
  const int t = threadIdx.x, jc = min(t, n - 1);
  const int threads = 32 * ((n + 31) / 32);
  const float* Uj = Ut + jc * ldt;
  float diag = 0.f;
  bool bad = false;
  float x = Uj[0], xkk = Ut[0];
  for (int k = 0; k < n; ++k) {
    const float* Uk = Ut + k * ldt;
    int m0 = 0;
    for (; m0 + 32 <= k; m0 += 32) chain_block<8, false>(Uk, Uj, m0, k, x, xkk);
    if (k - m0 > 16)
      chain_block<8, true>(Uk, Uj, m0, k, x, xkk);
    else if (k > m0)
      chain_block<4, true>(Uk, Uj, m0, k, x, xkk);
    // 1.0f / sqrtf(x_kk), both correctly rounded, as in chol_upper
    const float ipiv = __frcp_rn(__fsqrt_rn(xkk));
    if (t >= k && t < n) {
      const float v = x * ipiv;
      if (t == k)
        diag = v;
      else
        Ut[t * ldt + k] = v;
      bad |= !isfinite(v);
    }
    const int k1 = min(k + 1, n - 1);
    x = Uj[k1];
    xkk = Ut[k1 * ldt + k1];
    if ((k & 7) == 7 || k == n - 1) {
      if (factor_any(bad, threads)) return false;
    } else {
      factor_sync(threads);
    }
  }
  if (t < n) Ut[t * ldt + t] = diag;
  return true;
}

// Sn + jit I's upper triangle into the factor's transposed copy:
// Ut[j][k] = Sn[k][j] + jit delta_kj for j >= k (Ds holds Sn).
__device__ void load_factor_copy(const float* Ds, float jit, float* Ut,
                                 int n, int ldt, int tid, int threads) {
  for (int e = tid; e < n * n; e += threads) {
    const int k = e / n, j = e - k * n;
    if (j >= k) Ut[j * ldt + k] = Ds[e] + (k == j ? jit : 0.f);
  }
}

// Output (i, j) of micro-tile entry (a, b) in the 64 x 64 tile at (i0, j0):
// rows ty + 16 a, columns tx + 16 b, as block_gemm's (u = 16 ty + tx, by
// default the thread's index).
struct MicroTile {
  int i[4], j[4];    // clamped to n - 1 for loads
  bool ok[4][4];     // inside the n x n output
  __device__ MicroTile(int i0, int j0, int n, int u = threadIdx.x) {
    const int tx = u & 15, ty = u >> 4;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      i[a] = min(i0 + ty + 16 * a, n - 1);
      j[a] = min(j0 + tx + 16 * a, n - 1);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        ok[a][b] = i0 + ty + 16 * a < n && j0 + tx + 16 * b < n;
  }
};

// D = Sn - U^T U in place over Sn (Ds, row stride n), U upper triangular
// in X (row stride ldx), on `threads` threads from index `tid`: each takes
// micro-tiles tid, tid + threads, ... of all output tiles. Each entry a
// float64 sum over m <= min(i, j) (the products of float32 values are
// exact), rounded once.
__device__ void precond_residual(const float* X, int ldx, float* Ds, int n,
                                 int tid, int threads) {
  const int tiles = (n + TILE - 1) / TILE;
  for (int u = tid; u < tiles * tiles * NT; u += threads) {
    const int t = u / NT;
    const int i0 = (t / tiles) * TILE, j0 = (t % tiles) * TILE;
    const MicroTile mt(i0, j0, n, u % NT);
    const int depth = min(n, min(i0, j0) + TILE);
    double acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.0;
#pragma unroll 1
    for (int m = 0; m < depth; ++m) {
      const float* Xm = X + m * ldx;
      double ar[4], br[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ar[a] = Xm[mt.i[a]];
#pragma unroll
      for (int b = 0; b < 4; ++b) br[b] = Xm[mt.j[b]];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fma(ar[a], br[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (mt.ok[a][b]) {
          float* d = Ds + mt.i[a] * n + mt.j[b];
          *d = (float)((double)*d - acc[a][b]);
        }
  }
}

// C (row stride ldc) = A B on shared-memory operands: A[i][m] =
// A[i * lda + m]; B[m][j] = TB ? B[j * ldb + m] : B[m * ldb + j]. The
// depth stops where a triangular operand is exactly zero: ROWS, m <= i
// (K = V^T D, A = Vt); else m <= j (E = K V, B = Vt).
template <bool TB, bool ROWS>
__device__ void precond_product(const float* A, int lda, const float* B,
                                int ldb, float* C, int ldc, int n) {
  const int tiles = (n + TILE - 1) / TILE;
  for (int t = 0; t < tiles * tiles; ++t) {
    const int i0 = (t / tiles) * TILE, j0 = (t % tiles) * TILE;
    const MicroTile mt(i0, j0, n);
    const int depth = min(n, (ROWS ? i0 : j0) + TILE);
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 4
    for (int m = 0; m < depth; ++m) {
      float ar[4], br[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ar[a] = A[mt.i[a] * lda + m];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        br[b] = TB ? B[mt.j[b] * ldb + m] : B[m * ldb + mt.j[b]];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ar[a], br[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (mt.ok[a][b]) C[(size_t)mt.i[a] * ldc + mt.j[b]] = acc[a][b];
  }
}

// V = U^-1 into Vt (V transposed), U in X, both of row stride ldt: thread
// j < n takes column j of V, a row of Vt, from the diagonal up,
//   V[i][j] = (delta_ij - sum_{m = i+1}^{j} U[i][m] V[m][j]) / U[i][i],
// backsub_inv's operations with the sum over m ascending, so V is
// backsub_inv's bit for bit. A column depends only on itself, so rows
// need no synchronisation; its time is the chain of short sums, each
// waiting on the division before it. The sum runs over 16-byte aligned
// blocks of eight terms, four 16-byte loads ahead of the FMAs; the terms
// outside i < m <= j are exact zeros (U's lower triangle; Vt's row,
// zeroed first, not yet formed at m <= i; past j both operands are
// zeroed, as a block may reach past the row).
__device__ void precond_inverse(const float* X, float* Vt, int n, int ldt) {
  const int j = threadIdx.x;
  if (j >= n) return;
  float* Vj = Vt + j * ldt;
  for (int m = 0; m < ldt; m += 4)
    *reinterpret_cast<float4*>(Vj + m) = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = j; i >= 0; --i) {
    const float* Ui = X + i * ldt;
    float acc = 0.f;
    for (int m0 = (i + 1) & ~3; m0 <= j; m0 += 8) {
      float4 u[2], v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        u[q] = *reinterpret_cast<const float4*>(Ui + m0 + 4 * q);
        v[q] = *reinterpret_cast<const float4*>(Vj + m0 + 4 * q);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float uv[4] = {u[q].x, u[q].y, u[q].z, u[q].w};
        const float vv[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const bool live = m0 + 4 * q + r <= j;
          acc = fmaf(live ? uv[r] : 0.f, live ? vv[r] : 0.f, acc);
        }
      }
    }
    Vj[i] = ((i == j ? 1.f : 0.f) - acc) / Ui[i];
  }
}

template <int PHASES>
__global__ void __launch_bounds__(NT)
chol_precond_smem_kernel(const float* __restrict__ Sn, float* U, float* V,
                         float* E, int* tier, int n, float j1, float j2) {
  extern __shared__ float4 walker4[];
  const int nn = n * n, ldt = precond_ldt(n);
  float* X = reinterpret_cast<float*>(walker4);
  float* Vt = X + n * ldt;
  float* Ds = Vt + n * ldt;
  float* Ut = Vt;   // the factor's transposed copy, before V
  const int b = blockIdx.x;
  const float* S = Sn + (size_t)b * nn;
#pragma unroll 4
  for (int e = threadIdx.x; e < nn; e += NT) {
    const int k = e / n, j = e - k * n;
    const float s = S[e];
    Ds[e] = s;
    if (j >= k) Ut[j * ldt + k] = s + (k == j ? j1 : 0.f);
  }
  __syncthreads();

  // 1. the factor, a column a thread on the first ceil(n / 32) warps
  const int threads = 32 * ((n + 31) / 32);
  int t = 1;
  if (threadIdx.x < threads) {
    bool ok = chol_upper_cols(Ut, n, ldt);
    if (!ok) {
      t = 2;
      load_factor_copy(Ds, j2, Ut, n, ldt, threadIdx.x, threads);
      factor_sync(threads);
      ok = chol_upper_cols(Ut, n, ldt);
    }
    if (!ok) t = 3;
  }
  if (threadIdx.x == 0) tier[b] = t;
  // U into X, row-major, zeros below the diagonal and past column n (tier
  // 3: the identity)
  const bool identity = __syncthreads_or(t == 3);
  for (int e = threadIdx.x; e < n * ldt; e += NT) {
    const int i = e / ldt, j = e - i * ldt;
    X[e] = j >= n ? 0.f
                  : identity ? (i == j ? 1.f : 0.f)
                             : (j >= i ? Ut[j * ldt + i] : 0.f);
  }
  __syncthreads();

  // 2. the inverse on the first ceil(n / 32) warps, D = Sn - U^T U on the
  // others, at the same time (D needs only U)
  if (PHASES >= 2) {
    if (threadIdx.x < threads)
      precond_inverse(X, Vt, n, ldt);
    else
      precond_residual(X, ldt, Ds, n, threadIdx.x - threads, NT - threads);
    __syncthreads();
  }
  const size_t off = (size_t)b * nn;
  for (int e = threadIdx.x; e < nn; e += NT) {
    const int i = e / n, j = e - i * n;
    U[off + e] = X[i * ldt + j];
    if (PHASES >= 2) V[off + e] = Vt[j * ldt + i];
    if (PHASES == 2) E[off + e] = Ds[e];
  }
  // 3. K = V^T D into X (U is out), 4. E = K V, from the registers to
  // global memory
  if (PHASES >= 3) {
    __syncthreads();
    precond_product<false, true>(Vt, ldt, Ds, n, X, ldt, n);
    __syncthreads();
    if (PHASES == 3)
      for (int e = threadIdx.x; e < nn; e += NT)
        E[off + e] = X[(e / n) * ldt + e % n];
  }
  if (PHASES >= 4) precond_product<true, false>(X, ldt, Vt, ldt, E + off, n, n);
}

// One launch of the chain up to phase P, each instantiation opted in to
// its shared memory once per device.
template <int P>
int precond_smem_run(const float* Sn, float* U, float* V, float* E, int* tier,
                     int B, int n, float j1, float j2, void* stream) {
  if (B <= 0 || n <= 0 || n > PRECOND_SMEM_MAXN)
    return (int)cudaErrorInvalidValue;
  static bool ready[64];
  const int rc = allow_smem(chol_precond_smem_kernel<P>,
                            precond_smem(PRECOND_SMEM_MAXN), ready);
  if (rc != 0) return rc;
  chol_precond_smem_kernel<P>
      <<<B, NT, precond_smem(n), (cudaStream_t)stream>>>(Sn, U, V, E, tier, n,
                                                         j1, j2);
  return (int)cudaGetLastError();
}

// ---- the solve pipeline: solve_chain as a sequence of phase launches ----
//
// Each phase is its own launch on one per-walker workspace laid out as
// solve_chain's (solve_ws floats per walker), in this order:
//   factor    grid (B)                the tier ladder through chol_upper:
//                                     U, tier
//   inverse   grid (ceil(n/CT), B)    V = U^-1, one column tile per block
//   refine    grid (B)                psolve, the refinement passes, the
//                                     guard: Z (skinny panels for k <=
//                                     KMAX, tiled products above)
//   product   grid (tiles^2, B), x4   W1 = Sn - U^T U, W2 = V^T W1,
//                                     W1 = W2 V (= E), X = W1 W1 (= E^2),
//                                     one launch each
//   logdet    grid (B)                the trace sums: ld
// solve_inverse_block_kernel and solve_product_block_kernel run the inverse
// and the products on the one-block routines (backsub_inv, block_gemm over
// all tiles): the baseline of chip_smoke.py's per-phase A/B.

struct SolveWs {
  float *X, *U, *V, *W1, *W2, *Tb, *Z0, *Zc, *R, *D;
};

__device__ SolveWs solve_ws_at(float* ws, int b, int n, int k) {
  const size_t nn = (size_t)n * n, nk = (size_t)n * k;
  SolveWs w;
  w.X = ws + (size_t)b * solve_ws(n, k);
  w.U = w.X + nn;
  w.V = w.U + nn;
  w.W1 = w.V + nn;
  w.W2 = w.W1 + nn;
  w.Tb = w.W2 + nn;
  w.Z0 = w.Tb + nk;
  w.Zc = w.Z0 + nk;
  w.R = w.Zc + nk;
  w.D = w.R + nk;
  return w;
}

__global__ void __launch_bounds__(NT)
solve_factor_kernel(const float* __restrict__ Sn, int* tier, float* ws, int n,
                    int k, float j1, float j2) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  const SolveWs w = solve_ws_at(ws, b, n, k);
  const float* S = Sn + (size_t)b * n * n;
  if (threadIdx.x == 0) sm.flag[0] = sm.flag[1] = 0;
  __syncthreads();
  int t = 1;
  bool ok = chol_upper(S, j1, w.X, w.U, n, 0, sm);
  if (!ok) {
    t = 2;
    ok = chol_upper(S, j2, w.X, w.U, n, 1, sm);
  }
  if (!ok) {
    t = 3;
    for (int e = threadIdx.x; e < n * n; e += NT) {
      const int i = e / n, j = e - i * n;
      w.U[e] = (i == j) ? 1.f : 0.f;
    }
  }
  if (threadIdx.x == 0) tier[b] = t;
}

__global__ void __launch_bounds__(NT)
solve_inverse_block_kernel(float* ws, int n, int k) {
  __shared__ Smem sm;
  const SolveWs w = solve_ws_at(ws, blockIdx.x, n, k);
  backsub_inv(w.U, w.V, n, sm);
}

// The refined solve, one block per walker, on skinny products over the
// right-hand side in panels of at most KMAX columns: the refine phase for
// k <= KMAX (one panel), and for any k the baseline of chip_smoke.py's
// refine A/B (the panels in series). Refinement is column by column, so a
// panel's Z does not depend on the others; the divergence guard is the
// walker's, over all k columns: both residual norms are summed across the
// panels before Z or Z0 is chosen for the whole Z. The residual is summed
// in double (residual_f64).
__global__ void __launch_bounds__(NT)
solve_refine_kernel(const float* __restrict__ Sn, const float* __restrict__ Bn,
                    float* Z, float* ws, int n, int k, int refine) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  const int nk = n * k;
  const SolveWs w = solve_ws_at(ws, b, n, k);
  const float* S = Sn + (size_t)b * n * n;
  const float* Bw = Bn + (size_t)b * nk;
  float res_pre = 0.f, res_ref = 0.f;
  for (int c0 = 0; c0 < k; c0 += KMAX) {
    const int kp = min(KMAX, k - c0);
    const float* Bp = Bw + c0;
    float* Z0 = w.Z0 + c0;
    float* Zc = w.Zc + c0;
    float* R = w.R + c0;
    float* D = w.D + c0;
    psolve(w.V, Bp, w.Tb, Z0, n, k, kp, sm);
    for (int e = threadIdx.x; e < n * kp; e += NT) {
      const int m = e / kp;
      const size_t x = (size_t)m * k + (e - m * kp);
      Zc[x] = Z0[x];
    }
    __syncthreads();
    for (int it = 0; it < refine; ++it) {
      load_rhs(Zc, n, k, kp, sm);
      residual_f64(n, S, kp, Bp, R, k, sm);
      if (it == 0) res_pre += panel_sq(R, n, k, kp, sm);
      psolve(w.V, R, w.Tb, D, n, k, kp, sm);
      for (int e = threadIdx.x; e < n * kp; e += NT) {
        const int m = e / kp;
        const size_t x = (size_t)m * k + (e - m * kp);
        Zc[x] += D[x];
      }
      __syncthreads();
    }
    load_rhs(Zc, n, k, kp, sm);
    residual_f64(n, S, kp, Bp, R, k, sm);
    res_ref += panel_sq(R, n, k, kp, sm);
  }
  if (refine == 0) res_pre = res_ref;
  const bool keep = res_ref <= res_pre;   // NaN -> keep the plain solve
  float* Zb = Z + (size_t)b * nk;
  for (int e = threadIdx.x; e < nk; e += NT) Zb[e] = keep ? w.Zc[e] : w.Z0[e];
}

// The refine phase for k > KMAX, one block per walker: each product of
// the chain over all k columns at once on block_gemm's 64 x 64 tiles
// (T = V^T B, Z0 = V T; R = B - Sn Z summed in double, T = V^T R, D = V T
// per pass), then the walker's guard. The skinny panels do a row's sum a
// thread, or a warp and a shuffle tree, per 8 columns; the tiles do 4 x 4
// outputs a thread, about three times the panels' rate at (360, 100, 100),
// k 44 (PERF.md). Z is refined in place in the output.
__global__ void __launch_bounds__(NT)
solve_refine_tiled_kernel(const float* __restrict__ Sn,
                          const float* __restrict__ Bn, float* Z, float* ws,
                          int n, int k, int refine) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  const int nk = n * k;
  const SolveWs w = solve_ws_at(ws, b, n, k);
  const float* S = Sn + (size_t)b * n * n;
  const float* Bw = Bn + (size_t)b * nk;
  float* Zc = Z + (size_t)b * nk;
  block_gemm(n, k, n, w.V, n, true, Bw, k, false, w.Tb, k, 1.f, nullptr, 0,
             sm);
  block_gemm(n, k, n, w.V, n, false, w.Tb, k, false, w.Z0, k, 1.f, nullptr,
             0, sm);
  for (int e = threadIdx.x; e < nk; e += NT) Zc[e] = w.Z0[e];
  __syncthreads();
  float res_pre = 0.f;
  for (int it = 0; it < refine; ++it) {
    block_gemm_acc<double>(n, k, n, S, n, false, Zc, k, false, w.R, k, -1.f,
                           Bw, k, sm);
    if (it == 0) res_pre = panel_sq(w.R, n, k, k, sm);
    block_gemm(n, k, n, w.V, n, true, w.R, k, false, w.Tb, k, 1.f, nullptr,
               0, sm);
    block_gemm(n, k, n, w.V, n, false, w.Tb, k, false, w.D, k, 1.f, nullptr,
               0, sm);
    for (int e = threadIdx.x; e < nk; e += NT) Zc[e] += w.D[e];
    __syncthreads();
  }
  block_gemm_acc<double>(n, k, n, S, n, false, Zc, k, false, w.R, k, -1.f,
                         Bw, k, sm);
  const float res_ref = panel_sq(w.R, n, k, k, sm);
  if (refine == 0) res_pre = res_ref;
  if (!(res_ref <= res_pre))   // NaN -> keep the plain solve
    for (int e = threadIdx.x; e < nk; e += NT) Zc[e] = w.Z0[e];
}

// Product p of the logdet correction on one walker's workspace:
// C = C0 + alpha op(A) op(B), all n x n.
struct Product {
  const float* A;
  bool ta;
  const float* B;
  bool tb;
  float* C;
  float alpha;
  const float* C0;
};

__device__ Product logdet_product(int p, const float* S, const SolveWs& w) {
  switch (p) {
    case 0: return {w.U, true, w.U, false, w.W1, -1.f, S};          // Sn - U^T U
    case 1: return {w.V, true, w.W1, false, w.W2, 1.f, nullptr};    // V^T D
    case 2: return {w.W2, false, w.V, false, w.W1, 1.f, nullptr};  // E
    default: return {w.W1, false, w.W1, false, w.X, 1.f, nullptr}; // E E
  }
}

__global__ void __launch_bounds__(NT)
solve_product_block_kernel(const float* __restrict__ Sn, float* ws, int n,
                           int k, int p) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  const Product g = logdet_product(p, Sn + (size_t)b * n * n,
                                   solve_ws_at(ws, b, n, k));
  block_gemm(n, n, n, g.A, n, g.ta, g.B, n, g.tb, g.C, n, g.alpha, g.C0, n,
             sm);
}

// One TILE x TILE output tile of product p per block, grid (tiles^2, B), on
// block_gemm's shared-memory tiles and 4 x 4 register micro-tiles. Depth
// tiles where a triangular operand is exactly zero are skipped: U^T U needs
// depth m <= min(i, j), V^T . needs m <= i, and . V needs m <= j. The terms
// skipped are exact zeros times finite values, and the depth order of the
// rest is block_gemm's, so every entry is the one-block product's, bit for
// bit.
__global__ void __launch_bounds__(NT)
solve_product_tile_kernel(const float* __restrict__ Sn, float* ws, int n,
                          int k, int p) {
  __shared__ Smem sm;
  const int tiles = (n + TILE - 1) / TILE;
  const int i0 = (blockIdx.x / tiles) * TILE, j0 = (blockIdx.x % tiles) * TILE;
  const int b = blockIdx.y;
  const Product g = logdet_product(p, Sn + (size_t)b * n * n,
                                   solve_ws_at(ws, b, n, k));
  int depth = n;
  if (p == 0) depth = min(n, min(i0, j0) + TILE);
  else if (p == 1) depth = min(n, i0 + TILE);
  else if (p == 2) depth = min(n, j0 + TILE);
  const size_t off = (size_t)i0 * n + j0;
  block_gemm(min(TILE, n - i0), min(TILE, n - j0), depth,
             g.ta ? g.A + i0 : g.A + (size_t)i0 * n, n, g.ta,
             g.tb ? g.B + (size_t)j0 * n : g.B + j0, n, g.tb, g.C + off, n,
             g.alpha, g.C0 ? g.C0 + off : nullptr, n, sm);
}

constexpr int CT = 32;               // columns of V per inverse block
constexpr int CTP = CT + 1;          // row stride of the shared column tile
constexpr int NXT = (MAXN + NT - 1) / NT;   // U-row entries per thread

// Dynamic shared memory of one inverse block: the column tile (n x CTP) and
// two U-row buffers (2 n).
size_t inverse_smem(int n) { return sizeof(float) * ((size_t)n * CTP + 2 * n); }

// V = U^-1, one CT-column tile of one walker per block, grid
// (ceil(n / CT), B). The tile's rows 0..c1-1 stay in shared memory (row
// stride CTP: a warp's lanes walking down one column hit 32 banks). Row i,
// from the tile's last column up, takes
//   V[i][j] = (delta_ij - sum_{m = i+1}^{c1-1} U[i][m] V[m][j]) / U[i][i]
// (V[m][j] = 0 for m > j, so the sum may run over the whole tile): each warp
// owns CT / 8 columns, its lanes split the sum over m and a shuffle
// butterfly reduces it. U's next row is fetched from L2 into the other row
// buffer while this one is summed. One barrier per row.
__global__ void __launch_bounds__(NT)
solve_inverse_tile_kernel(float* ws, int n, int k) {
  extern __shared__ float dyn[];
  float* Vs = dyn;
  float* urow = dyn + (size_t)n * CTP;   // two rows of n: current, next
  const int c0 = blockIdx.x * CT, cw = min(CT, n - c0), c1 = c0 + cw;
  const SolveWs w = solve_ws_at(ws, blockIdx.y, n, k);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  // row c1-1 of U from its diagonal on
  if (threadIdx.x == 0) urow[c1 - 1] = w.U[(size_t)(c1 - 1) * n + c1 - 1];
  __syncthreads();
  int cur = 0;
  for (int i = c1 - 1; i >= 0; --i) {
    float nxt[NXT];
#pragma unroll
    for (int r = 0; r < NXT; ++r) {
      const int m = i - 1 + threadIdx.x + r * NT;
      nxt[r] = (i > 0 && m < c1) ? w.U[(size_t)(i - 1) * n + m] : 0.f;
    }
    const float* u = urow + cur * n;
    float acc[CT / 8];
#pragma unroll
    for (int q = 0; q < CT / 8; ++q) acc[q] = 0.f;
    for (int m = i + 1 + lane; m < c1; m += 32) {
      const float um = u[m];
      const float* Vm = Vs + (size_t)m * CTP + wid;
#pragma unroll
      for (int q = 0; q < CT / 8; ++q) acc[q] = fmaf(um, Vm[8 * q], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < CT / 8; ++q)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
    if (lane < CT / 8) {
      float a = acc[0];
#pragma unroll
      for (int q = 1; q < CT / 8; ++q)
        if (lane == q) a = acc[q];
      const int jl = wid + 8 * lane, j = c0 + jl;
      Vs[(size_t)i * CTP + jl] =
          (jl < cw && j >= i) ? ((i == j ? 1.f : 0.f) - a) / u[i] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < NXT; ++r) {
      const int m = i - 1 + threadIdx.x + r * NT;
      if (i > 0 && m < c1) urow[(cur ^ 1) * n + m] = nxt[r];
    }
    cur ^= 1;
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n * cw; e += NT) {
    const int i = e / cw, jl = e - i * cw;
    w.V[(size_t)i * n + c0 + jl] = i < c1 ? Vs[(size_t)i * CTP + jl] : 0.f;
  }
}

__global__ void __launch_bounds__(NT)
solve_logdet_kernel(float* ld, float* ws, int n, int k) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  const SolveWs w = solve_ws_at(ws, b, n, k);
  const float* E = w.W1;
  const float* E2 = w.X;
  float tr = 0.f, see_t = 0.f, s2e_t = 0.f, s22_t = 0.f, see = 0.f, sld = 0.f;
  for (int e = threadIdx.x; e < n * n; e += NT) {
    const int i = e / n, j = e - i * n;
    const size_t et = (size_t)j * n + i;
    const float eij = E[e];
    if (i == j) {
      tr += eij;
      sld += logf(w.U[e]);
    }
    see_t = fmaf(eij, E[et], see_t);
    s2e_t = fmaf(E2[e], E[et], s2e_t);
    s22_t = fmaf(E2[e], E2[et], s22_t);
    see = fmaf(eij, eij, see);
  }
  tr = block_sum(tr, sm);
  see_t = block_sum(see_t, sm);
  s2e_t = block_sum(s2e_t, sm);
  s22_t = block_sum(s22_t, sm);
  see = block_sum(see, sm);
  sld = block_sum(sld, sm);
  float corr = tr - see_t / 2.0f + s2e_t / 3.0f - s22_t / 4.0f;
  if (!(see < 0.09f)) corr = 0.f;
  if (threadIdx.x == 0) ld[b] = 2.0f * sld + corr;
}

// ---- the likelihood pipeline -------------------------------------------
//
// mega_like_launch enqueues, on one per-walker workspace laid out as the
// solve pipeline's (solve_ws floats per walker) followed by the (B, nb, nb)
// Sn buffer:
//   gram      grid (tiles^2, B)   Sn = s (Ss^T Ss) s + diag(ivb), one
//                                 GT x GT output tile per block
//   factor    grid (B)            the tier ladder with the working matrix
//                                 in shared memory: U, tier
//   then the solve pipeline's inverse, refine, four products and logdet,
//   unchanged, on Sn (the refine phase and the products overlap: see
//   mega_like_launch).
// Each Sn entry sums its Gram terms in block_gemm's order (m = 0, 1, ...,
// one fmaf each) and takes the same rounded epilogue, so it equals the
// one-block prologue's bit for bit; the factor runs chol_upper's rank-1
// steps in chol_upper's order, so U equals solve_factor_kernel's bit for
// bit on the same Sn.

constexpr int LIKE_MAXN = 192;   // the likelihood kernel's basis cap
constexpr int GT = 32;           // Gram output tile (GT x GT per block)
constexpr int GD = 128;          // Gram depth rows staged per barrier

// One GT x GT tile of Sn per block, grid (tiles^2, B). The rows of S are
// scaled by sqrt(w) as they are staged into shared memory (no Ss slot);
// each thread owns 2 x 2 outputs.
__global__ void __launch_bounds__(NT)
like_gram_tile_kernel(const float* __restrict__ S,
                      const float* __restrict__ w,
                      const float* __restrict__ s,
                      const float* __restrict__ ivb, float* Sn, int ntoa,
                      int nb) {
  __shared__ float As[GD][GT + 1];
  __shared__ float Bs[GD][GT + 1];
  const int tiles = (nb + GT - 1) / GT;
  const int i0 = (blockIdx.x / tiles) * GT, j0 = (blockIdx.x % tiles) * GT;
  const int b = blockIdx.y;
  const float* wb = w + (size_t)b * ntoa;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  constexpr int R = (GD * GT) / NT;   // staged entries per thread
  const int l = tid % GT;
  for (int m0 = 0; m0 < ntoa; m0 += GD) {
    // every load of the chunk is issued before the first sqrtf, whose
    // slow-path branch would otherwise hold each load back to its own
    // round trip
    float ra[R], rc[R], rw[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = m0 + (tid + r * NT) / GT;
      const float* Sm = S + (size_t)m * nb;
      ra[r] = (m < ntoa && i0 + l < nb) ? Sm[i0 + l] : 0.f;
      rc[r] = (m < ntoa && j0 + l < nb) ? Sm[j0 + l] : 0.f;
      rw[r] = m < ntoa ? wb[m] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int ml = (tid + r * NT) / GT;
      const float q = sqrtf(rw[r]);
      As[ml][l] = ra[r] * q;
      Bs[ml][l] = rc[r] * q;
    }
    __syncthreads();
    const int md = min(GD, ntoa - m0);
    for (int kk = 0; kk < md; ++kk) {
      const float a0 = As[kk][ty], a1 = As[kk][ty + 16];
      const float b0 = Bs[kk][tx], b1 = Bs[kk][tx + 16];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
  const float* sb = s + (size_t)b * nb;
  const float* ivbb = ivb + (size_t)b * nb;
  float* Snb = Sn + (size_t)b * nb * nb;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= nb) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j >= nb) continue;
      const float g = __fmul_rn(__fmul_rn(acc[a][c], sb[i]), sb[j]);
      Snb[(size_t)i * nb + j] = __fadd_rn(g, i == j ? ivbb[i] : 0.f);
    }
  }
}

// Dynamic shared memory of one factor block: the working matrix X, n rows
// of stride n + 1.
size_t factor_smem(int n) { return sizeof(float) * (size_t)n * (n + 1); }

// chol_upper with X in shared memory (row stride n + 1): the same rank-1
// steps on the same values in the same order, so U is chol_upper's bit for
// bit. Row k of U is written whole at step k (zeros left of the diagonal),
// so U needs no clearing pass.
template <int FT>
__device__ bool chol_upper_smem(const float* Sn, float jit, float* X,
                                float* U, int n, int tier, float* lvec,
                                int* flag) {
  constexpr int NW = FT / 32;
  const int ldx = n + 1;
  for (int e = threadIdx.x; e < n * n; e += FT) {
    const int i = e / n, j = e - i * n;
    X[i * ldx + j] = Sn[e] + (i == j ? jit : 0.f);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int k = 0; k < n; ++k) {
    const float dkk = X[k * ldx + k];
    const float ipiv = 1.0f / sqrtf(dkk);
    for (int j = threadIdx.x; j < n; j += FT) {
      float v = 0.f;
      if (j >= k) {
        v = X[k * ldx + j] * ipiv;
        lvec[j] = v;
        if (!isfinite(v)) flag[tier] = 1;
      }
      U[(size_t)k * n + j] = v;
    }
    __syncthreads();
    if (flag[tier]) return false;
    for (int i = k + 1 + wid; i < n; i += NW) {
      const float li = lvec[i];
      float* Xi = X + i * ldx;
      for (int j = i + lane; j < n; j += 32) Xi[j] = fmaf(-li, lvec[j], Xi[j]);
    }
    __syncthreads();
  }
  return true;
}

// The factor phase of the likelihood pipeline, grid (B), FT threads: the
// tier ladder of solve_factor_kernel on chol_upper_smem. Tier 2 reloads
// Sn + j2 I from global memory only in blocks whose tier 1 failed.
template <int FT>
__global__ void __launch_bounds__(FT)
solve_factor_smem_kernel(const float* __restrict__ Sn, int* tier, float* ws,
                         int n, int k, float j1, float j2) {
  extern __shared__ float X[];
  __shared__ float lvec[LIKE_MAXN];
  __shared__ int flag[2];   // one non-finite flag per Cholesky tier
  const int b = blockIdx.x;
  const SolveWs w = solve_ws_at(ws, b, n, k);
  const float* S = Sn + (size_t)b * n * n;
  if (threadIdx.x == 0) flag[0] = flag[1] = 0;
  __syncthreads();
  int t = 1;
  bool ok = chol_upper_smem<FT>(S, j1, X, w.U, n, 0, lvec, flag);
  if (!ok) {
    t = 2;
    ok = chol_upper_smem<FT>(S, j2, X, w.U, n, 1, lvec, flag);
  }
  if (!ok) {
    t = 3;
    for (int e = threadIdx.x; e < n * n; e += FT) {
      const int i = e / n, j = e - i * n;
      w.U[e] = (i == j) ? 1.f : 0.f;
    }
  }
  if (threadIdx.x == 0) tier[b] = t;
}

// Threads of the pipeline's factor blocks (chip_smoke.py times 256, 512
// and 1024 through mega_like_factor_launch).
constexpr int FACTOR_NT = 512;

template <int FT>
int factor_smem_launch(const float* Sn, int* tier, float* ws, int B, int n,
                       int k, float j1, float j2, cudaStream_t stream) {
  static bool ready[64];
  const int rc = allow_smem(solve_factor_smem_kernel<FT>,
                            factor_smem(LIKE_MAXN), ready);
  if (rc != 0) return rc;
  solve_factor_smem_kernel<FT><<<B, FT, factor_smem(n), stream>>>(
      Sn, tier, ws, n, k, j1, j2);
  return (int)cudaGetLastError();
}

// The pipelines take any right-hand-side width up to KCAP: n k <= MAXN KCAP
// (1.8e6) keeps every per-walker index inside int arithmetic, and a
// walker's workspace (solve_ws, 5 n^2 + 5 n k floats) is indexed in
// size_t. The refine phase takes a right-hand side wider than KMAX on
// tiled products.
constexpr int KCAP = 4096;

bool like_args_ok(int B, int ntoa, int nb, int k) {
  return B > 0 && ntoa > 0 && nb > 0 && nb <= LIKE_MAXN && k > 0 && k <= KCAP;
}

bool solve_args_ok(int B, int n, int k) {
  return B > 0 && n > 0 && n <= MAXN && k > 0 && k <= KCAP;
}

// The single-launch baselines (solve_chain) keep the one-panel RHS.
bool single_block_args_ok(int B, int n, int k) {
  return solve_args_ok(B, n, k) && k <= KMAX;
}

// The side stream and the events of mega_like_launch's fork, one set per
// device, made at first use.
struct Fork {
  cudaStream_t side;
  cudaEvent_t factored, inverted, done;
};

int fork_for_device(Fork** out) {
  static Fork forks[64];
  static bool ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  Fork& f = forks[dev];
  if (!ready[dev]) {
    err = cudaStreamCreateWithFlags(&f.side, cudaStreamNonBlocking);
    for (cudaEvent_t* e : {&f.factored, &f.inverted, &f.done})
      if (err == cudaSuccess)
        err = cudaEventCreateWithFlags(e, cudaEventDisableTiming);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  *out = &f;
  return 0;
}

std::mutex fork_mutex;   // one caller at a time on the side streams

}  // namespace

extern "C" {

long long mega_solve_ws_floats(int n, int k) { return solve_ws(n, k); }

// The likelihood pipeline's workspace per walker: the solve pipeline's
// slots, then (after all B walkers' slots) the walker's Sn.
long long mega_like_ws_floats(int nb, int k) {
  return solve_ws(nb, k) + (long long)nb * nb;
}

long long mega_like_single_block_ws_floats(int ntoa, int nb, int k) {
  return like_single_block_ws(ntoa, nb, k);
}

// The solve pipeline's phases, in order (the wrapper launches them all; each
// returns cudaGetLastError()).

int mega_solve_factor_launch(const float* Sn, int* tier, float* ws, int B,
                             int n, int k, float j1, float j2, void* stream) {
  if (!solve_args_ok(B, n, k)) return (int)cudaErrorInvalidValue;
  solve_factor_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(Sn, tier, ws, n, k,
                                                          j1, j2);
  return (int)cudaGetLastError();
}

int mega_solve_inverse_launch(float* ws, int B, int n, int k, void* stream) {
  if (!solve_args_ok(B, n, k)) return (int)cudaErrorInvalidValue;
  static bool ready[64];
  const int rc = allow_smem(solve_inverse_tile_kernel, inverse_smem(MAXN),
                            ready);
  if (rc != 0) return rc;
  const dim3 grid((n + CT - 1) / CT, B);
  solve_inverse_tile_kernel<<<grid, NT, inverse_smem(n),
                              (cudaStream_t)stream>>>(ws, n, k);
  return (int)cudaGetLastError();
}

int mega_solve_refine_launch(const float* Sn, const float* Bn, float* Z,
                             float* ws, int B, int n, int k, int refine,
                             void* stream) {
  if (!solve_args_ok(B, n, k) || refine < 0) return (int)cudaErrorInvalidValue;
  if (k > KMAX)
    solve_refine_tiled_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
        Sn, Bn, Z, ws, n, k, refine);
  else
    solve_refine_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(Sn, Bn, Z, ws, n,
                                                            k, refine);
  return (int)cudaGetLastError();
}

// The refine phase on solve_refine_kernel's skinny panels at any k (in
// series, one block per walker), kept only as the baseline of
// chip_smoke.py's refine A/B at k > KMAX.
int mega_solve_refine_serial_launch(const float* Sn, const float* Bn,
                                    float* Z, float* ws, int B, int n, int k,
                                    int refine, void* stream) {
  if (!solve_args_ok(B, n, k) || refine < 0) return (int)cudaErrorInvalidValue;
  solve_refine_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(Sn, Bn, Z, ws, n, k,
                                                          refine);
  return (int)cudaGetLastError();
}

int mega_solve_product_launch(const float* Sn, float* ws, int B, int n, int k,
                              int p, void* stream) {
  if (!solve_args_ok(B, n, k) || p < 0 || p > 3)
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + TILE - 1) / TILE;
  const dim3 grid(tiles * tiles, B);
  solve_product_tile_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(Sn, ws, n,
                                                                   k, p);
  return (int)cudaGetLastError();
}

int mega_solve_logdet_launch(float* ld, float* ws, int B, int n, int k,
                             void* stream) {
  if (!solve_args_ok(B, n, k)) return (int)cudaErrorInvalidValue;
  solve_logdet_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(ld, ws, n, k);
  return (int)cudaGetLastError();
}

// The inverse and the products on the earlier one-block-per-walker routines
// (backsub_inv, block_gemm), kept only as the baseline of chip_smoke.py's
// per-phase A/B; nothing in the package calls them.

int mega_solve_inverse_single_block_launch(float* ws, int B, int n, int k,
                                           void* stream) {
  if (!solve_args_ok(B, n, k)) return (int)cudaErrorInvalidValue;
  solve_inverse_block_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(ws, n, k);
  return (int)cudaGetLastError();
}

int mega_solve_product_single_block_launch(const float* Sn, float* ws, int B,
                                           int n, int k, int p,
                                           void* stream) {
  if (!solve_args_ok(B, n, k) || p < 0 || p > 3)
    return (int)cudaErrorInvalidValue;
  solve_product_block_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(Sn, ws, n, k,
                                                                 p);
  return (int)cudaGetLastError();
}

// The earlier single-launch design (the whole chain in one block per walker),
// kept only as the A/B baseline that chip_smoke.py times beside the
// pipeline; nothing in the package calls it.
int mega_solve_single_block_launch(const float* Sn, const float* Bn, float* Z,
                                   float* ld, int* tier, float* ws, int B,
                                   int n, int k, float j1, float j2,
                                   int refine, void* stream) {
  if (!single_block_args_ok(B, n, k) || refine < 0)
    return (int)cudaErrorInvalidValue;
  mega_solve_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(Sn, Bn, Z, ld, tier, ws,
                                                        n, k, j1, j2, refine);
  return (int)cudaGetLastError();
}

// The likelihood pipeline's own phases (mega_like_launch enqueues them;
// chip_smoke.py also times each alone).

int mega_like_gram_launch(const float* S, const float* w, const float* s,
                          const float* ivb, float* Sn, int B, int ntoa,
                          int nb, void* stream) {
  if (!like_args_ok(B, ntoa, nb, 1)) return (int)cudaErrorInvalidValue;
  const int tiles = (nb + GT - 1) / GT;
  const dim3 grid(tiles * tiles, B);
  like_gram_tile_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(S, w, s, ivb,
                                                               Sn, ntoa, nb);
  return (int)cudaGetLastError();
}

int mega_like_factor_threads() { return FACTOR_NT; }

int mega_like_factor_launch(const float* Sn, int* tier, float* ws, int B,
                            int n, int k, float j1, float j2, int threads,
                            void* stream) {
  if (!like_args_ok(B, 1, n, k)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (threads) {
    case 256: return factor_smem_launch<256>(Sn, tier, ws, B, n, k, j1, j2, st);
    case 512: return factor_smem_launch<512>(Sn, tier, ws, B, n, k, j1, j2, st);
    case 1024:
      return factor_smem_launch<1024>(Sn, tier, ws, B, n, k, j1, j2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One evaluation: the Gram, the factor, then the solve pipeline's phases on
// the Sn buffer at ws + B solve_ws(nb, k), forked over two streams where
// they share no slot:
//   caller's stream  gram, factor, inverse, refine, (join)
//   side stream                (after factor) product 0,
//                              (after inverse) products 1-3, logdet
// The refine phase (V, Sn, Bn -> Tb, Z0, Zc, R, D, Z) overlaps the logdet
// chain (U, V, Sn -> W1, W2, X -> ld), and product 0 the inverse. The
// caller's stream waits for the side stream before the call returns, so
// the outputs are ordered on the caller's stream as one kernel's would be.
// Returns the first non-zero cudaError of its launches and stream calls.
int mega_like_launch(const float* S, const float* w, const float* s,
                     const float* ivb, const float* Bn, float* Z, float* ld,
                     int* tier, float* ws, int B, int ntoa, int nb, int k,
                     float j1, float j2, int refine, void* stream) {
  if (!like_args_ok(B, ntoa, nb, k) || refine < 0)
    return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(fork_mutex);
  Fork* f = nullptr;
  int rc = fork_for_device(&f);
  if (rc != 0) return rc;
  const cudaStream_t main = (cudaStream_t)stream;
  float* Sn = ws + (size_t)B * solve_ws(nb, k);
  rc = mega_like_gram_launch(S, w, s, ivb, Sn, B, ntoa, nb, stream);
  if (rc == 0)
    rc = mega_like_factor_launch(Sn, tier, ws, B, nb, k, j1, j2, FACTOR_NT,
                                 stream);
  if (rc == 0) rc = (int)cudaEventRecord(f->factored, main);
  if (rc == 0) rc = (int)cudaStreamWaitEvent(f->side, f->factored, 0);
  if (rc == 0) rc = mega_solve_product_launch(Sn, ws, B, nb, k, 0, f->side);
  if (rc == 0) rc = mega_solve_inverse_launch(ws, B, nb, k, stream);
  if (rc == 0) rc = (int)cudaEventRecord(f->inverted, main);
  if (rc == 0) rc = (int)cudaStreamWaitEvent(f->side, f->inverted, 0);
  for (int p = 1; p < 4 && rc == 0; ++p)
    rc = mega_solve_product_launch(Sn, ws, B, nb, k, p, f->side);
  if (rc == 0) rc = mega_solve_logdet_launch(ld, ws, B, nb, k, f->side);
  if (rc == 0) rc = (int)cudaEventRecord(f->done, f->side);
  if (rc == 0)
    rc = mega_solve_refine_launch(Sn, Bn, Z, ws, B, nb, k, refine, stream);
  if (rc == 0) rc = (int)cudaStreamWaitEvent(main, f->done, 0);
  return rc;
}

// The earlier single-launch likelihood kernel and its Gram prologue alone,
// kept only as the baselines of chip_smoke.py's A/B and Stage A table;
// nothing in the package calls them. ws: B
// mega_like_single_block_ws_floats(ntoa, nb, k) floats; Ss: B ntoa nb.

int mega_like_single_block_launch(const float* S, const float* w,
                                  const float* s, const float* ivb,
                                  const float* Bn, float* Z, float* ld,
                                  int* tier, float* ws, int B, int ntoa,
                                  int nb, int k, float j1, float j2,
                                  int refine, void* stream) {
  if (B <= 0 || ntoa <= 0 || nb <= 0 || nb > MAXN || k <= 0 || k > KMAX ||
      refine < 0)
    return (int)cudaErrorInvalidValue;
  mega_like_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(S, w, s, ivb, Bn, Z, ld,
                                                       tier, ws, ntoa, nb, k,
                                                       j1, j2, refine);
  return (int)cudaGetLastError();
}

int mega_like_gram_single_block_launch(const float* S, const float* w,
                                       const float* s, const float* ivb,
                                       float* Sn, float* Ss, int B, int ntoa,
                                       int nb, void* stream) {
  if (!like_args_ok(B, ntoa, nb, 1)) return (int)cudaErrorInvalidValue;
  like_gram_block_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(S, w, s, ivb, Sn,
                                                             Ss, ntoa, nb);
  return (int)cudaGetLastError();
}

long long chol_precond_ws_floats(int n) { return chol_ws(n); }

int chol_precond_launch(const float* Sn, float* U, float* V, float* E,
                        int* tier, float* ws, int B, int n, float j1, float j2,
                        void* stream) {
  if (B <= 0 || n <= 0 || n > MAXN) return (int)cudaErrorInvalidValue;
  chol_precond_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(Sn, U, V, E, tier,
                                                          ws, n, j1, j2);
  return (int)cudaGetLastError();
}

// The preconditioner with the walker in shared memory, for
// n <= chol_precond_smem_maxn() (the wrapper takes chol_precond_launch
// above it). No workspace.
int chol_precond_smem_maxn() { return PRECOND_SMEM_MAXN; }

int chol_precond_smem_launch(const float* Sn, float* U, float* V, float* E,
                             int* tier, int B, int n, float j1, float j2,
                             void* stream) {
  return precond_smem_run<PRECOND_PHASES>(Sn, U, V, E, tier, B, n, j1, j2,
                                          stream);
}

// The chain up to phase `phases` (1 factor, 2 inverse and D, 3 K, 4 E; E
// receives D after 2 and K after 3): chip_smoke.py times each phase by
// difference. The package launches only the whole chain
// (chol_precond_smem_launch).
int chol_precond_smem_phases_launch(const float* Sn, float* U, float* V,
                                    float* E, int* tier, int B, int n,
                                    float j1, float j2, int phases,
                                    void* stream) {
  switch (phases) {
    case 1:
      return precond_smem_run<1>(Sn, U, V, E, tier, B, n, j1, j2, stream);
    case 2:
      return precond_smem_run<2>(Sn, U, V, E, tier, B, n, j1, j2, stream);
    case 3:
      return precond_smem_run<3>(Sn, U, V, E, tier, B, n, j1, j2, stream);
    case PRECOND_PHASES:
      return chol_precond_smem_launch(Sn, U, V, E, tier, B, n, j1, j2,
                                      stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
