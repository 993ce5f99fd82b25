// Fused forest scoring on Hopper: tree walk + margin + sigmoid + TreeSHAP.
//
// Replaces the Pallas kernel `_score_kernel` of the reference package
// (cobalt_smart_lender_ai_tpu/ops/score_pallas.py, called by `fused_score`).
// One launch per call, on the caller's stream; the wrapper is
// cobalt_smart_lender_ai_tpu_torch/ops/score.py::fused_score.
//
// What bounds it on an H100 (serving forest: T=300 trees of depth d=7, so
// I=127 internal nodes and L=128 leaves per tree, F=20 features):
//
// - Margin only (bulk scoring, up to 4096 rows): the work is tiny. The
//   kernel reads about 0.5 MB of forest (feature, threshold, missing
//   direction, leaf value) and 4096 x 20 x 4 B of rows, and does d compares
//   and one add per row and tree. Both bounds are well under a microsecond,
//   so launch latency dominates. Design: one thread per row walks the d
//   levels of each tree in index order; the forest stays in L2 (50 MB) and
//   is read through the read-only cache; no shared memory, no atomics.
// - With SHAP (/predict micro-batches of 1..64 rows): FP32 CUDA-core
//   arithmetic. Per (row, tree, leaf) the code below does d multiplies for
//   the player indicators, 2 (d-1)(3d+1) for the prefix and suffix
//   polynomials, d(d(d+1) + 2d) for the bilinear Shapley contraction and 3d
//   for the contributions: 782 FLOP at d=7, so 30 MFLOP per row per 300-tree
//   forest (67 TFLOP/s FP32 peak: 0.45 us per row). The forest and its leaf
//   tables are about 2.9 MB, under a microsecond at 3.35 TB/s, so the bound
//   is the arithmetic. Design: a block owns a tile of rows and loops over the trees.
//   Each tree's row-independent tables (node features, thresholds and
//   missing directions; per-leaf path features, duplicate-feature slots,
//   cover-ratio products; leaf values) are staged in shared memory once per
//   tree and shared by every row of the tile. The node decisions of each row
//   are computed once per tree (rows x I) and shared by the L leaf threads.
//   One thread per (row, leaf) keeps its prefix / suffix coefficients in
//   registers (the depth is a template parameter, so every loop unrolls),
//   contracts them with the bilinear form Wt held in constant memory, and
//   adds its contributions into a shared (rows, F) f32 accumulator of this
//   tree with shared atomics. The tree's sums are then folded into the
//   tile's running (rows, F) totals, kept in f64: phis reach |8| on the
//   serving model, where 300 f32 adds into one running total lose up to
//   ~3e-5. The tile writes phis (f32) once at the end.
//
// Margins are bit-identical to the reference: one thread per row sums the
// landed leaf values over trees in index order starting at 0.0f, with plain
// f32 adds and no atomics — the same sequence of adds as the reference's
// `lax.scan`. The sigmoid is 1 / (1 + expf(-m)). SHAP phis are summed with
// atomics in no fixed order and agree to float tolerance.

#include <cuda_runtime.h>

#define MAX_DEPTH 10
#define WT_STRIDE (MAX_DEPTH + 1)

// Wt[depth][a][b] = W[a + b, depth] (0 where a + b >= depth), uploaded once
// per device by score_forest_set_wt.
__constant__ float c_wt[(MAX_DEPTH + 1) * WT_STRIDE * WT_STRIDE];

static __device__ __forceinline__ bool goes_left(float x, float thr,
                                                 unsigned char missing_left) {
  return isnan(x) ? (missing_left != 0) : (x <= thr);
}

static __device__ __forceinline__ float sigmoid(float m) {
  return 1.0f / (1.0f + expf(-m));
}

// ---- margin only: one thread per row ----------------------------------------

__global__ void margin_kernel(const int* __restrict__ feature,
                              const float* __restrict__ thr,
                              const unsigned char* __restrict__ missing_left,
                              const float* __restrict__ leaf,
                              const float* __restrict__ x, int n_rows,
                              int n_features, int n_trees, int depth,
                              float* __restrict__ margin,
                              float* __restrict__ prob) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int n_leaves = 1 << depth;
  const int n_internal = n_leaves - 1;
  const float* xr = x + (size_t)row * n_features;
  float m = 0.0f;
  for (int t = 0; t < n_trees; ++t) {
    const size_t base = (size_t)t * n_internal;
    int node = 0;
    for (int p = 0; p < depth; ++p) {
      const float v = xr[__ldg(feature + base + node)];
      const bool left =
          goes_left(v, __ldg(thr + base + node), __ldg(missing_left + base + node));
      node = 2 * node + (left ? 1 : 2);
    }
    m += __ldg(leaf + (size_t)t * n_leaves + (node - n_internal));
  }
  margin[row] = m;
  prob[row] = sigmoid(m);
}

// ---- margin + SHAP: a block per row tile, a thread per (row, leaf) -------------

// Shared-memory layout of shap_kernel, in bytes (ops/score.py mirrors it in
// `shap_smem_bytes` for its shape guard).
static size_t shap_smem_bytes(int depth, int n_features, int rows) {
  const size_t L = (size_t)1 << depth, I = L - 1, LD = L * depth;
  return 8 * (size_t)rows * n_features +
         4 * (2 * I + L + 2 * LD + 2 * (size_t)rows * n_features) + I + LD +
         (size_t)rows * I;
}

template <int D>
__global__ void shap_kernel(const int* __restrict__ feature,
                            const float* __restrict__ thr,
                            const unsigned char* __restrict__ missing_left,
                            const float* __restrict__ leaf,
                            const int* __restrict__ path_feature,
                            const unsigned char* __restrict__ slot,
                            const float* __restrict__ r_play,
                            const float* __restrict__ x, int n_rows,
                            int n_features, int n_trees, int rows_per_block,
                            float* __restrict__ margin,
                            float* __restrict__ prob,
                            float* __restrict__ phis) {
  constexpr int L = 1 << D;
  constexpr int I = L - 1;
  constexpr int LD = L * D;
  const float* wt = c_wt + D * WT_STRIDE * WT_STRIDE;
  const int R = rows_per_block;
  const int nf = n_features;

  extern __shared__ __align__(16) unsigned char smem[];
  double* s_phi = reinterpret_cast<double*>(smem);        // R*F, all trees
  float* s_thr = reinterpret_cast<float*>(s_phi + R * nf);  // I
  int* s_feat = reinterpret_cast<int*>(s_thr + I);        // I
  float* s_leaf = reinterpret_cast<float*>(s_feat + I);   // L
  float* s_rplay = s_leaf + L;                            // L*D
  int* s_pf = reinterpret_cast<int*>(s_rplay + LD);       // L*D
  float* s_x = reinterpret_cast<float*>(s_pf + LD);       // R*F
  float* s_tphi = s_x + R * nf;                           // R*F, this tree
  unsigned char* s_ml = reinterpret_cast<unsigned char*>(s_tphi + R * nf);  // I
  unsigned char* s_slot = s_ml + I;                       // L*D
  unsigned char* s_gl = s_slot + LD;                      // R*I

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, n_rows - row0);

  for (int k = tid; k < R * nf; k += nt) {
    s_x[k] = (k / nf) < rows ? x[(size_t)row0 * nf + k] : 0.0f;
    s_phi[k] = 0.0;
    s_tphi[k] = 0.0f;
  }
  float m = 0.0f;  // margin of row `tid` of the tile (tid < rows)

  for (int t = 0; t < n_trees; ++t) {
    // Everyone is done with the previous tree's tables (and, at t == 0, the
    // row tile is in shared memory).
    __syncthreads();
    const size_t ni = (size_t)t * I, nl = (size_t)t * L, nld = (size_t)t * LD;
    for (int i = tid; i < I; i += nt) {
      s_thr[i] = thr[ni + i];
      s_feat[i] = feature[ni + i];
      s_ml[i] = missing_left[ni + i];
    }
    for (int i = tid; i < L; i += nt) s_leaf[i] = leaf[nl + i];
    for (int i = tid; i < LD; i += nt) {
      s_rplay[i] = r_play[nld + i];
      s_pf[i] = path_feature[nld + i];
      s_slot[i] = slot[nld + i];
    }
    __syncthreads();
    // Node decisions, once per (row, internal node).
    for (int k = tid; k < rows * I; k += nt) {
      const int r = k / I;
      const int i = k - r * I;
      s_gl[k] = goes_left(s_x[r * nf + s_feat[i]], s_thr[i], s_ml[i]) ? 1 : 0;
    }
    __syncthreads();
    // Margin: this row's walk, one f32 add per tree in tree order.
    if (tid < rows) {
      int node = 0;
#pragma unroll
      for (int p = 0; p < D; ++p) node = 2 * node + (s_gl[tid * I + node] ? 1 : 2);
      m += s_leaf[node - I];
    }
    // SHAP: one (row, leaf) pair per iteration.
    for (int k = tid; k < rows * L; k += nt) {
      const int r = k / L;
      const int l = k - r * L;
      const unsigned char* gl = s_gl + r * I;
      // Walk indicators: does the row take this leaf's branch at level p?
      float ind[D];
      int node = 0;
#pragma unroll
      for (int p = 0; p < D; ++p) {
        const int right = (l >> (D - 1 - p)) & 1;
        ind[p] = ((gl[node] != 0) == (right == 0)) ? 1.0f : 0.0f;
        node = 2 * node + 1 + right;
      }
      // Players: positions sharing a feature multiply into the earliest
      // position's slot; players that own no position keep z = r = 1.
      int sl[D];
      float rp[D], z[D];
#pragma unroll
      for (int p = 0; p < D; ++p) {
        sl[p] = s_slot[l * D + p];
        rp[p] = s_rplay[l * D + p];
      }
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float zj = 1.0f;
#pragma unroll
        for (int p = 0; p < D; ++p) zj = (sl[p] == j) ? zj * ind[p] : zj;
        z[j] = zj;
      }
      // Suffix coefficients S[j] of prod_{j' > j} (rp[j'] + z[j'] t).
      float S[D][D + 1];
#pragma unroll
      for (int c = 0; c <= D; ++c) S[D - 1][c] = (c == 0) ? 1.0f : 0.0f;
#pragma unroll
      for (int j = D - 1; j > 0; --j) {
        S[j - 1][0] = rp[j] * S[j][0];
#pragma unroll
        for (int c = 1; c <= D; ++c) S[j - 1][c] = rp[j] * S[j][c] + z[j] * S[j][c - 1];
      }
      // Prefix coefficients P of prod_{j' < j}, advanced after each player.
      float P[D + 1];
      P[0] = 1.0f;
#pragma unroll
      for (int c = 1; c <= D; ++c) P[c] = 0.0f;
      const float lv = s_leaf[l];
      float* phi_r = s_tphi + r * nf;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float psi = 0.0f;
#pragma unroll
        for (int a = 0; a < D; ++a) {
          float acc = 0.0f;
#pragma unroll
          for (int b = 0; a + b < D; ++b) acc += wt[a * WT_STRIDE + b] * S[j][b];
          psi += P[a] * acc;
        }
        const float contrib = (z[j] - rp[j]) * psi * lv;
        if (contrib != 0.0f) atomicAdd(phi_r + s_pf[l * D + j], contrib);
#pragma unroll
        for (int c = D; c > 0; --c) P[c] = rp[j] * P[c] + z[j] * P[c - 1];
        P[0] = rp[j] * P[0];
      }
    }
    // Fold this tree's attributions into the running totals.
    __syncthreads();
    for (int k = tid; k < rows * nf; k += nt) {
      s_phi[k] += (double)s_tphi[k];
      s_tphi[k] = 0.0f;
    }
  }
  __syncthreads();
  for (int k = tid; k < rows * nf; k += nt) phis[(size_t)row0 * nf + k] = (float)s_phi[k];
  if (tid < rows) {
    margin[row0 + tid] = m;
    prob[row0 + tid] = sigmoid(m);
  }
}

template <int D>
static cudaError_t launch_shap(const int* feature, const float* thr,
                               const unsigned char* missing_left,
                               const float* leaf, const int* path_feature,
                               const unsigned char* slot, const float* r_play,
                               const float* x, int n_rows, int n_features,
                               int n_trees, int rows_per_block, float* margin,
                               float* prob, float* phis, cudaStream_t stream) {
  const size_t smem = shap_smem_bytes(D, n_features, rows_per_block);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        shap_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int pairs = rows_per_block << D;
  const int threads = pairs >= 256 ? 256 : ((pairs + 31) / 32) * 32;
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  shap_kernel<D><<<blocks, threads, smem, stream>>>(
      feature, thr, missing_left, leaf, path_feature, slot, r_play, x, n_rows,
      n_features, n_trees, rows_per_block, margin, prob, phis);
  return cudaGetLastError();
}

extern "C" {

// Upload Wt for every depth 0..MAX_DEPTH: (MAX_DEPTH+1)^3 floats, row-major
// [depth][a][b].
int score_forest_set_wt(int device, const float* wt_all) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(c_wt, wt_all, sizeof(c_wt));
}

const char* score_forest_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One launch on `stream`. `phis == NULL` selects the margin-only kernel;
// otherwise path_feature / slot / r_play are (T, L, depth) leaf tables and
// phis is (n_rows, n_features). Returns cudaGetLastError() of the launch.
int score_forest(int device, const int* feature, const float* thr,
                 const unsigned char* missing_left, const float* leaf,
                 const int* path_feature, const unsigned char* slot,
                 const float* r_play, const float* x, int n_rows,
                 int n_features, int n_trees, int depth, int rows_per_block,
                 float* margin, float* prob, float* phis, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (depth < 1 || depth > MAX_DEPTH || rows_per_block < 1 || rows_per_block > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (phis == nullptr) {
    const int threads = 128;
    const int blocks = (n_rows + threads - 1) / threads;
    margin_kernel<<<blocks, threads, 0, s>>>(feature, thr, missing_left, leaf, x,
                                             n_rows, n_features, n_trees, depth,
                                             margin, prob);
    return (int)cudaGetLastError();
  }
#define SHAP_CASE(D)                                                           \
  case D:                                                                      \
    return (int)launch_shap<D>(feature, thr, missing_left, leaf, path_feature, \
                               slot, r_play, x, n_rows, n_features, n_trees,   \
                               rows_per_block, margin, prob, phis, s);
  switch (depth) {
    SHAP_CASE(1)
    SHAP_CASE(2)
    SHAP_CASE(3)
    SHAP_CASE(4)
    SHAP_CASE(5)
    SHAP_CASE(6)
    SHAP_CASE(7)
    SHAP_CASE(8)
    SHAP_CASE(9)
    SHAP_CASE(10)
  }
#undef SHAP_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
