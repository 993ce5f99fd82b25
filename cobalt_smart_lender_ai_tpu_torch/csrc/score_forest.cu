// Fused forest scoring on Hopper: tree walk + margin + sigmoid + TreeSHAP.
//
// Replaces the Pallas kernel `_score_kernel` of the reference package
// (cobalt_smart_lender_ai_tpu/ops/score_pallas.py, called by `fused_score`).
// One call launches two kernels on the caller's stream: a walk kernel
// (`walk_kernel` without SHAP, `shap_kernel<D>` with it) over a grid of
// (row tile x tree group), then `score_finalize_kernel`, which sums per row.
// The wrapper is cobalt_smart_lender_ai_tpu_torch/ops/score.py::fused_score;
// its `launch_plan` picks the tile and group sizes, and this file trusts the
// plan and checks only its bounds.
//
// What bounds it on an H100 (serving forest: T=300 trees of depth d=7, so
// I=127 internal nodes and L=128 leaves per tree, F=20 features):
//
// - Margin only (bulk scoring, up to 4096 rows): d compares and one add per
//   row and tree, and about 0.5 MB of forest and 4096 x 20 x 4 B of rows to
//   read. Both bounds are well under a microsecond, so what counts is that
//   enough independent walks are in flight: one thread per (row, tree of its
//   block's group) walks the d levels, 128 rows a block. The forest stays in
//   L2 (50 MB) and is read through the read-only cache.
// - With SHAP (/predict micro-batches of 1..64 rows): FP32 CUDA-core
//   arithmetic. Per (row, tree, leaf) the code below does d multiplies for
//   the player indicators, 2 (d-1)(3d+1) for the prefix and suffix
//   polynomials, d(d(d+1) + 2d) for the bilinear Shapley contraction and 3d
//   for the contributions: 782 FLOP at d=7, so 30 MFLOP per row per 300-tree
//   forest (67 TFLOP/s FP32 peak: 0.45 us per row). A block owns a tile of
//   up to 8 rows and a group of consecutive trees. Each tree's
//   row-independent tables (one record of `TreeLayout`, ~9.5 KB at d=7) are
//   copied into shared memory with cp.async, double-buffered, so tree t+1's
//   record arrives while tree t computes. The node decisions of each row are
//   computed once per tree (rows x I) and shared by the L leaf threads. One
//   thread per (row, leaf) keeps its prefix / suffix coefficients in
//   registers (the depth is a template parameter, so every loop unrolls),
//   contracts them with the bilinear form Wt held in constant memory, and
//   adds its contributions into the block's shared (rows, F) totals. The
//   32 lanes of a warp are consecutive leaves of one row, so at the top
//   levels they all share a path node, and shared atomics on its feature
//   would serialise: lanes that share the node first sum their
//   contributions with warp shuffles (a fixed tree of adds), and one of
//   them adds the sum with a shared atomic (d >= 5). The totals are fixed
//   point, int64 in units of 2^-40 (each addend rounded once to that grid;
//   ops/score.py::shap_fits refuses a forest whose phis could reach 2^22,
//   half the range): integer atomics give the same sum
//   in any order, so the phis are the same bits from launch to launch,
//   which a resumed portfolio sweep needs (f32 atomics from several warps
//   added in arrival order, and two launches' phis differed in the last
//   bits), and nothing is lost to a long running f32 sum (phis reach |8|
//   on the serving model). The block writes its totals to phi_part[group]
//   (f64).
//
// The grid spreads the trees over blocks, so no block may sum a margin: a
// sum of per-group partial margins would add in another order than the
// reference. Each walk writes the value of the leaf its row lands in to
// leaf_val[tree][row] (row-minor, so the finalize reads coalesce), and the
// finalize kernel sums them per row in tree order starting at 0.0f, with
// plain f32 adds: the same sequence of adds as the reference's `lax.scan`,
// so margins are bit-identical to it. The sigmoid is 1 / (1 + expf(-m)). The
// finalize sums each row's phi_part in group order and casts to f32 once.
// Every sum is in a fixed order or in integers: margins and phis are the
// same bits on every launch.
//
// Precisions. A forest is stored at f32, bf16 or int8 (ops/score.py::
// pack_forest, as the reference packs it): thresholds and leaf values in
// the record at that precision, int8 with per-feature threshold tables
// (scale, zero; one (2, F) f32 table by pointer) and the tree's leaf scale
// and zero in its record; a bf16 or int8 record also marks the trivial
// splits (`all_left`, whose f32 threshold +inf cannot be quantized). Both
// kernels dequantize: bf16 widened with __bfloat162float, int8 as
// __fmaf_rn(q, scale, zero), one rounding, as the reference's XLA contracts
// `q * scale + zero` into one FMA (two roundings differ on about a tenth of
// the committed int8 pack's values); an all_left node gets a +inf threshold,
// so `goes_left` keeps its one comparison. `walk_kernel` is templated on the
// precision and dequantizes each node it visits. `shap_kernel` keeps the
// precision a runtime branch of its staging step: a tree lands in shared
// memory as an image of its f32 record (the feature and SHAP sections
// copied to their f32 places, the stored values beside the image), is
// dequantized once into the image's threshold and leaf sections, and from
// the node decisions on the kernel reads the f32 image at compile-time
// offsets, as at f32. Margins remain the landed (dequantized) leaf values
// summed in tree order, bit-identical to the reference's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MAX_DEPTH 10
#define WT_STRIDE (MAX_DEPTH + 1)
// Most rows one SHAP block takes (ops/score.py's plan uses at most 8) and
// most threads it runs.
#define MAX_SHAP_ROWS 32
#define MAX_SHAP_THREADS 256

// Wt[depth][a][b] = W[a + b, depth] (0 where a + b >= depth), uploaded once
// per device by score_forest_set_wt.
__constant__ float c_wt[(MAX_DEPTH + 1) * WT_STRIDE * WT_STRIDE];

// Precision codes (the index in ops/score.py's PRECISIONS).
#define PREC_F32 0
#define PREC_BF16 1
#define PREC_INT8 2

// ---- one tree's tables: a record of 32-bit words ----------------------------
// ops/score.py::tree_table_layout builds the same layout. Every section
// starts on a 16-byte boundary, so a record is copied 16 bytes at a time:
//   thr q[I] | feature i32[I] | leaf q[L] | r_play f32[L*d]
//   | path_feature i32[L*d] | missing_left u8[I] | slot u8[L*d]
// and, at bf16 and int8, | all_left u8[I] | leaf scale, zero f32[2]
// (q is f32, bf16 or i8). The f32 record ends after slot (al = laff = -1).
struct TreeLayout {
  int thr, feat, leaf, rplay, pf, ml, slot, al, laff, words;
};

__host__ __device__ constexpr int pad4(int words) { return (words + 3) & ~3; }

// Words of n values of `bytes` bytes each.
__host__ __device__ constexpr int value_words(int n, int bytes) {
  return (n * bytes + 3) / 4;
}

__host__ __device__ constexpr TreeLayout tree_layout(int d, int precision) {
  const int L = 1 << d, I = L - 1, LD = L * d;
  const int b = precision == PREC_F32 ? 4 : precision == PREC_BF16 ? 2 : 1;
  TreeLayout t{};
  t.thr = 0;
  t.feat = t.thr + pad4(value_words(I, b));
  t.leaf = t.feat + pad4(I);
  t.rplay = t.leaf + pad4(value_words(L, b));
  t.pf = t.rplay + pad4(LD);
  t.ml = t.pf + pad4(LD);
  t.slot = t.ml + pad4((I + 3) / 4);
  t.words = t.slot + pad4((LD + 3) / 4);
  t.al = t.laff = -1;
  if (precision != PREC_F32) {
    t.al = t.words;
    t.laff = t.al + pad4((I + 3) / 4);
    t.words = t.laff + pad4(2);
  }
  return t;
}

static __device__ __forceinline__ bool goes_left(float x, float thr,
                                                 unsigned char missing_left) {
  return isnan(x) ? (missing_left != 0) : (x <= thr);
}

static __device__ __forceinline__ float sigmoid(float m) {
  return 1.0f / (1.0f + expf(-m));
}

// ---- dequantization ------------------------------------------------------------

// Value i of a bf16 or int8 section, widened to f32 (int8: q * scale +
// zero, rounded once). The _ldg forms read global memory through the
// read-only cache, the others shared memory.
static __device__ __forceinline__ float bf16_at(const int* sec, int i) {
  return __bfloat162float(
      __ushort_as_bfloat16(reinterpret_cast<const unsigned short*>(sec)[i]));
}
static __device__ __forceinline__ float bf16_ldg(const int* sec, int i) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(sec) + i)));
}
static __device__ __forceinline__ float int8_at(const int* sec, int i, float scale,
                                                float zero) {
  return __fmaf_rn((float)reinterpret_cast<const signed char*>(sec)[i], scale, zero);
}
static __device__ __forceinline__ float int8_ldg(const int* sec, int i, float scale,
                                                 float zero) {
  return __fmaf_rn((float)__ldg(reinterpret_cast<const signed char*>(sec) + i),
                   scale, zero);
}

// ---- margin only: one thread per (row, tree of the block's group) -----------

// `thr_affine` is the (2, F) per-feature threshold scale and zero (read at
// int8 only).
template <int P>
__global__ void walk_kernel(const int* __restrict__ tables,
                            const float* __restrict__ thr_affine,
                            const float* __restrict__ x, int n_rows,
                            int n_features, int n_trees, int depth,
                            int trees_per_group, float* __restrict__ leaf_val) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const TreeLayout lay = tree_layout(depth, P);
  const int n_internal = (1 << depth) - 1;
  const float* xr = x + (size_t)row * n_features;
  const int t0 = blockIdx.y * trees_per_group;
  const int t1 = min(n_trees, t0 + trees_per_group);
  for (int t = t0; t < t1; ++t) {
    const int* rec = tables + (size_t)t * lay.words;
    const int* feat = rec + lay.feat;
    const unsigned char* ml = reinterpret_cast<const unsigned char*>(rec + lay.ml);
    int node = 0;
    for (int p = 0; p < depth; ++p) {
      const int f = __ldg(feat + node);
      const float v = __ldg(xr + f);
      float thr;
      if constexpr (P == PREC_F32) {
        thr = __ldg(reinterpret_cast<const float*>(rec + lay.thr) + node);
      } else if (__ldg(reinterpret_cast<const unsigned char*>(rec + lay.al) + node)) {
        thr = INFINITY;
      } else if constexpr (P == PREC_BF16) {
        thr = bf16_ldg(rec + lay.thr, node);
      } else {
        thr = int8_ldg(rec + lay.thr, node, __ldg(thr_affine + f),
                       __ldg(thr_affine + n_features + f));
      }
      node = 2 * node + (goes_left(v, thr, __ldg(ml + node)) ? 1 : 2);
    }
    const int l = node - n_internal;
    float lv;
    if constexpr (P == PREC_F32) {
      lv = __ldg(reinterpret_cast<const float*>(rec + lay.leaf) + l);
    } else if constexpr (P == PREC_BF16) {
      lv = bf16_ldg(rec + lay.leaf, l);
    } else {
      const float* aff = reinterpret_cast<const float*>(rec + lay.laff);
      lv = int8_ldg(rec + lay.leaf, l, __ldg(aff), __ldg(aff + 1));
    }
    leaf_val[(size_t)t * n_rows + row] = lv;
  }
}

// ---- with SHAP: a block per (row tile, tree group), a thread per (row, leaf) -

static __device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A tree in shared memory is always an image of its f32 record (layout
// tree_layout(D, PREC_F32)), so the SHAP loop reads every section at a
// compile-time offset whatever the stored precision. A bf16 or int8 tree
// also keeps, after its image, its stored thresholds, leaves, all_left
// bytes and leaf scale and zero as they are (`raw_words`), which
// `dequantize_tree` widens into the image's threshold and leaf sections.
__host__ __device__ constexpr int raw_words(int d, int precision) {
  if (precision == PREC_F32) return 0;
  const TreeLayout q = tree_layout(d, precision);
  return (q.feat - q.thr) + (q.rplay - q.leaf) + (q.words - q.al);
}

static __device__ __forceinline__ void copy_words(int* dst, const int* src, int words) {
  for (int i = 4 * threadIdx.x; i < words; i += 4 * blockDim.x)
    cp_async16(dst + i, src + i);
}

// Start copying the record `src` (stored layout q) into the shared buffer
// `dst` (image layout f), 16 bytes a thread: at f32 the record as it is; at
// bf16 and int8 its feature and SHAP sections to their places in the image
// (the same words in both layouts) and its stored values to the raw area.
static __device__ __forceinline__ void stage_tree(int* dst, const int* src,
                                                  TreeLayout f, TreeLayout q,
                                                  int precision) {
  if (precision == PREC_F32) {
    copy_words(dst, src, f.words);
  } else {
    int* raw = dst + f.words;
    const int a = q.feat - q.thr, b = q.rplay - q.leaf;
    copy_words(dst + f.feat, src + q.feat, q.leaf - q.feat);
    copy_words(dst + f.rplay, src + q.rplay, q.al - q.rplay);
    copy_words(raw, src + q.thr, a);
    copy_words(raw + a, src + q.leaf, b);
    copy_words(raw + a + b, src + q.al, q.words - q.al);
  }
  cp_async_commit();
}

// A staged bf16 or int8 tree -> its f32 thresholds (+inf at all_left) and
// leaf values in the image's thr and leaf sections, by all the block's
// threads.
static __device__ __forceinline__ void dequantize_tree(
    int* tab, TreeLayout f, TreeLayout q, int precision,
    const float* __restrict__ thr_affine, int n_features, int n_internal,
    int n_leaves) {
  const int* raw = tab + f.words;
  const int a = q.feat - q.thr, b = q.rplay - q.leaf;
  const unsigned char* al = reinterpret_cast<const unsigned char*>(raw + a + b);
  const float* aff = reinterpret_cast<const float*>(raw + a + b + (q.laff - q.al));
  const int* feat = tab + f.feat;
  float* thr = reinterpret_cast<float*>(tab + f.thr);
  float* leaf = reinterpret_cast<float*>(tab + f.leaf);
  const bool bf16 = precision == PREC_BF16;
  for (int k = threadIdx.x; k < n_internal + n_leaves; k += blockDim.x) {
    if (k < n_internal) {
      float v;
      if (al[k]) {
        v = INFINITY;
      } else if (bf16) {
        v = bf16_at(raw, k);
      } else {
        const int ft = feat[k];
        v = int8_at(raw, k, __ldg(thr_affine + ft), __ldg(thr_affine + n_features + ft));
      }
      thr[k] = v;
    } else {
      const int l = k - n_internal;
      leaf[l] = bf16 ? bf16_at(raw + a, l) : int8_at(raw + a, l, aff[0], aff[1]);
    }
  }
}

// Shared-memory layout of shap_kernel, in bytes (ops/score.py mirrors it in
// `shap_smem_bytes` for its shape guard): two trees (double-buffered, each
// the f32 image and at bf16 and int8 the raw stored values), the (rows, F)
// int64 fixed-point totals, the row tile and the tile's node decisions.
static size_t shap_smem_bytes(int depth, int n_features, int rows, int precision) {
  const size_t RF = (size_t)rows * n_features;
  const int tree_words = tree_layout(depth, PREC_F32).words + raw_words(depth, precision);
  return 8 * (size_t)tree_words + 12 * RF + (size_t)rows * ((1 << depth) - 1);
}

// The SHAP totals are int64 in units of 2^-40: an addend is rounded to the
// grid once, then added exactly.
#define PHI_FIXED_SCALE 0x1p40f
#define PHI_FIXED_UNIT 0x1p-40

static __device__ __forceinline__ void add_phi(unsigned long long* dst, float v) {
  atomicAdd(dst, (unsigned long long)__float2ll_rn(v * PHI_FIXED_SCALE));
}

// Up to depth 7 the compiler is held to four blocks an SM (64 registers a
// thread, a few spilled): the leaf threads' coefficients then stay in flight
// on 32 warps instead of 16, which the walk's grid needs more than the
// registers. Deeper trees keep every register they need. `q` is
// tree_layout(D, precision), the layout of the records in `tables`;
// `thr_affine` is read at int8 only.
template <int D>
__global__ void __launch_bounds__(MAX_SHAP_THREADS, D <= 7 ? 4 : 1)
    shap_kernel(const int* __restrict__ tables, const TreeLayout q,
                int precision, const float* __restrict__ thr_affine,
                const float* __restrict__ x, int n_rows, int n_features,
                int n_trees, int rows_per_block, int trees_per_group,
                float* __restrict__ leaf_val, double* __restrict__ phi_part) {
  constexpr int L = 1 << D;
  constexpr int I = L - 1;
  constexpr TreeLayout lay = tree_layout(D, PREC_F32);  // the shared image
  const float* wt = c_wt + D * WT_STRIDE * WT_STRIDE;
  const int R = rows_per_block;
  const int nf = n_features;
  const int tree_words = lay.words + raw_words(D, precision);

  extern __shared__ __align__(16) unsigned char smem[];
  int* s_tab = reinterpret_cast<int*>(smem);                          // 2 trees
  unsigned long long* s_phi =
      reinterpret_cast<unsigned long long*>(s_tab + 2 * tree_words);  // R*F, group
  float* s_x = reinterpret_cast<float*>(s_phi + R * nf);              // R*F
  unsigned char* s_gl = reinterpret_cast<unsigned char*>(s_x + R * nf);  // R*I

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, n_rows - row0);
  const int t0 = blockIdx.y * trees_per_group;
  const int n_local = min(trees_per_group, n_trees - t0);

  stage_tree(s_tab, tables + (size_t)t0 * q.words, lay, q, precision);
  for (int k = tid; k < R * nf; k += nt) {
    s_x[k] = (k / nf) < rows ? x[(size_t)row0 * nf + k] : 0.0f;
    s_phi[k] = 0ull;
  }

  for (int i = 0; i < n_local; ++i) {
    int* tab = s_tab + (i & 1) * tree_words;
    // The other buffer held tree i-1, which every thread is done with (the
    // barrier that ended tree i-1): fetch tree i+1 into it, then wait for
    // tree i only.
    if (i + 1 < n_local) {
      stage_tree(s_tab + ((i + 1) & 1) * tree_words,
                 tables + (size_t)(t0 + i + 1) * q.words, lay, q, precision);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tree i's record (and, at i == 0, the row tile) is in
    if (precision != PREC_F32) {
      dequantize_tree(tab, lay, q, precision, thr_affine, nf, I, L);
      __syncthreads();
    }
    const float* s_thr = reinterpret_cast<const float*>(tab + lay.thr);
    const int* s_feat = tab + lay.feat;
    const float* s_leaf = reinterpret_cast<const float*>(tab + lay.leaf);
    const float* s_rplay = reinterpret_cast<const float*>(tab + lay.rplay);
    const int* s_pf = tab + lay.pf;
    const unsigned char* s_ml = reinterpret_cast<const unsigned char*>(tab + lay.ml);
    const unsigned char* s_slot = reinterpret_cast<const unsigned char*>(tab + lay.slot);

    // Node decisions, once per (row, internal node).
    for (int k = tid; k < rows * I; k += nt) {
      const int r = k / I;
      const int n = k - r * I;
      s_gl[k] = goes_left(s_x[r * nf + s_feat[n]], s_thr[n], s_ml[n]) ? 1 : 0;
    }
    __syncthreads();
    // This row's walk: the landed leaf's value, summed later in tree order.
    if (tid < rows) {
      int node = 0;
#pragma unroll
      for (int p = 0; p < D; ++p) node = 2 * node + (s_gl[tid * I + node] ? 1 : 2);
      leaf_val[(size_t)(t0 + i) * n_rows + row0 + tid] = s_leaf[node - I];
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
      unsigned long long* phi_r = s_phi + r * nf;
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
        if constexpr (L >= 32) {
          // The warp's lanes are 32 consecutive leaves of one row, and the
          // aligned runs of 2^(D-j) of them share their level-j node, so its
          // feature: sum each run with shuffles, then one atomic a run.
          const int run = (D - j >= 5) ? 32 : (1 << (D - j));
          float v = contrib;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1)
            if (o < run) v += __shfl_xor_sync(0xffffffffu, v, o);
          if ((l & (run - 1)) == 0 && v != 0.0f) add_phi(phi_r + s_pf[l * D + j], v);
        } else {
          if (contrib != 0.0f) add_phi(phi_r + s_pf[l * D + j], contrib);
        }
#pragma unroll
        for (int c = D; c > 0; --c) P[c] = rp[j] * P[c] + z[j] * P[c - 1];
        P[0] = rp[j] * P[0];
      }
    }
    // Every thread is done with tree i (its record and node decisions).
    __syncthreads();
  }
  // The last barrier also ordered every atomic before these reads.
  double* out = phi_part + ((size_t)blockIdx.y * n_rows + row0) * nf;
  for (int k = tid; k < rows * nf; k += nt) out[k] = (double)(long long)s_phi[k] * PHI_FIXED_UNIT;
}

// ---- finalize: per row, trees (and groups) in order --------------------------

// Items (rows, or (row, feature) pairs) of one finalize block, its threads,
// and its staging buffer.
#define FIN_ITEMS 32
#define FIN_THREADS 256
#define FIN_BYTES 32768

// Sum, for the FIN_ITEMS items from item0, the n_terms values
// src[term * stride + item] in term order from zero. All the block's threads
// stage a chunk of terms in shared memory (independent loads, coalesced
// along the items); then thread i < FIN_ITEMS adds its item's terms one at a
// time. The result is valid in threads i < FIN_ITEMS.
template <typename T>
static __device__ __forceinline__ T sum_in_order(const T* __restrict__ src,
                                                 size_t stride, int n_terms,
                                                 int item0, int n_items,
                                                 T* s_buf) {
  constexpr int CHUNK = FIN_BYTES / (int)sizeof(T) / FIN_ITEMS;
  const int tid = threadIdx.x;
  T acc = T(0);
  for (int c0 = 0; c0 < n_terms; c0 += CHUNK) {
    const int n = min(CHUNK, n_terms - c0);
#pragma unroll 8
    for (int k = tid; k < n * FIN_ITEMS; k += FIN_THREADS) {
      const int t = k / FIN_ITEMS;
      const int item = item0 + (k - t * FIN_ITEMS);
      s_buf[k] = item < n_items ? __ldg(src + (size_t)(c0 + t) * stride + item) : T(0);
    }
    __syncthreads();
    if (tid < FIN_ITEMS)
      for (int t = 0; t < n; ++t) acc += s_buf[t * FIN_ITEMS + tid];
    __syncthreads();
  }
  return acc;
}

// The first ceil(N / FIN_ITEMS) blocks sum margins: one f32 add per tree,
// in tree order, from 0.0f. The rest (with SHAP) sum each (row, feature)'s
// f64 group totals in group order and cast once.
__global__ void __launch_bounds__(FIN_THREADS)
    score_finalize_kernel(const float* __restrict__ leaf_val,
                          const double* __restrict__ phi_part, int n_rows,
                          int n_features, int n_trees, int n_groups,
                          float* __restrict__ margin, float* __restrict__ prob,
                          float* __restrict__ phis) {
  __shared__ __align__(16) unsigned char s_buf[FIN_BYTES];
  const int margin_blocks = (n_rows + FIN_ITEMS - 1) / FIN_ITEMS;
  const int i = threadIdx.x;
  if ((int)blockIdx.x < margin_blocks) {
    const int row0 = blockIdx.x * FIN_ITEMS;
    const float m = sum_in_order(leaf_val, (size_t)n_rows, n_trees, row0, n_rows,
                                 reinterpret_cast<float*>(s_buf));
    if (i < FIN_ITEMS && row0 + i < n_rows) {
      margin[row0 + i] = m;
      prob[row0 + i] = sigmoid(m);
    }
  } else {
    const int items = n_rows * n_features;
    const int k0 = (blockIdx.x - margin_blocks) * FIN_ITEMS;
    const double s = sum_in_order(phi_part, (size_t)items, n_groups, k0, items,
                                  reinterpret_cast<double*>(s_buf));
    if (i < FIN_ITEMS && k0 + i < items) phis[k0 + i] = (float)s;
  }
}

template <int D>
static cudaError_t launch_shap(const int* tables, int precision,
                               const float* thr_affine, const float* x,
                               int n_rows, int n_features, int n_trees,
                               int rows_per_block, int trees_per_group,
                               int n_groups, int threads, float* leaf_val,
                               double* phi_part, cudaStream_t stream) {
  const size_t smem = shap_smem_bytes(D, n_features, rows_per_block, precision);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        shap_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n_rows + rows_per_block - 1) / rows_per_block, n_groups);
  shap_kernel<D><<<grid, threads, smem, stream>>>(
      tables, tree_layout(D, precision), precision, thr_affine, x, n_rows,
      n_features, n_trees, rows_per_block, trees_per_group, leaf_val, phi_part);
  return cudaGetLastError();
}

template <int P>
static cudaError_t launch_margin(const int* tables, const float* thr_affine,
                                 const float* x, int n_rows, int n_features,
                                 int n_trees, int depth, int rows_per_block,
                                 int trees_per_group, int n_groups, int threads,
                                 float* leaf_val, cudaStream_t stream) {
  const dim3 grid((n_rows + rows_per_block - 1) / rows_per_block, n_groups);
  walk_kernel<P><<<grid, threads, 0, stream>>>(tables, thr_affine, x, n_rows,
                                               n_features, n_trees, depth,
                                               trees_per_group, leaf_val);
  return cudaGetLastError();
}

static cudaError_t launch_walk(const int* tables, int precision,
                               const float* thr_affine, const float* x,
                               int n_rows, int n_features, int n_trees,
                               int depth, int rows_per_block,
                               int trees_per_group, int n_groups, int threads,
                               float* leaf_val, double* phi_part,
                               cudaStream_t stream) {
  if (phi_part == nullptr) {
#define MARGIN_CASE(P)                                                         \
  case P:                                                                      \
    return launch_margin<P>(tables, thr_affine, x, n_rows, n_features, n_trees, \
                            depth, rows_per_block, trees_per_group, n_groups,   \
                            threads, leaf_val, stream);
    switch (precision) {
      MARGIN_CASE(PREC_F32)
      MARGIN_CASE(PREC_BF16)
      MARGIN_CASE(PREC_INT8)
    }
#undef MARGIN_CASE
    return cudaErrorInvalidValue;
  }
#define SHAP_CASE(D)                                                           \
  case D:                                                                      \
    return launch_shap<D>(tables, precision, thr_affine, x, n_rows, n_features, \
                          n_trees, rows_per_block, trees_per_group, n_groups,   \
                          threads, leaf_val, phi_part, stream);
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
  return cudaErrorInvalidValue;
}

extern "C" {

// Upload Wt for every depth 0..MAX_DEPTH: (MAX_DEPTH+1)^3 floats, row-major
// [depth][a][b].
int score_forest_set_wt(int device, const float* wt_all) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(c_wt, wt_all, sizeof(c_wt));
}

// Load every kernel of the library on `device` now: a lazily loaded module
// loads a kernel at its first launch, which would then hold that load.
int score_forest_prepare(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
#define LOAD(kernel)                                                           \
  err = cudaFuncGetAttributes(&attr, kernel);                                  \
  if (err != cudaSuccess) return (int)err;
  LOAD(walk_kernel<PREC_F32>)
  LOAD(walk_kernel<PREC_BF16>)
  LOAD(walk_kernel<PREC_INT8>)
  LOAD(shap_kernel<1>)
  LOAD(shap_kernel<2>)
  LOAD(shap_kernel<3>)
  LOAD(shap_kernel<4>)
  LOAD(shap_kernel<5>)
  LOAD(shap_kernel<6>)
  LOAD(shap_kernel<7>)
  LOAD(shap_kernel<8>)
  LOAD(shap_kernel<9>)
  LOAD(shap_kernel<10>)
  LOAD(score_finalize_kernel)
#undef LOAD
  return 0;
}

const char* score_forest_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Words of one tree's record at `depth` and `precision` (ops/score.py
// checks its own layout against it).
int score_forest_table_words(int depth, int precision) {
  return depth < 1 || depth > MAX_DEPTH || precision < PREC_F32 ||
                 precision > PREC_INT8
             ? -1
             : tree_layout(depth, precision).words;
}

// One call on `stream`: the walk kernel over (row tiles x n_groups) blocks of
// `threads`, then the finalize kernel. `tables` is (n_trees, words) records,
// 16-byte aligned, at `precision` (PREC_*); `thr_affine` is the (2,
// n_features) per-feature threshold scale and zero, read at int8 only;
// leaf_val is (n_trees, n_rows) f32 scratch. `phis == NULL`
// selects the margin-only walk (rows_per_block == threads, one row a
// thread); otherwise phi_part is (n_groups, n_rows, n_features) f64 scratch
// and phis is (n_rows, n_features). Returns the first launch error.
int score_forest(int device, const int* tables, int precision,
                 const float* thr_affine, const float* x, int n_rows,
                 int n_features, int n_trees, int depth, int rows_per_block,
                 int trees_per_group, int n_groups, int threads,
                 float* leaf_val, double* phi_part, float* margin, float* prob,
                 float* phis, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool shap = phis != nullptr;
  const bool bad =
      depth < 1 || depth > MAX_DEPTH || n_rows < 1 || n_features < 1 ||
      n_trees < 0 || trees_per_group < 1 ||
      n_groups != (n_trees + trees_per_group - 1) / trees_per_group ||
      n_groups > 65535 || threads < 32 || threads % 32 != 0 ||
      ((size_t)tables & 15) != 0 || precision < PREC_F32 ||
      precision > PREC_INT8 || (precision == PREC_INT8 && thr_affine == nullptr) ||
      (shap ? (rows_per_block < 1 || rows_per_block > MAX_SHAP_ROWS ||
               threads > MAX_SHAP_THREADS ||
               (n_groups > 0 && phi_part == nullptr))
            : (rows_per_block != threads || threads > 1024));
  if (bad) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_groups > 0) {
    err = launch_walk(tables, precision, thr_affine, x, n_rows, n_features,
                      n_trees, depth, rows_per_block, trees_per_group, n_groups,
                      threads, leaf_val, shap ? phi_part : nullptr, s);
    if (err != cudaSuccess) return (int)err;
  }
  int fin_blocks = (n_rows + FIN_ITEMS - 1) / FIN_ITEMS;
  if (shap) fin_blocks += (n_rows * n_features + FIN_ITEMS - 1) / FIN_ITEMS;
  score_finalize_kernel<<<fin_blocks, FIN_THREADS, 0, s>>>(
      leaf_val, phi_part, n_rows, n_features, n_trees, n_groups, margin, prob, phis);
  return (int)cudaGetLastError();
}

}  // extern "C"
