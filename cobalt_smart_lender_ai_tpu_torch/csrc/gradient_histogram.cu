// Gradient / hessian / cover histograms of one tree level on Hopper.
//
// Replaces the Pallas kernel `_hist_kernel` of the reference package
// (cobalt_smart_lender_ai_tpu/ops/hist_pallas.py, called by `hist_pallas`)
// and the XLA formulations it stands in for (`_hist_segsum`,
// `_hist_matmul` in ops/histogram.py). The wrapper is
// cobalt_smart_lender_ai_tpu_torch/ops/histogram.py::gradient_histogram_jobs.
//
//   out[c, j, k, f, b] = sum over rows r with node[j, r] == k and
//                        bins[r, f] == b of (g, h, w)[c][j, r]
//
// bins (N, F) uint8 or int32, shared by J jobs; node (J, N) int32, g / h / w
// (J, N) float32; out (3, J, K, F, B) float32, channel-split, as the fit
// consumes it. J = 1 is one fit's level; J > 1 is the level of every
// (candidate, fold) job of a search bucket, the job axis of the reference's
// vmapped CV runner (`_hist_matmul_jobs` in the reference's
// ops/histogram.py). A row of job j is *active* when its node lies in
// [0, K) and its g, h or w is nonzero; the others add nothing (the
// sibling-subtracted call zeroes the right children's rows, subsampling a
// fifth of all rows, a CV job its fold's rows). Bins outside [0, B) add
// nothing either.
//
// The job axis. Each job gets the bits that a launch on that job alone
// gives: the rows are grouped by (job, node) segment, J*K of them, through
// the same five kernels, and the fixed-point scale (below) is chosen per
// (job, channel), so one job's values never move another job's bits, and a
// NaN in one job leaves the other jobs' bins as they are.
//
// What bounds it on an H100 (full-width fit: N = 1.84M rows, F = 20, B = 255,
// K <= 64 nodes): one pass must read node / g / h / w of every row (16 B,
// 29 MB), the F bin bytes of each active row (at most 37 MB) and write
// 3*K*F*B*4 B (3.9 MB at K = 64): about 20 us at 3.35 TB/s. Its 3*F adds per
// active row are under 2 us at 67 TFLOP/s. So the bound is bytes.
//
// Grouping by node. A block keeps in shared memory the histograms of one
// node x a tile of features (a node's 20 features x 255 bins x 3 channels
// of int64 are 120 KB), so a level of K nodes needs K blocks per row slice.
// If every block walked every row and kept those of its node, each row would
// be read K times (at K = 64, 1.9 GB of L2 traffic for 50 MB of work). So
// each launch first groups the active rows by (job, node) segment, as a
// counting sort of row indices, and hands each block a slice of one
// segment's rows: no block reads a row of another segment, and inactive
// rows are dropped before the histogram pass. A slot of the row-index array
// holds the row; its segment's entry in the work table names the job.
//
// Determinism. The histograms feed an argmax over F*(B-2) split candidates
// per node; float atomics in launch order would change the last bits from
// one launch to the next and flip near-ties between two fits on the same
// data. Here every sum is taken in fixed point: each channel of each job is
// scaled by a power of two 2^e, chosen from that job's largest |value| in
// the channel so that no sum over the N rows can pass 2^62, each value is rounded to an int64, and the
// int64s are added with integer atomics. Integer addition is associative, so
// the result does not depend on the order of the adds: two launches give the
// same bits by construction. The rounding error is at most 2^-(e+1) per row,
// N / 2^63 of the largest |value| per sum (2e-13 at the full-width shape),
// far below float32 rounding. A 0/1 cover channel is exact: its sums are
// integers times 2^e. The same property makes the grouping free to be
// unstable: the order of the rows inside a node's segment is whatever the
// atomics of the scatter make it, and changes from launch to launch, but the
// sums do not. No stable sort is needed.
//
// Five kernels on the caller's stream, and no copy to the host:
// 1. count_kernel, grid (row blocks, J): per job, the largest |g|, |h|, |w|
//    (atomicMax on the bit patterns of non-negative floats, which order as
//    the floats do) and the number of active rows of each node (counters in
//    shared memory, one atomic per distinct node of a warp, then one global
//    atomic per node per block);
// 2. plan_kernel, one block: an exclusive scan of the J*K counts gives each
//    segment its part of the row-index array; the segments are cut into
//    slices of at most `chunk` rows, with chunk = active rows of all jobs /
//    ROW_SLICES (so the histogram pass gets about ROW_SLICES slices per
//    feature tile, whatever share of the rows is active); the work table
//    lists, for each slice, its (segment, first slot, row count);
// 3. scatter_kernel, grid (row blocks, J): each active row's index into its
//    segment (slots within a block from shared counters, then one global
//    atomic per (block, node) to reserve them);
// 4. hist_kernel: grid (work-table entry, feature tile), sized for the most
//    entries the plan can make, ROW_SLICES + J*K; blocks past the table's
//    end exit at once. A block keeps the int64 histograms of its node x Ft
//    features x B bins x 3 channels in shared memory (at most 96 KB: Ft = 10
//    of the 20 features at B = 255, 61 KB; two blocks of 512 threads share
//    an SM), walks its slots with one thread per slot, gathers g / h / w and
//    the bins of each row, adds with shared int64 atomics, then adds its
//    non-zero bins into a global int64 accumulator (integer atomics again).
//    On the card, tiles of 10 features at two blocks per SM were faster at
//    every shape of the fit than all 20 features in one block (120 KB, one
//    block per SM, of 512 or 1024 threads), than three blocks per SM (40
//    registers) and than 132, 528 or 1056 slices per tile;
// 5. finalize_kernel: accumulator / 2^e of the bin's job and channel,
//    rounded once to float32.
//
// Non-finite inputs. A NaN or +-inf has no fixed-point value, so it takes
// another road, and the bins it reaches end as the plain version's float64
// sums leave them: NaN where a NaN, or both infinities, reached the bin;
// +inf or -inf where only infinities of that sign did. The scale exponent
// of a channel is taken over its finite values only, so every bin that no
// non-finite value reaches keeps its exact fixed-point sum. The count
// kernel sets one bit per channel in its job's flag word when it sees a
// non-finite value; the histogram pass ORs, per (job, node, feature, bin),
// three bits per channel (NaN, +inf, -inf) into a word array behind the
// accumulator; and the finalize reads those bits only for a (job, channel)
// whose flag is set. On finite inputs the only cost is the word array's
// share of the memset.
//
// The sharded entry (a fit whose rows are split over a dp mesh, the
// reference's psum over its `axis_name`). A launch over one shard's rows
// would take its exponents from that shard's largest values and row count,
// so two shards would scale differently and their sums could not be added.
// So the one pass splits in three entry points, which every shard calls:
// 1. gradient_histogram_scale_state: state_kernel, the shard's JOB_WORDS
//    words per job (the largest finite |g|, |h|, |w| and the flags);
//    the caller reduces them across shards (max of the bits, which order
//    as the non-negative floats do, and OR of the flags) and sums the
//    shards' row counts: the state and N of one launch over all rows;
// 2. gradient_histogram_accumulate: kernels 1-4 of the shard's rows into
//    its own int64 accumulator, scaled by the agreed state and N;
// 3. the caller adds the int64 partials and ORs their non-finite words
//    (in process, or by all_reduce across processes), and
//    gradient_histogram_finalize runs kernel 5 once on the total.
// Integer addition is associative and each value's fixed-point image is
// the one the single launch makes, so the result is that launch's bits. The
// exponent bounds the sum over all N rows by 2^62, so no partial and no
// sum of partials overflows.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define SMEM_BUDGET (96 * 1024)
#define SMEM_MAX 232448
#define HIST_THREADS 512
// The histogram pass cuts each segment into slices of at most `chunk` rows,
// one block per slice and feature tile; the chunk is sized on the card for
// about ROW_SLICES slices, and is at least MIN_CHUNK rows.
#define ROW_SLICES 264
#define MIN_CHUNK 512
#define HIST_MIN_BLOCKS 2
// Up to this many nodes the per-block counters live in shared memory;
// above it the count and the scatter add to the global counters directly.
#define SHARED_NODES 4096
#define COUNT_THREADS 256
#define COUNT_BLOCKS (132 * 4)
#define SCATTER_THREADS 256
#define SCATTER_ITEMS 8
#define PLAN_THREADS 1024
// The int32 words of one job's scale state: the largest |g|, |h|, |w| and
// the non-finite channel flags.
#define JOB_WORDS 4

static __device__ __forceinline__ int scale_exp(unsigned int max_bits,
                                                long long n_rows) {
  const float m = __uint_as_float(max_bits);
  if (!(m > 0.0f)) return 0;
  int k;
  frexp((double)m * (double)n_rows, &k);  // m * n_rows < 2^k
  const int e = 62 - k;
  return e > 1000 ? 1000 : e;
}

static __device__ __forceinline__ long long to_fixed(float v, int e) {
  return llrint(ldexp((double)v, e));
}

// Bits of one channel's value in the non-finite word: 1 NaN, 2 +inf, 4 -inf;
// 0 for a finite value.
static __device__ __forceinline__ unsigned nonfinite_code(float v) {
  if (isnan(v)) return 1u;
  if (isinf(v)) return v > 0.0f ? 2u : 4u;
  return 0u;
}

static __device__ __forceinline__ bool active_row(int k, float g, float h,
                                                  float w, int n_nodes) {
  return (unsigned)k < (unsigned)n_nodes &&
         (g != 0.0f || h != 0.0f || w != 0.0f);
}

// Adds one to counter[k] for each active lane of the warp, with one atomic
// per distinct k; returns each active lane's slot: the counter's value
// before the warp's add plus the lane's rank among the lanes with its k.
// Every lane of the warp must call it.
static __device__ __forceinline__ int warp_add(int* counter, int k, bool act) {
  const unsigned mask = __ballot_sync(0xffffffffu, act);
  int slot = 0;
  if (act) {
    const unsigned peers = __match_any_sync(mask, k);
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(&counter[k], __popc(peers));
    base = __shfl_sync(peers, base, leader);
    slot = base + __popc(peers & ((1u << lane) - 1u));
  }
  return slot;
}

// Grid (row blocks, J): blockIdx.y is the job. job_state holds JOB_WORDS
// words per job, counts K per job.
__global__ void __launch_bounds__(COUNT_THREADS)
    count_kernel(const int* __restrict__ node, const float* __restrict__ g,
                 const float* __restrict__ h, const float* __restrict__ w,
                 int n_rows, int n_nodes, unsigned int* __restrict__ job_state,
                 int* __restrict__ counts) {
  extern __shared__ int sh_count[];
  const long long job_off = (long long)blockIdx.y * n_rows;
  node += job_off;
  g += job_off;
  h += job_off;
  w += job_off;
  unsigned int* max_bits = job_state + JOB_WORDS * blockIdx.y;
  counts += (long long)blockIdx.y * n_nodes;
  const bool local = n_nodes <= SHARED_NODES;
  int* cnt = local ? sh_count : counts;
  if (local) {
    for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) sh_count[i] = 0;
    __syncthreads();
  }
  float mg = 0.0f, mh = 0.0f, mw = 0.0f;
  unsigned nonfinite = 0u;  // bit c: channel c holds a NaN or inf
  const long long stride = (long long)gridDim.x * blockDim.x;
  // The bound is the same for every thread of the block, so every lane of
  // a warp reaches warp_add together.
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n_rows;
       base += stride) {
    const long long r = base + threadIdx.x;
    int k = 0;
    bool act = false;
    if (r < n_rows) {
      const float gv = g[r], hv = h[r], wv = w[r];
      // The scale is taken over finite values only.
      if (isfinite(gv)) mg = fmaxf(mg, fabsf(gv)); else nonfinite |= 1u;
      if (isfinite(hv)) mh = fmaxf(mh, fabsf(hv)); else nonfinite |= 2u;
      if (isfinite(wv)) mw = fmaxf(mw, fabsf(wv)); else nonfinite |= 4u;
      k = node[r];
      act = active_row(k, gv, hv, wv, n_nodes);
    }
    warp_add(cnt, k, act);
  }
  for (int off = 16; off > 0; off >>= 1) {
    mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, off));
    mh = fmaxf(mh, __shfl_xor_sync(0xffffffffu, mh, off));
    mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, off));
  }
  nonfinite = __reduce_or_sync(0xffffffffu, nonfinite);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&max_bits[0], __float_as_uint(mg));
    atomicMax(&max_bits[1], __float_as_uint(mh));
    atomicMax(&max_bits[2], __float_as_uint(mw));
    if (nonfinite) atomicOr(&max_bits[3], nonfinite);
  }
  if (local) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) {
      const int c = sh_count[i];
      if (c) atomicAdd(&counts[i], c);
    }
  }
}

// Inclusive scan of s[0, PLAN_THREADS) in place. Every thread of the block
// calls it after writing its own entry.
static __device__ __forceinline__ void block_scan(int* s, int t) {
  __syncthreads();
  for (int off = 1; off < PLAN_THREADS; off <<= 1) {
    const int a = t >= off ? s[t - off] : 0;
    __syncthreads();
    s[t] += a;
    __syncthreads();
  }
}

// One block, over the S = J*K segments (segment j*K + k is node k of job
// j). The slice length: the level's active rows over ROW_SLICES, at least
// MIN_CHUNK, so that the histogram pass has about ROW_SLICES blocks per
// feature tile whatever the share of active rows. cursor[s] = first slot of
// segment s (the scatter's starting cursor), bstart[s] = first work-table
// entry of segment s, bstart[S] = entries used (at most ROW_SLICES + S);
// table[i] = (segment, first slot, rows, 0).
// The table is filled from cursor / bstart / counts entries that other
// threads of the block wrote: those are read back through L2 (__ldcg). A
// plain or read-only load may hit a line that an earlier load of the same
// sector left in L1, and see the scratch's old contents.
__global__ void __launch_bounds__(PLAN_THREADS)
    plan_kernel(const int* counts, int n_segs, int* cursor, int* bstart,
                int4* table) {
  __shared__ int s_rows[PLAN_THREADS];
  __shared__ int s_slices[PLAN_THREADS];
  const int t = threadIdx.x;
  const int per = (n_segs + PLAN_THREADS - 1) / PLAN_THREADS;
  const int k0 = min(n_segs, t * per);
  const int k1 = min(n_segs, k0 + per);
  int rows = 0;
  for (int k = k0; k < k1; ++k) rows += counts[k];
  s_rows[t] = rows;
  block_scan(s_rows, t);
  const int active = s_rows[PLAN_THREADS - 1];
  const int chunk = max(MIN_CHUNK, (active + ROW_SLICES - 1) / ROW_SLICES);
  int slices = 0;
  for (int k = k0; k < k1; ++k) slices += (counts[k] + chunk - 1) / chunk;
  s_slices[t] = slices;
  block_scan(s_slices, t);
  int row0 = s_rows[t] - rows, slice0 = s_slices[t] - slices;
  for (int k = k0; k < k1; ++k) {
    const int c = counts[k];
    cursor[k] = row0;
    bstart[k] = slice0;
    row0 += c;
    slice0 += (c + chunk - 1) / chunk;
  }
  const int used = s_slices[PLAN_THREADS - 1];
  if (t == 0) bstart[n_segs] = used;
  __syncthreads();
  for (int j = t; j < used; j += PLAN_THREADS) {
    // The last segment whose first entry is <= j; segments without rows
    // own no entry, and share their bstart with the next segment.
    int lo = 0, hi = n_segs - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldcg(&bstart[mid]) <= j) lo = mid; else hi = mid - 1;
    }
    const int i = j - __ldcg(&bstart[lo]);
    table[j] = make_int4(lo, __ldcg(&cursor[lo]) + i * chunk,
                         min(chunk, __ldcg(&counts[lo]) - i * chunk), 0);
  }
}

// Grid (row blocks, J): blockIdx.y is the job; cursor holds K entries per
// job, each the next free slot of its segment in the shared row array.
__global__ void __launch_bounds__(SCATTER_THREADS)
    scatter_kernel(const int* __restrict__ node, const float* __restrict__ g,
                   const float* __restrict__ h, const float* __restrict__ w,
                   int n_rows, int n_nodes, int* __restrict__ cursor,
                   int* __restrict__ rows_out) {
  extern __shared__ int sh_scatter[];  // [K] block counts, [K] slot bases
  const long long job_off = (long long)blockIdx.y * n_rows;
  node += job_off;
  g += job_off;
  h += job_off;
  w += job_off;
  cursor += (long long)blockIdx.y * n_nodes;
  const bool local = n_nodes <= SHARED_NODES;
  int* cnt = local ? sh_scatter : cursor;
  if (local) {
    for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) sh_scatter[i] = 0;
    __syncthreads();
  }
  const long long r0 = (long long)blockIdx.x * (SCATTER_THREADS * SCATTER_ITEMS);
  int kk[SCATTER_ITEMS], slot[SCATTER_ITEMS];
#pragma unroll
  for (int i = 0; i < SCATTER_ITEMS; ++i) {
    const long long r = r0 + i * SCATTER_THREADS + threadIdx.x;
    int k = -1;
    bool act = false;
    if (r < n_rows) {
      k = node[r];
      act = active_row(k, g[r], h[r], w[r], n_nodes);
    }
    slot[i] = warp_add(cnt, k, act);
    kk[i] = act ? k : -1;
  }
  if (local) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) {
      const int c = sh_scatter[i];
      if (c) sh_scatter[n_nodes + i] = atomicAdd(&cursor[i], c);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < SCATTER_ITEMS; ++i) {
    if (kk[i] < 0) continue;
    const int s = local ? sh_scatter[n_nodes + kk[i]] + slot[i] : slot[i];
    rows_out[s] = (int)(r0 + i * SCATTER_THREADS + threadIdx.x);
  }
}

template <typename BinT>
__global__ void __launch_bounds__(HIST_THREADS, HIST_MIN_BLOCKS)
    hist_kernel(const BinT* __restrict__ bins, const float* __restrict__ g,
                const float* __restrict__ h, const float* __restrict__ w,
                const int* __restrict__ rows, const int4* __restrict__ table,
                const int* __restrict__ n_used, int n_rows, int n_features,
                int n_nodes, int n_segs, int n_bins, int ft_tile,
                long long scale_rows,
                const unsigned int* __restrict__ job_state,
                unsigned long long* __restrict__ acc,
                unsigned int* __restrict__ nonfinite) {
  if ((int)blockIdx.x >= *n_used) return;
  extern __shared__ unsigned long long sh[];
  const int4 entry = table[blockIdx.x];
  const int seg = entry.x, first = entry.y, last = entry.y + entry.z;
  const int job = seg / n_nodes;
  const long long job_off = (long long)job * n_rows;
  g += job_off;
  h += job_off;
  w += job_off;
  const unsigned int* max_bits = job_state + JOB_WORDS * job;
  const int f0 = blockIdx.y * ft_tile;
  const int ft = min(ft_tile, n_features - f0);
  const int per_channel = ft * n_bins;
  const int total = 3 * per_channel;
  for (int i = threadIdx.x; i < total; i += blockDim.x) sh[i] = 0ull;
  const int eg = scale_exp(max_bits[0], scale_rows);
  const int eh = scale_exp(max_bits[1], scale_rows);
  const int ew = scale_exp(max_bits[2], scale_rows);
  __syncthreads();

  for (int s = first + threadIdx.x; s < last; s += blockDim.x) {
    const int r = rows[s];
    const float gv = g[r], hv = h[r], wv = w[r];
    // A non-finite value adds nothing to the sums; its bits go to the
    // bin's word instead.
    const unsigned special = nonfinite_code(gv) | nonfinite_code(hv) << 3 |
                             nonfinite_code(wv) << 6;
    const long long qg = isfinite(gv) ? to_fixed(gv, eg) : 0;
    const long long qh = isfinite(hv) ? to_fixed(hv, eh) : 0;
    const long long qw = isfinite(wv) ? to_fixed(wv, ew) : 0;
    if ((qg | qh | qw) == 0 && special == 0u) continue;
    const BinT* br = bins + (long long)r * n_features + f0;
    for (int fl = 0; fl < ft; ++fl) {
      const int b = (int)br[fl];
      if ((unsigned)b >= (unsigned)n_bins) continue;
      const int i = fl * n_bins + b;
      if (qg) atomicAdd(&sh[i], (unsigned long long)qg);
      if (qh) atomicAdd(&sh[per_channel + i], (unsigned long long)qh);
      if (qw) atomicAdd(&sh[2 * per_channel + i], (unsigned long long)qw);
      if (special)
        atomicOr(&nonfinite[((size_t)seg * n_features + (f0 + fl)) * n_bins + b],
                 special);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const unsigned long long v = sh[i];
    if (v == 0ull) continue;
    const int c = i / per_channel;
    const int fl = (i - c * per_channel) / n_bins;
    const int b = i - c * per_channel - fl * n_bins;
    const size_t o =
        (((size_t)c * n_segs + seg) * n_features + (f0 + fl)) * n_bins + b;
    atomicAdd(&acc[o], v);
  }
}

// out[c, seg, f, b]: per_channel = S*F*B bins a channel, per_seg = F*B.
__global__ void finalize_kernel(const unsigned long long* __restrict__ acc,
                                const unsigned int* __restrict__ job_state,
                                const unsigned int* __restrict__ nonfinite,
                                long long scale_rows, int n_nodes, long long per_seg,
                                long long per_channel,
                                float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * per_channel) return;
  const int c = (int)(i / per_channel);
  const long long in_channel = i - c * per_channel;
  const int job = (int)(in_channel / per_seg) / n_nodes;
  const unsigned int* max_bits = job_state + JOB_WORDS * job;
  const int e = scale_exp(max_bits[c], scale_rows);
  float v = (float)ldexp((double)(long long)acc[i], -e);
  if (max_bits[3] & (1u << c)) {
    const unsigned code = (nonfinite[in_channel] >> (3 * c)) & 7u;
    // NaN, or +inf and -inf together, make NaN; one sign of inf stays.
    if (code & 1u || (code & 6u) == 6u)
      v = __int_as_float(0x7fc00000);
    else if (code & 2u)
      v = __int_as_float(0x7f800000);
    else if (code & 4u)
      v = __int_as_float(0xff800000);
  }
  out[i] = v;
}

// Work-table entries the plan can fill at most: with chunk >= active /
// ROW_SLICES, sum over segments of ceil(count / chunk) <= ROW_SLICES + S.
static long long table_entries(long long n_segs) {
  return (long long)ROW_SLICES + n_segs;
}

// The accumulator, in 8-byte words: 3*S*F*B int64 sums, then S*F*B uint32
// words of non-finite bits (three per channel), rounded up to 8 bytes.
static long long acc_words(long long n_segs, int n_features, int n_bins) {
  const long long per_channel = n_segs * n_features * n_bins;
  return 3 * per_channel + (per_channel + 1) / 2;
}

// The int32 scratch, in words: JOB_WORDS per job (max_bits of g, h and w,
// the non-finite channel flags), then counts (S), cursor (S), bstart
// (S+1), the work table (4 words an entry, 16-byte aligned) and the
// row-index array (J*N). The words before cursor are cleared by each
// launch.
struct Scratch {
  long long counts, cursor, bstart, table, rows, words;
};

static Scratch scratch_layout(int n_rows, int n_nodes, int n_jobs) {
  const long long n_segs = (long long)n_jobs * n_nodes;
  Scratch l;
  l.counts = (long long)JOB_WORDS * n_jobs;
  l.cursor = l.counts + n_segs;
  l.bstart = l.cursor + n_segs;
  l.table = (l.bstart + n_segs + 1 + 3) / 4 * 4;
  l.rows = l.table + 4 * table_entries(n_segs);
  l.words = l.rows + (long long)n_jobs * n_rows;
  return l;
}

template <typename BinT>
static cudaError_t launch_hist(const void* bins, const float* g,
                               const float* h, const float* w,
                               const int* rows, const int4* table,
                               const int* n_used, long long n_table,
                               int n_rows, int n_features, int n_nodes,
                               int n_segs, int n_bins, long long scale_rows,
                               const unsigned int* job_state,
                               unsigned long long* acc, unsigned int* nonfinite,
                               cudaStream_t s) {
  const int pair_bytes = 3 * n_bins * (int)sizeof(unsigned long long);
  int ft = SMEM_BUDGET / pair_bytes;
  if (ft < 1) ft = 1;
  const int n_ft = (n_features + ft - 1) / ft;
  ft = (n_features + n_ft - 1) / n_ft;  // balanced tiles
  const size_t smem = (size_t)ft * pair_bytes;
  if (smem > SMEM_MAX || n_table > INT_MAX || n_ft > 65535)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hist_kernel<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)n_table, n_ft);
  hist_kernel<BinT><<<grid, HIST_THREADS, smem, s>>>(
      (const BinT*)bins, g, h, w, rows, table, n_used, n_rows, n_features,
      n_nodes, n_segs, n_bins, ft, scale_rows, job_state, acc, nonfinite);
  return cudaGetLastError();
}

// Grid (row blocks, J): one shard's scale state, the first pass of the
// sharded entry. Per job, the largest finite |g|, |h|, |w| (as bits) and the
// non-finite channel flags over ALL n_rows rows, as count_kernel takes them:
// the shards' states reduce (max of the bits, OR of the flags) to the state
// one launch over every row would take.
__global__ void __launch_bounds__(COUNT_THREADS)
    state_kernel(const float* __restrict__ g, const float* __restrict__ h,
                 const float* __restrict__ w, int n_rows,
                 unsigned int* __restrict__ job_state) {
  const long long job_off = (long long)blockIdx.y * n_rows;
  g += job_off;
  h += job_off;
  w += job_off;
  unsigned int* max_bits = job_state + JOB_WORDS * blockIdx.y;
  float mg = 0.0f, mh = 0.0f, mw = 0.0f;
  unsigned nonfinite = 0u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < n_rows; r += stride) {
    const float gv = g[r], hv = h[r], wv = w[r];
    if (isfinite(gv)) mg = fmaxf(mg, fabsf(gv)); else nonfinite |= 1u;
    if (isfinite(hv)) mh = fmaxf(mh, fabsf(hv)); else nonfinite |= 2u;
    if (isfinite(wv)) mw = fmaxf(mw, fabsf(wv)); else nonfinite |= 4u;
  }
  for (int off = 16; off > 0; off >>= 1) {
    mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, off));
    mh = fmaxf(mh, __shfl_xor_sync(0xffffffffu, mh, off));
    mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, off));
  }
  nonfinite = __reduce_or_sync(0xffffffffu, nonfinite);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&max_bits[0], __float_as_uint(mg));
    atomicMax(&max_bits[1], __float_as_uint(mh));
    atomicMax(&max_bits[2], __float_as_uint(mw));
    if (nonfinite) atomicOr(&max_bits[3], nonfinite);
  }
}

// Kernels 1-4 of one pass: the int64 sums of these rows into `acc` (and
// their non-finite bits behind it), each value scaled by the exponent that
// `state` (per job: max bits, flags) and `scale_rows` give. The one-launch
// entry passes the launch's own state (count_kernel's, in the scratch) and
// its own row count; the sharded entry the state and row count agreed
// across the shards.
static cudaError_t accumulate_pass(const void* bins, int bins_u8,
                                   const int* node, const float* g,
                                   const float* h, const float* w, int n_rows,
                                   int n_features, int n_nodes, int n_bins,
                                   int n_jobs, long long scale_rows,
                                   const unsigned int* state,
                                   unsigned long long* acc, int* scratch,
                                   cudaStream_t s) {
  if (n_rows < 1 || n_features < 1 || n_nodes < 1 || n_bins < 1 ||
      n_jobs < 1 || n_jobs > 65535 || scale_rows < n_rows)
    return cudaErrorInvalidValue;
  // Slots, segments and work-table entries are int32.
  const long long n_segs_ll = (long long)n_jobs * n_nodes;
  if ((long long)n_jobs * n_rows > INT_MAX ||
      table_entries(n_segs_ll) > INT_MAX)
    return cudaErrorInvalidValue;
  const int n_segs = (int)n_segs_ll;
  const Scratch l = scratch_layout(n_rows, n_nodes, n_jobs);
  unsigned int* job_state = (unsigned int*)scratch;
  int* counts = scratch + l.counts;
  int* cursor = scratch + l.cursor;
  int* bstart = scratch + l.bstart;
  int4* table = (int4*)(scratch + l.table);
  int* rows = scratch + l.rows;
  const bool local = n_nodes <= SHARED_NODES;

  const long long per_seg = (long long)n_features * n_bins;
  const long long per_channel = n_segs_ll * per_seg;
  unsigned int* nonfinite = (unsigned int*)(acc + 3 * per_channel);
  cudaError_t err = cudaMemsetAsync(
      acc, 0, acc_words(n_segs_ll, n_features, n_bins) * sizeof(unsigned long long),
      s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(scratch, 0, l.cursor * sizeof(int), s);
  if (err != cudaSuccess) return err;

  int blocks = (n_rows + COUNT_THREADS - 1) / COUNT_THREADS;
  const int per_job_blocks = COUNT_BLOCKS / n_jobs > 0 ? COUNT_BLOCKS / n_jobs : 1;
  if (blocks > per_job_blocks) blocks = per_job_blocks;
  count_kernel<<<dim3(blocks, n_jobs), COUNT_THREADS,
                 local ? n_nodes * sizeof(int) : 0, s>>>(
      node, g, h, w, n_rows, n_nodes, job_state, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  plan_kernel<<<1, PLAN_THREADS, 0, s>>>(counts, n_segs, cursor, bstart,
                                         table);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int per_block = SCATTER_THREADS * SCATTER_ITEMS;
  scatter_kernel<<<dim3((n_rows + per_block - 1) / per_block, n_jobs),
                   SCATTER_THREADS, local ? 2 * n_nodes * sizeof(int) : 0, s>>>(
      node, g, h, w, n_rows, n_nodes, cursor, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const unsigned int* scale = state != nullptr ? state : job_state;
  const long long n_table = table_entries(n_segs_ll);
  return bins_u8 ? launch_hist<unsigned char>(bins, g, h, w, rows, table,
                                              bstart + n_segs, n_table, n_rows,
                                              n_features, n_nodes, n_segs,
                                              n_bins, scale_rows, scale, acc,
                                              nonfinite, s)
                 : launch_hist<int>(bins, g, h, w, rows, table,
                                    bstart + n_segs, n_table, n_rows,
                                    n_features, n_nodes, n_segs, n_bins,
                                    scale_rows, scale, acc, nonfinite, s);
}

// Kernel 5: the sums of `acc` over `state` and `scale_rows` as float32.
static cudaError_t finalize_pass(const unsigned long long* acc,
                                 const unsigned int* state,
                                 long long scale_rows, int n_features,
                                 int n_nodes, int n_bins, int n_jobs,
                                 float* out, cudaStream_t s) {
  const long long per_seg = (long long)n_features * n_bins;
  const long long per_channel = (long long)n_jobs * n_nodes * per_seg;
  const unsigned int* nonfinite = (const unsigned int*)(acc + 3 * per_channel);
  const long long n_out = 3 * per_channel;
  const int threads = 256;
  const long long fblocks = (n_out + threads - 1) / threads;
  if (fblocks > INT_MAX) return cudaErrorInvalidValue;
  finalize_kernel<<<(unsigned)fblocks, threads, 0, s>>>(
      acc, state, nonfinite, scale_rows, n_nodes, per_seg, per_channel, out);
  return cudaGetLastError();
}

extern "C" {

const char* gradient_histogram_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// int32 words of scratch that `gradient_histogram` needs for these sizes.
long long gradient_histogram_scratch_words(int n_rows, int n_nodes,
                                           int n_jobs) {
  return scratch_layout(n_rows, n_nodes, n_jobs).words;
}

// 8-byte words of the accumulator `acc` for these sizes.
long long gradient_histogram_acc_words(int n_nodes, int n_features,
                                       int n_bins, int n_jobs) {
  return acc_words((long long)n_jobs * n_nodes, n_features, n_bins);
}

// int32 words of one scale state: JOB_WORDS per job.
int gradient_histogram_state_words(int n_jobs) { return JOB_WORDS * n_jobs; }

// One histogram pass of n_jobs jobs on `stream`. `bins_u8` selects uint8
// bins (else int32); node, g, h and w hold n_jobs rows of n_rows each.
// Scratch: `acc` holds gradient_histogram_acc_words(K, F, B, J) uint64 and
// `scratch` gradient_histogram_scratch_words(N, K, J) int32, 16-byte
// aligned; both are cleared here as needed. `out` is (3, J, K, F, B)
// float32. Returns the first CUDA error of the memsets and launches, or 0.
int gradient_histogram(int device, const void* bins, int bins_u8,
                       const int* node, const float* g, const float* h,
                       const float* w, int n_rows, int n_features, int n_nodes,
                       int n_bins, int n_jobs, unsigned long long* acc,
                       int* scratch, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  err = accumulate_pass(bins, bins_u8, node, g, h, w, n_rows, n_features,
                        n_nodes, n_bins, n_jobs, n_rows, nullptr, acc,
                        scratch, s);
  if (err != cudaSuccess) return (int)err;
  return (int)finalize_pass(acc, (const unsigned int*)scratch, n_rows,
                            n_features, n_nodes, n_bins, n_jobs, out, s);
}

// The sharded entry, pass 1: one shard's scale state (state_kernel) into
// `state`, gradient_histogram_state_words(J) int32, cleared here.
int gradient_histogram_scale_state(int device, const float* g, const float* h,
                                   const float* w, int n_rows, int n_jobs,
                                   unsigned int* state, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows < 1 || n_jobs < 1 || n_jobs > 65535 ||
      (long long)n_jobs * n_rows > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(state, 0, JOB_WORDS * n_jobs * sizeof(unsigned int), s);
  if (err != cudaSuccess) return (int)err;
  int blocks = (n_rows + COUNT_THREADS - 1) / COUNT_THREADS;
  const int per_job_blocks = COUNT_BLOCKS / n_jobs > 0 ? COUNT_BLOCKS / n_jobs : 1;
  if (blocks > per_job_blocks) blocks = per_job_blocks;
  state_kernel<<<dim3(blocks, n_jobs), COUNT_THREADS, 0, s>>>(g, h, w, n_rows,
                                                             state);
  return (int)cudaGetLastError();
}

// The sharded entry, pass 2: one shard's int64 partial sums into `acc`
// (sized and cleared as for `gradient_histogram`), scaled by the `state`
// agreed across the shards and `scale_rows`, every shard's rows together:
// the bits one launch over all rows would add. No finalize.
int gradient_histogram_accumulate(int device, const void* bins, int bins_u8,
                                  const int* node, const float* g,
                                  const float* h, const float* w, int n_rows,
                                  int n_features, int n_nodes, int n_bins,
                                  int n_jobs, long long scale_rows,
                                  const unsigned int* state,
                                  unsigned long long* acc, int* scratch,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (state == nullptr) return (int)cudaErrorInvalidValue;
  return (int)accumulate_pass(bins, bins_u8, node, g, h, w, n_rows,
                              n_features, n_nodes, n_bins, n_jobs, scale_rows,
                              state, acc, scratch, (cudaStream_t)stream);
}

// The sharded entry, pass 3, once: the summed partials (int64 sums added,
// non-finite words ORed) to the (3, J, K, F, B) float32 `out`.
int gradient_histogram_finalize(int device, const unsigned long long* acc,
                                const unsigned int* state,
                                long long scale_rows, int n_features,
                                int n_nodes, int n_bins, int n_jobs,
                                float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (scale_rows < 1 || n_features < 1 || n_nodes < 1 || n_bins < 1 ||
      n_jobs < 1)
    return (int)cudaErrorInvalidValue;
  return (int)finalize_pass(acc, state, scale_rows, n_features, n_nodes,
                            n_bins, n_jobs, out, (cudaStream_t)stream);
}

}  // extern "C"
