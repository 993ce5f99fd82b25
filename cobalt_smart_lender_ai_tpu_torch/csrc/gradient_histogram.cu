// Gradient / hessian / cover histograms of one tree level on Hopper.
//
// Replaces the Pallas kernel `_hist_kernel` of the reference package
// (cobalt_smart_lender_ai_tpu/ops/hist_pallas.py, called by `hist_pallas`)
// and the XLA formulations it stands in for (`_hist_segsum`,
// `_hist_matmul` in ops/histogram.py). The wrapper is
// cobalt_smart_lender_ai_tpu_torch/ops/histogram.py::gradient_histogram_channels.
//
//   out[c, k, f, b] = sum over rows r with node[r] == k and bins[r, f] == b
//                     of (g, h, w)[c][r]
//
// bins (N, F) uint8 or int32, node (N,) int32 in [0, K), g / h / w (N,)
// float32; out (3, K, F, B) float32, channel-split, as the fit consumes it.
// Rows whose node lies outside [0, K) or whose bin lies outside [0, B) add
// nothing; rows whose g, h and w are all zero add nothing either (the
// sibling-subtracted call zeroes the right children's rows).
//
// What bounds it on an H100 (full-width fit: N = 1.84M rows, F = 20, B = 255,
// K <= 64 nodes): one pass reads N*F bytes of bins and 16 B per row of node /
// g / h / w (66 MB) and writes at most 3*K*F*B*4 B (3.9 MB at K = 64), about
// 20 us at 3.35 TB/s; its N*F*3 adds are 110 MFLOP, under 2 us at 67 TFLOP/s.
// So the bound is bytes.
//
// Determinism. The histograms feed an argmax over F*(B-2) split candidates
// per node; float atomics in launch order would change the last bits from
// one launch to the next and flip near-ties between two fits on the same
// data. Here every sum is taken in fixed point: each channel is scaled by a
// power of two 2^e, chosen from the channel's largest |value| so that no sum
// over the N rows can pass 2^62, each value is rounded to an int64, and the
// int64s are added with integer atomics. Integer addition is associative, so
// the result does not depend on the order of the adds: two launches give the
// same bits by construction. The rounding error is at most 2^-(e+1) per row,
// N / 2^63 of the largest |value| per sum (2e-13 at the full-width shape),
// far below float32 rounding. A 0/1 cover channel is exact: its sums are
// integers times 2^e.
//
// Three kernels on the caller's stream:
// 1. max_abs_kernel: the largest |g|, |h|, |w| (atomicMax on the bit patterns
//    of non-negative floats, which order as the floats do);
// 2. hist_kernel: grid (row chunk, feature tile, node tile). A block keeps
//    the int64 histograms of its Kt nodes x Ft features x B bins x 3
//    channels in shared memory (at most 96 KB, so two blocks share an SM),
//    walks its chunk of rows with one thread per row, adds with shared
//    int64 atomics, then adds its non-zero bins into a global int64
//    accumulator (integer atomics again);
// 3. finalize_kernel: accumulator / 2^e, rounded once to float32.
// Inputs must be finite (a NaN or inf has no fixed-point value).

#include <cuda_runtime.h>
#include <stdint.h>

#define SMEM_BUDGET (96 * 1024)
#define SMEM_MAX 232448
#define TARGET_BLOCKS (132 * 4)
#define HIST_THREADS 512

static __device__ __forceinline__ int scale_exp(unsigned int max_bits,
                                                int n_rows) {
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

__global__ void max_abs_kernel(const float* __restrict__ g,
                               const float* __restrict__ h,
                               const float* __restrict__ w, int n_rows,
                               unsigned int* __restrict__ max_bits) {
  float mg = 0.0f, mh = 0.0f, mw = 0.0f;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n_rows;
       r += gridDim.x * blockDim.x) {
    mg = fmaxf(mg, fabsf(g[r]));
    mh = fmaxf(mh, fabsf(h[r]));
    mw = fmaxf(mw, fabsf(w[r]));
  }
  for (int off = 16; off > 0; off >>= 1) {
    mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, off));
    mh = fmaxf(mh, __shfl_xor_sync(0xffffffffu, mh, off));
    mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, off));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&max_bits[0], __float_as_uint(mg));
    atomicMax(&max_bits[1], __float_as_uint(mh));
    atomicMax(&max_bits[2], __float_as_uint(mw));
  }
}

template <typename BinT>
__global__ void __launch_bounds__(HIST_THREADS)
    hist_kernel(const BinT* __restrict__ bins, const int* __restrict__ node,
                const float* __restrict__ g, const float* __restrict__ h,
                const float* __restrict__ w, int n_rows, int n_features,
                int n_nodes, int n_bins, int ft_tile, int kt_tile,
                int chunk_rows, const unsigned int* __restrict__ max_bits,
                unsigned long long* __restrict__ acc) {
  extern __shared__ unsigned long long sh[];
  const int f0 = blockIdx.y * ft_tile;
  const int k0 = blockIdx.z * kt_tile;
  const int ft = min(ft_tile, n_features - f0);
  const int kt = min(kt_tile, n_nodes - k0);
  const int per_channel = kt_tile * ft_tile * n_bins;
  const int total = 3 * per_channel;
  for (int i = threadIdx.x; i < total; i += blockDim.x) sh[i] = 0ull;
  const int eg = scale_exp(max_bits[0], n_rows);
  const int eh = scale_exp(max_bits[1], n_rows);
  const int ew = scale_exp(max_bits[2], n_rows);
  __syncthreads();

  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min((long long)n_rows, r0 + chunk_rows);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int k = node[r] - k0;
    if ((unsigned)k >= (unsigned)kt) continue;
    const long long qg = to_fixed(g[r], eg);
    const long long qh = to_fixed(h[r], eh);
    const long long qw = to_fixed(w[r], ew);
    if ((qg | qh | qw) == 0) continue;
    const BinT* br = bins + r * n_features + f0;
    for (int fl = 0; fl < ft; ++fl) {
      const int b = (int)br[fl];
      if ((unsigned)b >= (unsigned)n_bins) continue;
      const int i = (k * ft_tile + fl) * n_bins + b;
      if (qg) atomicAdd(&sh[i], (unsigned long long)qg);
      if (qh) atomicAdd(&sh[per_channel + i], (unsigned long long)qh);
      if (qw) atomicAdd(&sh[2 * per_channel + i], (unsigned long long)qw);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const unsigned long long v = sh[i];
    if (v == 0ull) continue;
    const int b = i % n_bins;
    const int fl = (i / n_bins) % ft_tile;
    const int kl = (i / (n_bins * ft_tile)) % kt_tile;
    const int c = i / per_channel;
    if (fl >= ft || kl >= kt) continue;
    const size_t o =
        (((size_t)c * n_nodes + (k0 + kl)) * n_features + (f0 + fl)) * n_bins + b;
    atomicAdd(&acc[o], v);
  }
}

__global__ void finalize_kernel(const unsigned long long* __restrict__ acc,
                                const unsigned int* __restrict__ max_bits,
                                int n_rows, long long per_channel,
                                float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * per_channel) return;
  const int c = (int)(i / per_channel);
  const int e = scale_exp(max_bits[c], n_rows);
  out[i] = (float)ldexp((double)(long long)acc[i], -e);
}

template <typename BinT>
static cudaError_t launch_hist(const void* bins, const int* node,
                               const float* g, const float* h, const float* w,
                               int n_rows, int n_features, int n_nodes,
                               int n_bins, const unsigned int* max_bits,
                               unsigned long long* acc, cudaStream_t s) {
  const int pair_bytes = 3 * n_bins * (int)sizeof(unsigned long long);
  int pairs = SMEM_BUDGET / pair_bytes;
  if (pairs < 1) pairs = 1;
  const int n_ft = (n_features + pairs - 1) / pairs;
  const int ft = (n_features + n_ft - 1) / n_ft;
  int kt = pairs / ft;
  if (kt < 1) kt = 1;
  if (kt > n_nodes) kt = n_nodes;
  const int n_kt = (n_nodes + kt - 1) / kt;
  const size_t smem = (size_t)kt * ft * pair_bytes;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const int tiles = n_ft * n_kt;
  int n_chunks = (TARGET_BLOCKS + tiles - 1) / tiles;
  const int most = (n_rows + 1023) / 1024;
  if (n_chunks > most) n_chunks = most;
  if (n_chunks < 1) n_chunks = 1;
  const int chunk_rows = (n_rows + n_chunks - 1) / n_chunks;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hist_kernel<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_chunks, n_ft, n_kt);
  hist_kernel<BinT><<<grid, HIST_THREADS, smem, s>>>(
      (const BinT*)bins, node, g, h, w, n_rows, n_features, n_nodes, n_bins,
      ft, kt, chunk_rows, max_bits, acc);
  return cudaGetLastError();
}

extern "C" {

const char* gradient_histogram_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One histogram pass on `stream`. `bins_u8` selects uint8 bins (else int32).
// Scratch: `acc` holds 3*K*F*B uint64, `max_bits` 3 uint32; both are
// cleared here. `out` is (3, K, F, B) float32. Returns the first CUDA error
// of the memsets and launches, or 0.
int gradient_histogram(int device, const void* bins, int bins_u8,
                       const int* node, const float* g, const float* h,
                       const float* w, int n_rows, int n_features, int n_nodes,
                       int n_bins, unsigned long long* acc,
                       unsigned int* max_bits, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows < 1 || n_features < 1 || n_nodes < 1 || n_bins < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long per_channel = (long long)n_nodes * n_features * n_bins;
  err = cudaMemsetAsync(acc, 0, 3 * per_channel * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(max_bits, 0, 3 * sizeof(unsigned int), s);
  if (err != cudaSuccess) return (int)err;

  int blocks = (n_rows + 255) / 256;
  if (blocks > 1024) blocks = 1024;
  max_abs_kernel<<<blocks, 256, 0, s>>>(g, h, w, n_rows, max_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = bins_u8 ? launch_hist<unsigned char>(bins, node, g, h, w, n_rows,
                                             n_features, n_nodes, n_bins,
                                             max_bits, acc, s)
                : launch_hist<int>(bins, node, g, h, w, n_rows, n_features,
                                   n_nodes, n_bins, max_bits, acc, s);
  if (err != cudaSuccess) return (int)err;

  const long long n_out = 3 * per_channel;
  const int threads = 256;
  const long long fblocks = (n_out + threads - 1) / threads;
  finalize_kernel<<<(unsigned)fblocks, threads, 0, s>>>(acc, max_bits, n_rows,
                                                        per_channel, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
