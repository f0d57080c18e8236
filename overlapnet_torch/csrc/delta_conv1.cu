// K1: fused DeltaLayer + c_conv1 forward for Hopper (sm_90a), IEEE fp32.
//
//   out[b, i, j, f] = bias[f] + sum_{k < S, c < C} W[k, c, f] * |a[b, i, c] - bb[b, S*j + k, c]|
//
// a, bb: (B, W', C) fp32 leg feature volumes (the batch stride may be 0, so
// one query volume can face a batch of candidates without a copy);
// W: (S, C, F) fp32; out: (B, W', J = W'/S, F) fp32.
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas_delta.py::_fwd_kernel
// (pallas_call at :54 in _delta_conv1_fwd). That kernel keeps the whole
// (S*C, F) weight (480 KB at C=128, F=64) in VMEM and does one
// (T*J, S*C) @ (S*C, F) dot per grid step; 480 KB does not fit the 227 KB of
// shared memory a Hopper block can have, so this kernel is designed anew as
// an implicit GEMM with M = the W'*J (i, j) pairs, N = F = 64, K = S*C.
//
// Bound: 2*W'*J*S*C*F flops per pair (2.12 GFLOP at W'=360, 3.32 at W'=450)
// against about 2.6 MB of input and output per pair, so it is compute-bound:
// on CUDA cores in fp32 the floor is flops / the card's fp32 non-tensor peak
// (67 TFLOP/s on an H100 SXM, 31.7 us per pair at W'=360).
//
// Design: one block per (batch, tile of BM = 128 consecutive (i, j) rows of
// the flattened output). The K loop runs over taps k < S and chunks of BK = 32
// channels. Per chunk the block stages the few left rows a[i] its tile needs,
// the J right rows bb[S*j + k] and the (BK, F) weight slice in shared memory,
// forms each |a_i - bb_{Sj+k}| once into a (BK, BM) tile, and every thread then
// accumulates an 8 x 4 register tile of outputs with fp32 FMAs, so each
// difference is formed once and reused for all 64 features. The bias is added
// in the epilogue; rows past W'*J (the ragged last tile, e.g. W' = 450) are
// masked. No tensor cores, TMA or pipelining yet.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;  // output rows ((i, j) pairs) per block
constexpr int BN = 64;   // output features per block: all of F
constexpr int BK = 32;   // reduction chunk: BK channels of one tap k
constexpr int TM = 8;    // output rows per thread
constexpr int TN = 4;    // output features per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = BK + 1;  // staged-row pitch, keeps the diff gather conflict-free

__global__ void __launch_bounds__(THREADS)
delta_conv1_kernel(const float* __restrict__ a, const float* __restrict__ bb,
                   const float* __restrict__ w, const float* __restrict__ bias,
                   float* __restrict__ out, int width, int channels, int stride,
                   int j_count, int rows_a, long long a_bstride,
                   long long b_bstride) {
  extern __shared__ __align__(16) float smem[];
  float* d_s = smem;               // [BK][BM] |a - bb| tile, rows fastest
  float* w_s = d_s + BK * BM;      // [BK][BN] weight slice
  float* a_s = w_s + BK * BN;      // [rows_a][PAD] left rows of this tile
  float* b_s = a_s + rows_a * PAD; // [j_count][PAD] right rows S*j + k

  const int tid = threadIdx.x;
  const int batch = blockIdx.y;
  const int m_total = width * j_count;
  const int m0 = blockIdx.x * BM;
  const int i_lo = m0 / j_count;
  const float* a_b = a + batch * a_bstride;
  const float* b_b = bb + batch * b_bstride;

  // The tile row this thread fills in d_s: fixed for the whole K loop.
  const int dm = tid % BM;
  const int dk0 = tid / BM;
  const int m_d = m0 + dm;
  const bool m_ok = m_d < m_total;
  const int a_row = m_ok ? m_d / j_count - i_lo : 0;
  const int b_row = m_ok ? m_d % j_count : 0;

  // The register tile this thread accumulates.
  const int tn = tid % (BN / TN);
  const int tm = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;

  for (int k = 0; k < stride; ++k) {
    for (int c0 = 0; c0 < channels; c0 += BK) {
      for (int e = tid; e < rows_a * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK, i = i_lo + r;
        a_s[r * PAD + kk] =
            i < width ? a_b[(long long)i * channels + c0 + kk] : 0.f;
      }
      for (int e = tid; e < j_count * BK; e += THREADS) {
        const int j = e / BK, kk = e % BK;
        b_s[j * PAD + kk] = b_b[(long long)(stride * j + k) * channels + c0 + kk];
      }
      const float4* w_src =
          reinterpret_cast<const float4*>(w + ((long long)k * channels + c0) * BN);
      for (int e = tid; e < BK * BN / 4; e += THREADS)
        reinterpret_cast<float4*>(w_s)[e] = w_src[e];
      __syncthreads();

      for (int kk = dk0; kk < BK; kk += THREADS / BM)
        d_s[kk * BM + dm] =
            m_ok ? fabsf(a_s[a_row * PAD + kk] - b_s[b_row * PAD + kk]) : 0.f;
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 x0 = *reinterpret_cast<const float4*>(&d_s[kk * BM + tm * TM]);
        const float4 x1 = *reinterpret_cast<const float4*>(&d_s[kk * BM + tm * TM + 4]);
        const float4 y = *reinterpret_cast<const float4*>(&w_s[kk * BN + tn * TN]);
        const float xs[TM] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float ys[TN] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(xs[m], ys[n], acc[m][n]);
      }
      __syncthreads();
    }
  }

  float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (bias != nullptr) bv = *reinterpret_cast<const float4*>(&bias[tn * TN]);
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int row = m0 + tm * TM + m;
    if (row < m_total) {
      const float4 v = make_float4(acc[m][0] + bv.x, acc[m][1] + bv.y,
                                   acc[m][2] + bv.z, acc[m][3] + bv.w);
      *reinterpret_cast<float4*>(
          &out[((long long)batch * m_total + row) * BN + tn * TN]) = v;
    }
  }
}

}  // namespace

// C entry point, bound from Python with ctypes. Launches on `stream` and
// returns cudaGetLastError(): non-zero when the launch was refused or the
// sizes are outside what the kernel takes (features != 64, channels not a
// multiple of 32, width < stride).
extern "C" int delta_conv1_forward(const float* a, const float* bb,
                                   const float* w, const float* bias,
                                   float* out, int batch, int width,
                                   int channels, int stride, int features,
                                   long long a_bstride, long long b_bstride,
                                   void* stream) {
  if (features != BN || channels % BK != 0 || stride < 1 || width < stride ||
      batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int j_count = width / stride;
  const int rows_a = (BM - 1) / j_count + 2;
  const size_t smem =
      sizeof(float) * ((size_t)BK * BM + BK * BN + (size_t)(rows_a + j_count) * PAD);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        delta_conv1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((width * j_count + BM - 1) / BM, batch);
  delta_conv1_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      a, bb, w, bias, out, width, channels, stride, j_count, rows_a, a_bstride,
      b_bstride);
  return (int)cudaGetLastError();
}
