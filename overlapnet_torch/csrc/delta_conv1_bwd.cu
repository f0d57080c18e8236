// K2: backward of the fused DeltaLayer + c_conv1 (K1) for Hopper (sm_90a), in
// fp32 on the CUDA cores.
//
// For the cotangent g (B, W', J, F) of K1's output, with
// diff = a[b, i, c] - bb[b, S*j + k, c] recomputed (never stored):
//
//   gw[b, i, j, k, c]  = sum_f g[b, i, j, f] * W[k, c, f]
//   da[b, i, c]        =  sum_{j, k} gw * sign(diff)         sign(0) = 0
//   db[b, S*j + k, c]  = -sum_i      gw * sign(diff)
//   dW[k, c, f]        =  sum_{b, i, j} |diff| * g[b, i, j, f]
//
// a, bb: (B, W', C) fp32; W: (S, C, F = 64); J = W' / S. Rows of db past J*S
// are not written here (the wrapper zeroes them).
//
// Replaces the JAX package's custom VJP of its Pallas kernel,
// ops/pallas_delta.py::_core_bwd over _bwd_block: a lax.scan over blocks of
// 24 left rows that materializes a (B, 24, J, S, C) difference block per
// step. That scan is not carried over. Both halves are matrix products of
// K1's size whose operand is formed on the fly (gw masked by a recomputed
// sign; |diff| against g), 4*B*W'*J*S*C*F flops in all (67.9 GFLOP at
// B = 16, W' = 360) against some 50 MB of inputs and outputs: operations
// bound it, by three orders of magnitude over the bytes.
//
// Design. Every sum that crosses blocks is taken in a fixed order (partials
// in scratch, then a small reduction kernel): no atomics, the same result on
// every run. Both product kernels use one block per (tap k, batch element b,
// 128-channel chunk), so that the J right rows bb[S*j + k] and the weight
// slice W[k] of the block are staged in shared memory once, and walk over
// tiles of whole left rows i (TI = 128 / J rows i, TI * J <= 128 (i, j) rows
// of g per tile; the next tile's g is prefetched into registers while the
// current one is multiplied):
// - dab_kernel: gw tile (128 rows x 128 channels, K = F = 64) as an 8 x 8
//   register tile per thread from g^T and W[k]^T in shared memory; the
//   epilogue multiplies by sign(diff) and writes the tile to shared memory,
//   from which column sums over j give this tap's part of da (to scratch
//   (B, S, W', C)) and column sums over i accumulate db's J rows of this tap
//   in shared memory: db needs no sum across blocks at all;
// - dw_kernel: dW[k] (128 channels x 64 features, K = all (i, j) rows of the
//   batch element) as an 8 x 8 register tile per thread, |diff| formed in
//   registers from the staged rows; the two halves of the block split the
//   j's and are summed through shared memory; partials go to scratch
//   (B, S, C, F);
// - sum_axis_kernel adds da's S tap parts and dW's B batch parts in order.
// What bounds it now: the fp32 FMA rate of the CUDA cores (67 TFLOP/s
// published for an H100 SXM) less the tile epilogues, the staging that is
// not double-buffered in shared memory, and grids of S*B blocks that fill
// the 132 SMs unevenly. The tensor cores (3xTF32 wgmma as in K1) are the
// next step for it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F = 64;         // features: the cotangent's last axis
constexpr int CT = 128;       // channels per block
constexpr int BM = 128;       // (i, j) rows of g per tile, at most
constexpr int THREADS = 256;
constexpr int PAD = 4;        // floats: rows stay 16-byte aligned
constexpr int LDC = CT + PAD; // pitch of rows of channels
constexpr int LDM = BM + PAD; // pitch of rows of (i, j) rows
constexpr int G_VECS = BM * F / 4 / THREADS;  // float4 of a g tile per thread

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float sign0(float d) {
  return static_cast<float>(d > 0.f) - static_cast<float>(d < 0.f);
}

// Rows S*j + k of bb (this tap's right rows) into b_s[j][c], and the tile's
// left rows into a_s[r][c]; both with pitch LDC.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows,
                                           long long row_stride, int tid) {
  for (int idx = tid; idx < rows * (CT / 4); idx += THREADS) {
    const int r = idx / (CT / 4), c4 = idx % (CT / 4);
    *reinterpret_cast<float4*>(dst + r * LDC + 4 * c4) = ldg4(src + r * row_stride + 4 * c4);
  }
}

// da (one tap's part) and db. Grid (S, B, C / CT).
__global__ void __launch_bounds__(THREADS, 1)
dab_kernel(const float* __restrict__ a, const float* __restrict__ bb,
           const float* __restrict__ w, const float* __restrict__ g,
           float* __restrict__ da_part, float* __restrict__ db, int width, int channels,
           int stride, int j_count, int ti_max) {
  extern __shared__ float4 smem4[];
  float* wt_s = reinterpret_cast<float*>(smem4);  // [F][LDC]: W[k][c0 + c][f] at [f][c]
  float* gt_s = wt_s + F * LDC;                   // [F][LDM]: g row m, feature f at [f][m]
  float* gd_s = gt_s + F * LDM;                   // [BM][LDC]: gw * sign(diff)
  float* b_s = gd_s + BM * LDC;                   // [J][LDC]
  float* db_s = b_s + j_count * LDC;              // [J][CT]
  float* a_s = db_s + j_count * CT;               // [ti_max][LDC]

  const int k = blockIdx.x, batch = blockIdx.y, c0 = blockIdx.z * CT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* a_b = a + (long long)batch * width * channels + c0;
  const float* b_b = bb + (long long)batch * width * channels + c0;
  const float* g_b = g + (long long)batch * width * j_count * F;

  for (int idx = tid; idx < CT * (F / 4); idx += THREADS) {
    const int c = idx % CT, f4 = idx / CT;
    const float4 v = ldg4(w + ((long long)k * channels + c0 + c) * F + 4 * f4);
    wt_s[(4 * f4 + 0) * LDC + c] = v.x;
    wt_s[(4 * f4 + 1) * LDC + c] = v.y;
    wt_s[(4 * f4 + 2) * LDC + c] = v.z;
    wt_s[(4 * f4 + 3) * LDC + c] = v.w;
  }
  stage_rows(b_s, b_b + (long long)k * channels, j_count, (long long)stride * channels, tid);
  for (int idx = tid; idx < j_count * CT; idx += THREADS) db_s[idx] = 0.f;

  // a tile's g, element idx = tid + THREADS * q: row m = idx % BM, features
  // 4 * (idx / BM) .. + 3 (lanes along m: the transposed store has no
  // bank conflict)
  float4 g_next[G_VECS];
  auto fetch_g = [&](int i0, int rows) {
#pragma unroll
    for (int q = 0; q < G_VECS; ++q) {
      const int idx = tid + THREADS * q, m = idx % BM, f4 = idx / BM;
      g_next[q] = m < rows ? ldg4(g_b + ((long long)i0 * j_count + m) * F + 4 * f4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  fetch_g(0, min(ti_max, width) * j_count);

  for (int i0 = 0; i0 < width; i0 += ti_max) {
    const int ti = min(ti_max, width - i0), rows = ti * j_count;
#pragma unroll
    for (int q = 0; q < G_VECS; ++q) {
      const int idx = tid + THREADS * q, m = idx % BM, f4 = idx / BM;
      gt_s[(4 * f4 + 0) * LDM + m] = g_next[q].x;
      gt_s[(4 * f4 + 1) * LDM + m] = g_next[q].y;
      gt_s[(4 * f4 + 2) * LDM + m] = g_next[q].z;
      gt_s[(4 * f4 + 3) * LDM + m] = g_next[q].w;
    }
    stage_rows(a_s, a_b + (long long)i0 * channels, ti, channels, tid);
    __syncthreads();
    if (i0 + ti_max < width)
      fetch_g(i0 + ti_max, min(ti_max, width - i0 - ti_max) * j_count);

    // gw: thread rows 4 ty + {0..3} and 64 + 4 ty + {0..3}, channels
    // 4 tx + {0..3} and 64 + 4 tx + {0..3}
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
#pragma unroll 4
    for (int f = 0; f < F; ++f) {
      const float4 g0 = lds4(gt_s + f * LDM + 4 * ty), g1 = lds4(gt_s + f * LDM + 64 + 4 * ty);
      const float4 w0 = lds4(wt_s + f * LDC + 4 * tx), w1 = lds4(wt_s + f * LDC + 64 + 4 * tx);
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(gv[r], wv[q], acc[r][q]);
    }

    // times sign(diff), into shared memory
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = (r / 4) * 64 + 4 * ty + r % 4;
      if (m < rows) {
        const int il = m / j_count, j = m - il * j_count;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 64 * h + 4 * tx;
          const float4 av = lds4(a_s + il * LDC + c), bv = lds4(b_s + j * LDC + c);
          *reinterpret_cast<float4*>(gd_s + m * LDC + c) =
              make_float4(acc[r][4 * h + 0] * sign0(av.x - bv.x),
                          acc[r][4 * h + 1] * sign0(av.y - bv.y),
                          acc[r][4 * h + 2] * sign0(av.z - bv.z),
                          acc[r][4 * h + 3] * sign0(av.w - bv.w));
        }
      }
    }
    __syncthreads();

    // da: this tap's sum over j; db: this tile's sum over i, kept per block
    for (int idx = tid; idx < ti * CT; idx += THREADS) {
      const int il = idx / CT, c = idx % CT;
      float s = 0.f;
      for (int j = 0; j < j_count; ++j) s += gd_s[(il * j_count + j) * LDC + c];
      da_part[(((long long)batch * stride + k) * width + i0 + il) * channels + c0 + c] = s;
    }
    for (int idx = tid; idx < j_count * CT; idx += THREADS) {
      const int j = idx / CT, c = idx % CT;
      float s = 0.f;
      for (int il = 0; il < ti; ++il) s += gd_s[(il * j_count + j) * LDC + c];
      db_s[idx] += s;
    }
    // the next tile's stores to gt_s and a_s follow the barrier above; its
    // stores to gd_s follow its own first barrier, after these sums
  }
  for (int idx = tid; idx < j_count * CT; idx += THREADS) {
    const int j = idx / CT, c = idx % CT;
    db[((long long)batch * width + (long long)stride * j + k) * channels + c0 + c] = -db_s[idx];
  }
}

// One batch element's part of dW[k]. Grid (S, B, C / CT).
__global__ void __launch_bounds__(THREADS, 1)
dw_kernel(const float* __restrict__ a, const float* __restrict__ bb,
          const float* __restrict__ g, float* __restrict__ dw_part, int width, int channels,
          int stride, int j_count, int ti_max) {
  extern __shared__ float4 smem4[];
  float* g_s = reinterpret_cast<float*>(smem4);  // [BM][F]; at the end the halves' sums
  float* b_s = g_s + BM * F;                     // [J][LDC]
  float* a_s = b_s + j_count * LDC;              // [ti_max][LDC]

  const int k = blockIdx.x, batch = blockIdx.y, c0 = blockIdx.z * CT;
  const int tid = threadIdx.x, half = tid / 128, t = tid % 128, tx = t % 8, ty = t / 8;
  const float* a_b = a + (long long)batch * width * channels + c0;
  const float* b_b = bb + (long long)batch * width * channels + c0;
  const float* g_b = g + (long long)batch * width * j_count * F;

  stage_rows(b_s, b_b + (long long)k * channels, j_count, (long long)stride * channels, tid);

  // a tile's g in its own layout: element idx = tid + THREADS * q is row
  // idx / 16, features 4 * (idx % 16) .. + 3
  float4 g_next[G_VECS];
  auto fetch_g = [&](int i0, int rows) {
#pragma unroll
    for (int q = 0; q < G_VECS; ++q) {
      const int idx = tid + THREADS * q, m = idx / (F / 4), f4 = idx % (F / 4);
      g_next[q] = m < rows ? ldg4(g_b + ((long long)i0 * j_count + m) * F + 4 * f4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  fetch_g(0, min(ti_max, width) * j_count);

  // thread channels 4 ty + {0..3} and 64 + 4 ty + {0..3}, features
  // 4 tx + {0..3} and 32 + 4 tx + {0..3}; the halves take j of their parity
  float acc[8][8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int p = 0; p < 8; ++p) acc[q][p] = 0.f;

  for (int i0 = 0; i0 < width; i0 += ti_max) {
    const int ti = min(ti_max, width - i0);
#pragma unroll
    for (int q = 0; q < G_VECS; ++q)
      *reinterpret_cast<float4*>(g_s + 4 * (tid + THREADS * q)) = g_next[q];
    stage_rows(a_s, a_b + (long long)i0 * channels, ti, channels, tid);
    __syncthreads();
    if (i0 + ti_max < width)
      fetch_g(i0 + ti_max, min(ti_max, width - i0 - ti_max) * j_count);

    for (int il = 0; il < ti; ++il) {
      const float4 a0 = lds4(a_s + il * LDC + 4 * ty), a1 = lds4(a_s + il * LDC + 64 + 4 * ty);
      for (int j = half; j < j_count; j += 2) {
        const float4 b0 = lds4(b_s + j * LDC + 4 * ty), b1 = lds4(b_s + j * LDC + 64 + 4 * ty);
        const float* g_row = g_s + (il * j_count + j) * F;
        const float4 g0 = lds4(g_row + 4 * tx), g1 = lds4(g_row + 32 + 4 * tx);
        const float d[8] = {fabsf(a0.x - b0.x), fabsf(a0.y - b0.y), fabsf(a0.z - b0.z),
                            fabsf(a0.w - b0.w), fabsf(a1.x - b1.x), fabsf(a1.y - b1.y),
                            fabsf(a1.z - b1.z), fabsf(a1.w - b1.w)};
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int p = 0; p < 8; ++p) acc[q][p] = fmaf(d[q], gv[p], acc[q][p]);
      }
    }
    __syncthreads();  // before the next tile overwrites g_s and a_s
  }

  // the second half hands its sums over through g_s ([64 sums][128 threads])
  if (half == 1) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int p = 0; p < 8; ++p) g_s[(8 * q + p) * 128 + t] = acc[q][p];
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = (q / 4) * 64 + 4 * ty + q % 4;
      float* row = dw_part + (((long long)batch * stride + k) * channels + c0 + c) * F;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(row + 32 * h + 4 * tx) =
            make_float4(acc[q][4 * h + 0] + g_s[(8 * q + 4 * h + 0) * 128 + t],
                        acc[q][4 * h + 1] + g_s[(8 * q + 4 * h + 1) * 128 + t],
                        acc[q][4 * h + 2] + g_s[(8 * q + 4 * h + 2) * 128 + t],
                        acc[q][4 * h + 3] + g_s[(8 * q + 4 * h + 3) * 128 + t]);
    }
  }
}

// out[o][x] = sum_{s < n_sum} part[o][s][x], s in order; x in float4.
__global__ void sum_axis_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                                int n_sum, long long inner4) {
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= inner4) return;
  const float4* p = part + (long long)blockIdx.y * n_sum * inner4 + x;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < n_sum; ++i) {
    const float4 v = __ldg(p + (long long)i * inner4);
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
  out[(long long)blockIdx.y * inner4 + x] = s;
}

cudaError_t sum_axis(const float* part, float* out, int n_outer, int n_sum, long long inner,
                     cudaStream_t s) {
  const long long inner4 = inner / 4;
  const dim3 grid((unsigned)((inner4 + 255) / 256), n_outer);
  sum_axis_kernel<<<grid, 256, 0, s>>>(reinterpret_cast<const float4*>(part),
                                       reinterpret_cast<float4*>(out), n_sum, inner4);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound from Python with ctypes. All tensors are contiguous
// fp32 on the device of `stream`. `da`/`db` may both be null (no gradient
// for the volumes is asked) and so may `dw`; what is null is not computed.
// Scratch, caller-allocated: `da_part` batch * stride * width * channels
// floats (with da/db), `dw_part` batch * stride * channels * features floats
// (with dw). Rows of `db` from (width / stride) * stride on are left as they
// are. Returns 0 or a cudaError_t (cudaErrorInvalidValue when the sizes are
// outside what the kernels take: features != 64, channels not a multiple of
// 128, width / stride outside 1..128, or more shared memory than a block
// can have).
extern "C" int delta_conv1_backward(const float* a, const float* bb, const float* w,
                                    const float* g, float* da, float* db, float* dw,
                                    float* da_part, float* dw_part, int batch, int width,
                                    int channels, int stride, int features, void* stream) {
  if (features != F || channels < CT || channels % CT != 0 || stride < 1 || width < stride ||
      batch < 1 || batch > 65535 || (da == nullptr) != (db == nullptr))
    return (int)cudaErrorInvalidValue;
  const int j_count = width / stride;
  if (j_count > BM) return (int)cudaErrorInvalidValue;
  const int ti_max = BM / j_count;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(stride, batch, channels / CT);
  cudaError_t err;

  if (da != nullptr) {
    const size_t smem = sizeof(float) * ((size_t)F * LDC + (size_t)F * LDM + (size_t)BM * LDC +
                                         (size_t)j_count * (LDC + CT) + (size_t)ti_max * LDC);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(dab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    dab_kernel<<<grid, THREADS, smem, s>>>(a, bb, w, g, da_part, db, width, channels, stride,
                                           j_count, ti_max);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = sum_axis(da_part, da, batch, stride, (long long)width * channels, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (dw != nullptr) {
    const size_t smem =
        sizeof(float) * ((size_t)BM * F + (size_t)j_count * LDC + (size_t)ti_max * LDC);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    dw_kernel<<<grid, THREADS, smem, s>>>(a, bb, g, dw_part, width, channels, stride, j_count,
                                          ti_max);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = sum_axis(dw_part, dw, 1, batch, (long long)stride * channels * features, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
