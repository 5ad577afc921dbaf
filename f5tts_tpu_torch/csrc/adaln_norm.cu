// K1: AdaLN-modulated LayerNorm, y = LN(x) * (1 + scale[b]) + shift[b].
// K6: RMSNorm, y = x * rsqrt(mean(x^2) + eps) * w (UNetT's pre-norms).
//
// K1 replaces f5tts_tpu/ops/adaln_norm.py:48 _adaln_norm_kernel, K6 :97
// _rms_norm_kernel. Both are one row per block with the same layout.
// Bound: memory. Each row is read once and written once (8.4 MB per call at
// [2, 1024, 1024] bf16, about 2.5 us at 3.35 TB/s); the arithmetic is a few
// flops per byte. Design: one 128-thread block per row of the [b*n, d] view;
// each thread keeps its 16-byte vectors of the row in registers, so x is read
// from device memory once. The f32 one-pass statistics (s1, s2) are reduced
// with warp shuffles and then across the 4 warps in shared memory;
// var = max(s2/d - mean^2, 0) as the JAX kernel computes it. K6 keeps only
// s2 and scales by the weight row w [d] (f32 as the JAX package keeps it, or
// bf16 as the port's cast params hold it), (x * rstd) * w in f32.
#include "common.cuh"

#define AN_THREADS 128
#define AN_MAXV 4  // 16-byte vectors per thread: d <= 128 * 8 * 4 = 4096

__global__ void __launch_bounds__(AN_THREADS) adaln_norm_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ scale,
    const bf16* __restrict__ shift, bf16* __restrict__ out, int n, int d,
    long long scale_stride, long long shift_stride, float eps) {
    const long long row = blockIdx.x;
    const int b = (int)(row / n);
    const int tid = threadIdx.x;
    const int nvec = d / 8;
    const bf16* xr = x + row * d;

    float v[AN_MAXV][8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < AN_MAXV; ++j) {
        const int vi = tid + j * AN_THREADS;
        if (vi < nvec) {
            uint4 raw = *reinterpret_cast<const uint4*>(xr + vi * 8);
            unpack8(raw, v[j]);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                s1 += v[j][e];
                s2 += v[j][e] * v[j][e];
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    __shared__ float red[2][AN_THREADS / 32];
    if ((tid & 31) == 0) {
        red[0][tid >> 5] = s1;
        red[1][tid >> 5] = s2;
    }
    __syncthreads();
    s1 = 0.f;
    s2 = 0.f;
#pragma unroll
    for (int w = 0; w < AN_THREADS / 32; ++w) {
        s1 += red[0][w];
        s2 += red[1][w];
    }
    const float mean = s1 / d;
    const float var = fmaxf(s2 / d - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);

    const bf16* sc = scale + b * scale_stride;
    const bf16* sh = shift + b * shift_stride;
    bf16* orow = out + row * d;
#pragma unroll
    for (int j = 0; j < AN_MAXV; ++j) {
        const int vi = tid + j * AN_THREADS;
        if (vi < nvec) {
            float fs[8], fh[8], y[8];
            unpack8(*reinterpret_cast<const uint4*>(sc + vi * 8), fs);
            unpack8(*reinterpret_cast<const uint4*>(sh + vi * 8), fh);
#pragma unroll
            for (int e = 0; e < 8; ++e)
                y[e] = (v[j][e] - mean) * rstd * (1.f + fs[e]) + fh[e];
            *reinterpret_cast<uint4*>(orow + vi * 8) = pack8(y);
        }
    }
}

extern "C" int f5_adaln_norm_bf16(const void* x, const void* scale, const void* shift,
                                  void* out, int b, int n, int d,
                                  long long scale_stride, long long shift_stride,
                                  float eps, void* stream) {
    const long long rows = (long long)b * n;
    if (rows > 0) {
        adaln_norm_kernel<<<(unsigned)rows, AN_THREADS, 0, (cudaStream_t)stream>>>(
            (const bf16*)x, (const bf16*)scale, (const bf16*)shift, (bf16*)out, n, d,
            scale_stride, shift_stride, eps);
    }
    return (int)cudaGetLastError();
}

// w[i..i+8) as floats, from an f32 or a bf16 weight row
__device__ __forceinline__ void load_w8(const float* w, int i, float* f) {
    const float4 a = *reinterpret_cast<const float4*>(w + i);
    const float4 c = *reinterpret_cast<const float4*>(w + i + 4);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = c.x; f[5] = c.y; f[6] = c.z; f[7] = c.w;
}

__device__ __forceinline__ void load_w8(const bf16* w, int i, float* f) {
    unpack8(*reinterpret_cast<const uint4*>(w + i), f);
}

template <typename W>
__global__ void __launch_bounds__(AN_THREADS) rms_norm_kernel(
    const bf16* __restrict__ x, const W* __restrict__ w, bf16* __restrict__ out, int d,
    float eps) {
    const long long row = blockIdx.x;
    const int tid = threadIdx.x;
    const int nvec = d / 8;
    const bf16* xr = x + row * d;

    float v[AN_MAXV][8];
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < AN_MAXV; ++j) {
        const int vi = tid + j * AN_THREADS;
        if (vi < nvec) {
            unpack8(*reinterpret_cast<const uint4*>(xr + vi * 8), v[j]);
#pragma unroll
            for (int e = 0; e < 8; ++e) s2 += v[j][e] * v[j][e];
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    __shared__ float red[AN_THREADS / 32];
    if ((tid & 31) == 0) red[tid >> 5] = s2;
    __syncthreads();
    s2 = 0.f;
#pragma unroll
    for (int i = 0; i < AN_THREADS / 32; ++i) s2 += red[i];
    const float rstd = rsqrtf(s2 / d + eps);

    bf16* orow = out + row * d;
#pragma unroll
    for (int j = 0; j < AN_MAXV; ++j) {
        const int vi = tid + j * AN_THREADS;
        if (vi < nvec) {
            float fw[8], y[8];
            load_w8(w, vi * 8, fw);
#pragma unroll
            for (int e = 0; e < 8; ++e) y[e] = (v[j][e] * rstd) * fw[e];
            *reinterpret_cast<uint4*>(orow + vi * 8) = pack8(y);
        }
    }
}

extern "C" int f5_rms_norm_bf16(const void* x, const void* w, int w_is_f32, void* out,
                                long long rows, int d, float eps, void* stream) {
    if (rows > 0) {
        if (w_is_f32)
            rms_norm_kernel<float><<<(unsigned)rows, AN_THREADS, 0, (cudaStream_t)stream>>>(
                (const bf16*)x, (const float*)w, (bf16*)out, d, eps);
        else
            rms_norm_kernel<bf16><<<(unsigned)rows, AN_THREADS, 0, (cudaStream_t)stream>>>(
                (const bf16*)x, (const bf16*)w, (bf16*)out, d, eps);
    }
    return (int)cudaGetLastError();
}
