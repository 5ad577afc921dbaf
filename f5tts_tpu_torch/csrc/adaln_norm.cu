// K1: AdaLN-modulated LayerNorm, y = LN(x) * (1 + scale[b]) + shift[b].
// K6: RMSNorm, y = x * rsqrt(mean(x^2) + eps) * w (the UNetT's pre-norms and
// qk-norm's per-head rows).
//
// K1 replaces f5tts_tpu/ops/adaln_norm.py:48 _adaln_norm_kernel, K6 :97
// _rms_norm_kernel. Bound: memory. Each row is read once and written once
// (8.4 MB per call at [2, 1024, 1024] bf16, about 2.5 us at 3.35 TB/s); the
// arithmetic is a few flops per byte.
//
// K1: one 128-thread block per row of the [b*n, d] view; each thread keeps
// its 16-byte vectors of the row in registers, so x is read from device
// memory once. The f32 one-pass statistics (s1, s2) are reduced with warp
// shuffles and then across the 4 warps in shared memory;
// var = max(s2/d - mean^2, 0) as the JAX kernel computes it.
//
// K6: L = min(32, d / 8) lanes share a row (rounded up to 8, 16 or 32),
// each with V 16-byte vectors of it (V = 1 at d = 64: 4 rows a warp; V = 3
// at d = 768, 4 at 1024: a warp a row). The sum of squares is a segmented
// shuffle reduction over the row's lanes (no shared memory, no barrier),
// (x * rstd) * w in f32 with the weight row w [d] (f32 as the JAX package
// keeps it, or bf16 as the port's cast params hold it), one rounding. A
// persistent grid walks the rows; each thread issues the loads of its R =
// RN_VEC / V rows before it reduces any of them, so an SM keeps tens of KB
// in flight (one block a 64-wide row moved 128 bytes and waited on a
// barrier). The rows of x are addressed by up to three leading strides
// with the last dimension contiguous, so qk-norm hands K6 the head view of
// the q / k projection ([b, h, n, 64] inside [b, n, 3 * h * 64]) without a
// copy; the output is contiguous in x's logical shape.
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

#ifndef RN_VEC
// 16-byte vectors of x a thread loads before it reduces: R = RN_VEC / V rows.
// 2 measured 2% slower at [2, 16, 4096, 64] and 17% faster at [2, 16, 256,
// 64], 8 slower at both (`scripts/kernel_ab.py --define RN_VEC=...`).
#define RN_VEC 4
#endif
#define RN_THREADS 256

// Where the rows of x lie: row r = (i0 * n1 + i1) * n2 + i2 starts at element
// i0 * s0 + i1 * s1 + i2 * s2 (every stride a multiple of 8); its d values
// are contiguous. The output row r starts at r * d.
struct RnRows {
    int rows, n1, n2;
    long long s0, s1, s2;
};

template <typename W, int L, int V, int R>
__global__ void __launch_bounds__(RN_THREADS) rms_norm_kernel(
    const bf16* __restrict__ x, const W* __restrict__ w, bf16* __restrict__ out, const RnRows p,
    int d, float eps) {
    constexpr int SLOTS = RN_THREADS / L;  // rows a block holds at once
    constexpr bool W_REGS = V <= 4;        // the weight columns stay in registers
    const int lane = threadIdx.x % L, slot = threadIdx.x / L;
    const int nvec = d / 8;
    float fw[W_REGS ? V : 1][8];
    if constexpr (W_REGS) {
#pragma unroll
        for (int v = 0; v < V; ++v)
            if (lane + v * L < nvec) load_w8(w, (lane + v * L) * 8, fw[v]);
    }
    for (int base = blockIdx.x * SLOTS * R; base < p.rows; base += gridDim.x * SLOTS * R) {
        uint4 raw[R][V];
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const int row = base + j * SLOTS + slot;
            const unsigned i2 = (unsigned)row % p.n2, t = (unsigned)row / p.n2;
            const bf16* xr = x + (t / p.n1) * p.s0 + (t % p.n1) * p.s1 + i2 * p.s2;
#pragma unroll
            for (int v = 0; v < V; ++v) {
                const int vi = lane + v * L;
                raw[j][v] = row < p.rows && vi < nvec
                                ? *reinterpret_cast<const uint4*>(xr + vi * 8)
                                : make_uint4(0, 0, 0, 0);
            }
        }
        float s2[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
            s2[j] = 0.f;
#pragma unroll
            for (int v = 0; v < V; ++v) {
                float f[8];
                unpack8(raw[j][v], f);
#pragma unroll
                for (int e = 0; e < 8; ++e) s2[j] += f[e] * f[e];
            }
        }
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
            for (int j = 0; j < R; ++j) s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], off);
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const int row = base + j * SLOTS + slot;
            if (row >= p.rows) continue;
            const float rstd = rsqrtf(s2[j] / d + eps);
            bf16* orow = out + (size_t)row * d;
#pragma unroll
            for (int v = 0; v < V; ++v) {
                const int vi = lane + v * L;
                if (vi >= nvec) continue;
                float f[8], y[8], wl[8];
                unpack8(raw[j][v], f);
                if constexpr (W_REGS) {
#pragma unroll
                    for (int e = 0; e < 8; ++e) wl[e] = fw[v][e];
                } else {
                    load_w8(w, vi * 8, wl);
                }
#pragma unroll
                for (int e = 0; e < 8; ++e) y[e] = (f[e] * rstd) * wl[e];
                *reinterpret_cast<uint4*>(orow + vi * 8) = pack8(y);
            }
        }
    }
}

// A persistent grid: no more blocks than the card holds at once, nor than
// the rows need.
template <typename W, int L, int V>
static int launch_rms_norm(const bf16* x, const W* w, bf16* out, const RnRows& p, int d,
                           float eps, cudaStream_t stream) {
    constexpr int R = V >= RN_VEC ? 1 : RN_VEC / V;
    constexpr int ROWS_A_BLOCK = RN_THREADS / L * R;
    auto kernel = rms_norm_kernel<W, L, V, R>;
    // the blocks a card holds at once, asked once a device (host time counts:
    // the qk-norm MMDiT launches K6 1408 times a generate)
    int most = 0;
    const cudaError_t err = resident_blocks((const void*)kernel, RN_THREADS, 0, &most);
    if (err != cudaSuccess) return (int)err;
    const int need = (p.rows + ROWS_A_BLOCK - 1) / ROWS_A_BLOCK;
    const int blocks = min(need, most);
    kernel<<<blocks, RN_THREADS, 0, stream>>>(x, w, out, p, d, eps);
    return (int)cudaGetLastError();
}

template <typename W>
static int dispatch_rms_norm(const bf16* x, const W* w, bf16* out, const RnRows& p, int d,
                             float eps, cudaStream_t s) {
    const int nvec = d / 8;
    if (nvec <= 8) return launch_rms_norm<W, 8, 1>(x, w, out, p, d, eps, s);
    if (nvec <= 16) return launch_rms_norm<W, 16, 1>(x, w, out, p, d, eps, s);
    if (nvec <= 32) return launch_rms_norm<W, 32, 1>(x, w, out, p, d, eps, s);
    if (nvec <= 64) return launch_rms_norm<W, 32, 2>(x, w, out, p, d, eps, s);
    if (nvec <= 128) return launch_rms_norm<W, 32, 4>(x, w, out, p, d, eps, s);
    if (nvec <= 256) return launch_rms_norm<W, 32, 8>(x, w, out, p, d, eps, s);
    return launch_rms_norm<W, 32, 16>(x, w, out, p, d, eps, s);
}

// x: rows = n0 * n1 * n2 rows of d contiguous bf16 values at the strides
// s0, s1, s2 (elements); out: contiguous [rows, d]. d % 8 == 0, d <= 4096.
extern "C" int f5_rms_norm_bf16(const void* x, const void* w, int w_is_f32, void* out, int rows,
                                int n1, int n2, long long s0, long long s1, long long s2, int d,
                                float eps, void* stream) {
    if (d <= 0 || d % 8 || d > 4096) return (int)cudaErrorInvalidValue;
    if (rows <= 0) return (int)cudaGetLastError();
    if (n1 <= 0 || n2 <= 0) return (int)cudaErrorInvalidValue;
    const RnRows p{rows, n1, n2, s0, s1, s2};
    cudaStream_t s = (cudaStream_t)stream;
    if (w_is_f32)
        return dispatch_rms_norm((const bf16*)x, (const float*)w, (bf16*)out, p, d, eps, s);
    return dispatch_rms_norm((const bf16*)x, (const bf16*)w, (bf16*)out, p, d, eps, s);
}
