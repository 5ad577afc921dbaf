// K13: the dequant epilogue of the int8 W8A8 projections
// (f5tts_tpu_torch/ops/quant.py dequant_bias): out[r, c] =
// bf16(acc[r, c] * (row_scale[r] * col_scale[c]) + bias[c]), the int32
// accumulator of the s8 x s8 product (torch._int_mm) in, bf16 out.
//
// It has no Pallas counterpart: the JAX package's int8_linear_pre
// (f5tts_tpu/ops/quant.py:96) leaves the dequant to XLA, which fuses it into
// the dot on a TPU. Bound: memory, 4 bytes read and 2 written an element
// (37.7 MB at [2048, 3072], about 11.3 us at 3.35 TB/s); a few flops a byte.
//
// A thread owns 8 adjacent columns: it reads their column scales and bias
// once into registers, then walks rows of its tile (DQ_TY rows at once, the
// block's rows a grid stride apart), 32 bytes of int32 in and 16 bytes of
// bf16 out a row; a warp covers 256 columns of a row, 1 KB of contiguous
// reads. The arithmetic is the plain version's, rounding for rounding:
// row_scale * col_scale, then acc * that, then + bias, in f32 with
// __fmul_rn / __fadd_rn so nvcc does not contract them into an FMA (which
// rounds once, where the plain version rounds twice), then one rounding to
// bf16 (round to nearest even).
#include "common.cuh"

#define DQ_TX 32  // threads across a block's columns, 8 columns each: 256 columns
#define DQ_TY 8   // rows a block walks at once

template <bool kBias>
__global__ void __launch_bounds__(DQ_TX* DQ_TY) dequant_bias_kernel(
    const int* __restrict__ acc, const float* __restrict__ row_scale,
    const float* __restrict__ col_scale, const bf16* __restrict__ bias, bf16* __restrict__ out,
    int m, int n) {
    const int c = (blockIdx.x * DQ_TX + threadIdx.x) * 8;
    if (c >= n) return;  // n % 8 == 0: a thread's 8 columns are all in or all out
    float ws[8], bs[8] = {};
    {
        const float4 a = *reinterpret_cast<const float4*>(col_scale + c);
        const float4 b = *reinterpret_cast<const float4*>(col_scale + c + 4);
        ws[0] = a.x, ws[1] = a.y, ws[2] = a.z, ws[3] = a.w;
        ws[4] = b.x, ws[5] = b.y, ws[6] = b.z, ws[7] = b.w;
    }
    if constexpr (kBias) unpack8(*reinterpret_cast<const uint4*>(bias + c), bs);
    for (int r = blockIdx.y * DQ_TY + threadIdx.y; r < m; r += gridDim.y * DQ_TY) {
        const int4* src = reinterpret_cast<const int4*>(acc + (size_t)r * n + c);
        const int4 a0 = src[0], a1 = src[1];
        const int a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float xs = row_scale[r];
        float y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            y[e] = __fmul_rn(__int2float_rn(a[e]), __fmul_rn(xs, ws[e]));
            if constexpr (kBias) y[e] = __fadd_rn(y[e], bs[e]);
        }
        *reinterpret_cast<uint4*>(out + (size_t)r * n + c) = pack8(y);
    }
}

template <bool kBias>
static int launch_dequant(const int* acc, const float* row_scale, const float* col_scale,
                          const bf16* bias, bf16* out, int m, int n, cudaStream_t stream) {
    auto kernel = dequant_bias_kernel<kBias>;
    int most = 0;
    const cudaError_t err = resident_blocks((const void*)kernel, DQ_TX * DQ_TY, 0, &most);
    if (err != cudaSuccess) return (int)err;
    const int col_tiles = (n + 8 * DQ_TX - 1) / (8 * DQ_TX);
    const int row_tiles = (m + DQ_TY - 1) / DQ_TY;
    // a persistent grid: no more blocks than the card holds at once
    const dim3 grid(col_tiles, min(row_tiles, max(1, most / col_tiles)));
    kernel<<<grid, dim3(DQ_TX, DQ_TY), 0, stream>>>(acc, row_scale, col_scale, bias, out, m, n);
    return (int)cudaGetLastError();
}

// acc: contiguous [m, n] int32; row_scale: [m] f32; col_scale: [n] f32;
// bias: [n] bf16 or null; out: contiguous [m, n] bf16. n % 8 == 0, every
// pointer 16-byte aligned.
extern "C" int f5_dequant_bias_bf16(const void* acc, const void* row_scale,
                                    const void* col_scale, const void* bias, void* out, int m,
                                    int n, void* stream) {
    if (n <= 0 || n % 8 || m < 0) return (int)cudaErrorInvalidValue;
    if (m == 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    if (bias != nullptr)
        return launch_dequant<true>((const int*)acc, (const float*)row_scale,
                                    (const float*)col_scale, (const bf16*)bias, (bf16*)out, m, n,
                                    s);
    return launch_dequant<false>((const int*)acc, (const float*)row_scale,
                                 (const float*)col_scale, nullptr, (bf16*)out, m, n, s);
}
