// Shared helpers for the hand-written sm_90a kernels of f5tts_tpu_torch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// Pack two floats into one 32-bit register of bf16 (lo in the low half, the
// element with the smaller index, as mma.sync fragments expect).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// D += A(16x16, row-major) * B(16x8, col-major), bf16 in, f32 accumulate.
// Fragment layout (g = lane / 4, t = lane % 4):
//   a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        float2 p = __bfloat1622float2(h[j]);
        f[2 * j] = p.x;
        f[2 * j + 1] = p.y;
    }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
    uint4 v;
    v.x = pack_bf16x2(f[0], f[1]);
    v.y = pack_bf16x2(f[2], f[3]);
    v.z = pack_bf16x2(f[4], f[5]);
    v.w = pack_bf16x2(f[6], f[7]);
    return v;
}

// Interleaved RoPE on 8 consecutive lanes (4 pairs) in f32:
// out[2i] = x[2i] c - x[2i+1] s, out[2i+1] = x[2i+1] c + x[2i] s.
__device__ __forceinline__ void rope8(float* x, const float* c, const float* s) {
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
        const float x0 = x[e], x1 = x[e + 1];
        x[e] = x0 * c[e] - x1 * s[e];
        x[e + 1] = x1 * c[e + 1] + x0 * s[e + 1];
    }
}
