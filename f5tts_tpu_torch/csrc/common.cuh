// Shared helpers for the hand-written sm_90a kernels of f5tts_tpu_torch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <vector>

typedef __nv_bfloat16 bf16;

// Host-side launch set-up, done once a device and kernel, not at every
// launch: a launch may be recorded into a CUDA graph and replayed later, and
// the first launches (a graph's warm-up) run eagerly before any capture.
// Every CUDA error is returned.

// Raise `kernel`'s dynamic shared memory limit to `bytes`, a fixed ceiling,
// at its first launch on the current device. The limit is never lowered, so
// no later launch can take it from under a launch a graph captured earlier.
inline cudaError_t smem_limit_once(const void* kernel, int bytes) {
    static std::mutex mu;
    static std::vector<std::pair<const void*, int>> done;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    for (const auto& d : done)
        if (d.first == kernel && d.second == dev) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) done.push_back({kernel, dev});
    return err;
}

// The blocks of `kernel` the current device holds at once (blocks an SM x
// SMs, at least one an SM) for `threads` a block and `smem` bytes of dynamic
// shared memory; asked once a (kernel, device, threads, smem).
inline cudaError_t resident_blocks(const void* kernel, int threads, int smem, int* blocks) {
    struct Entry {
        const void* kernel;
        int dev, threads, smem, blocks;
    };
    static std::mutex mu;
    static std::vector<Entry> seen;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    for (const auto& e : seen) {
        if (e.kernel == kernel && e.dev == dev && e.threads == threads && e.smem == smem) {
            *blocks = e.blocks;
            return cudaSuccess;
        }
    }
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    *blocks = std::max(1, per_sm) * sms;
    seen.push_back({kernel, dev, threads, smem, *blocks});
    return cudaSuccess;
}

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
