// Hopper building blocks shared by the wgmma kernels (K3, K5, K7 and K11 in
// attention.cu; K4, K8 and K9 in attention_bwd.cu; K10 in grouped_conv.cu):
// cp.async copies into 128-byte-swizzled shared tiles, the wgmma descriptors,
// fences and products on 64 x 64 bf16 tiles, and the accumulator repack.
#pragma once

#include "common.cuh"

#define WG_TILE 8192  // bytes of one [64][64] bf16 tile, 128-byte rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// 16 (4) bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// This thread's copies (and its generic-proxy shared stores) have landed and
// are visible to wgmma (the async proxy); a __syncthreads after it makes every
// thread's visible.
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Offset of 16-byte chunk c of row r in a 128-byte-swizzled tile (1024-aligned):
// r * 128 + ((c ^ (r % 8)) * 16), the layout of wgmma's 128B swizzle.
__device__ __forceinline__ uint32_t sw128_off(int r, int c) {
    return r * 128 + ((c ^ (r & 7)) << 4);
}

// Rows [r0, r0 + 64) of a bf16 matrix (64 lanes from src, row stride `stride`
// elements) into a 128-byte-swizzled tile at shared address dst, by the NT
// threads of the block; rows >= lim are zero-filled.
template <int NT>
__device__ __forceinline__ void tile_async(uint32_t dst, const bf16* src, size_t stride, int r0,
                                           int lim, int tid) {
#pragma unroll
    for (int i = tid; i < 512; i += NT) {
        const int r = i >> 3, c = i & 7;
        const int row = r0 + r;
        const bool ok = row < lim;
        cp_async16(dst + sw128_off(r, c), src + (size_t)(ok ? row : 0) * stride + c * 8, ok);
    }
}

// Zero 64 lanes of rows [r0, min(r0 + rows, n)) of dst (row stride `stride`).
template <int NT>
__device__ __forceinline__ void zero_span(bf16* dst, size_t stride, int r0, int rows, int n,
                                          int tid) {
    for (int i = tid; i < rows * 8; i += NT) {
        const int row = r0 + (i >> 3);
        if (row < n)
            *reinterpret_cast<uint4*>(dst + row * stride + (i & 7) * 8) = make_uint4(0, 0, 0, 0);
    }
}

// wgmma matrix descriptor of a 128B-swizzled tile of 128-byte rows: the start
// address, 1024 bytes between groups of 8 rows (in both offset fields: a
// K-major operand reads it as the stride of its 8-row groups; an MN-major one,
// 64 wide, as the stride of its 8-row K groups), swizzle mode 128B. A K-major
// operand's 16-deep slices are 32 bytes apart, an MN-major one's 2048.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)64 << 16) | ((uint64_t)64 << 32) |
           ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of wgmma's registers across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                                                   \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
    "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT32(d)                                                                            \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], bf16 in, f32 accumulate, A and B in
// shared memory (A K-major; B K-major for TRANS_B 0, N-major for 1).
// Accumulator layout (as mma.sync's per 8 columns): warp w of the warpgroup holds
// rows 16w + g and 16w + g + 8 (g = lane / 4); d[4i], d[4i + 1] are columns
// 8i + 2t, 8i + 2t + 1 (t = lane % 4) of row 16w + g, d[4i + 2], d[4i + 3] of row
// 16w + g + 8.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", %32, %33, p, 1, 1, 0, %35;\n}\n"
        : WG_OUT32(d)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// The same with A from registers: a[0..3] are this thread's mma.sync-layout A
// fragments (rows 16w + g / + 8, columns 2t.. / 2t + 8..) of the 16-deep slice.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : WG_OUT32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// Columns 16kc .. 16kc + 15 of a 64 x 64 accumulator as bf16 A fragments.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[32], int kc) {
    a[0] = pack_bf16x2(d[8 * kc], d[8 * kc + 1]);
    a[1] = pack_bf16x2(d[8 * kc + 2], d[8 * kc + 3]);
    a[2] = pack_bf16x2(d[8 * kc + 4], d[8 * kc + 5]);
    a[3] = pack_bf16x2(d[8 * kc + 6], d[8 * kc + 7]);
}

// One bit a key of a [n] bool key mask row into words[0 .. span / 32): key j
// is bit j % 32 of word j / 32 (one ballot a word, by the NT threads of the
// block; keys >= n are 0; span a multiple of 64). The caller synchronises
// before reading.
template <int NT>
__device__ __forceinline__ void mask_bits(uint32_t* words, const uint8_t* km, int n, int span,
                                          int tid) {
    const int lane = tid & 31;
    for (int base = (tid >> 5) * 32; base < span; base += NT) {
        const int key = base + lane;
        const unsigned bits = __ballot_sync(0xffffffffu, key < n && km[key]);
        if (lane == 0) words[base >> 5] = bits;
    }
}
