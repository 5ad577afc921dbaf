// Hopper building blocks shared by the wgmma kernels (K3, K5, K7 and K11 in
// attention.cu; K4, K8 and K9 in attention_bwd.cu; K10 in grouped_conv.cu):
// cp.async and TMA copies into 128-byte-swizzled shared tiles, mbarriers and
// named barriers, the wgmma descriptors, fences and products on 64 x 32 to
// 64 x 256 bf16 tiles, and the accumulator repack.
//
// A [64][D] bf16 tile of the head width D (64, 128, 192, 256, 384 or 512)
// lies as D / 64 sub-tiles of 64 columns, WG_TILE bytes apart, each 128-byte
// swizzled (a row of more than 128 bytes fits no swizzle atom): 16-byte
// chunk c of row r is at (c / 8) * WG_TILE + sw128_off(r, c % 8). A [32][D]
// tile (the 32-row tiles of K9 at D = 384 / 512) lies the same way with
// sub-tiles WG_SUB32 bytes apart. A K-major operand's 16-deep slice kk is
// `kslice`; an N-major operand spans the sub-tiles through its descriptor's
// leading offset.
#pragma once

#include <cuda.h>

#include "common.cuh"

#define WG_TILE 8192   // bytes of one [64][64] bf16 tile, 128-byte rows
#define WG_SUB32 4096  // bytes of one [32][64] bf16 tile

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

// As cp_async_wait_all, but N of this thread's committed groups may still be
// pending (a ring of N + 2 stages: the oldest one landed).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Offset of 16-byte chunk c of row r in a 128-byte-swizzled tile (1024-aligned):
// r * 128 + ((c ^ (r % 8)) * 16), the layout of wgmma's 128B swizzle.
__device__ __forceinline__ uint32_t sw128_off(int r, int c) {
    return r * 128 + ((c ^ (r & 7)) << 4);
}

// Offset of 16-byte chunk c (of D / 8) of row r in a [64][D] tile.
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
    return (c >> 3) * WG_TILE + sw128_off(r, c & 7);
}

// Rows [r0, r0 + 64) of a bf16 matrix (D lanes from src, row stride `stride`
// elements) into a [64][D] tile at shared address dst, by the NT threads of
// the block; rows >= lim and the lanes at or past `cols` (a multiple of 8:
// the head layout's rows of a width d < D, read in place) are zero-filled.
template <int NT, int D>
__device__ __forceinline__ void tile_async(uint32_t dst, const bf16* src, size_t stride, int r0,
                                           int lim, int tid, int cols = D) {
    constexpr int DC = D / 8, SH = D == 64 ? 3 : 4;  // chunks a row, log2 of it
#pragma unroll
    for (int i = tid; i < 64 * DC; i += NT) {
        const int r = i >> SH, c = i & (DC - 1);
        const int row = r0 + r;
        const bool ok = row < lim && c * 8 < cols;
        cp_async16(dst + tile_off(r, c), src + (size_t)(ok ? row : 0) * stride + c * 8, ok);
    }
}

// Rows [r0, r0 + 64) and the CH 16-byte chunks from column c0 of a bf16
// matrix of `cols` columns (row stride `stride` elements) into chunks 0 ..
// CH - 1 of a [64][8 * CH] tile at dst (`tile_off`), by the NT threads of the
// block; rows >= lim and chunks at or past `cols` are zero-filled (the
// head-layout kernels' wide mode: sub-tiles of a head wider than 128).
template <int NT, int CH>
__device__ __forceinline__ void cols_async(uint32_t dst, const bf16* src, size_t stride, int r0,
                                           int lim, int c0, int cols, int tid) {
#pragma unroll
    for (int i = tid; i < 64 * CH; i += NT) {
        const int r = i / CH, c = i % CH;
        const int row = r0 + r, col = c0 + c * 8;
        const bool ok = row < lim && col < cols;
        cp_async16(dst + tile_off(r, c), src + (ok ? (size_t)row * stride + col : 0), ok);
    }
}

// A ring of STAGES shared-memory stages of UNIT bytes from `base`, fed one
// unit a stage in order (the wide mode's operands): `issue` copies the next
// unit (its `load(unit, stage address)`) as one commit group, empty past
// `total`; `next` waits until the oldest unit has landed in every thread,
// frees the stage of the unit before it (whose products the caller waited
// on) for the unit STAGES - 1 on, and returns the oldest unit's stage.
template <int STAGES, int UNIT>
struct UnitRing {
    uint32_t base;
    int total, issued = 0, used = 0;
    __device__ __forceinline__ uint32_t stage(int i) const { return base + (i % STAGES) * UNIT; }
    template <class Load>
    __device__ __forceinline__ void issue(Load&& load) {
        if (issued < total) load(issued, stage(issued));
        cp_async_commit();
        ++issued;
    }
    template <class Load>
    __device__ __forceinline__ void fill(Load&& load) {  // the first STAGES - 1 units
        for (int s = 0; s < STAGES - 1; ++s) issue(load);
    }
    template <class Load>
    __device__ __forceinline__ uint32_t next(Load&& load) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        issue(load);
        return stage(used++);
    }
};

// Zero the lanes < cols (<= D, a multiple of 8) of rows [r0, min(r0 + rows,
// n)) of dst (row stride `stride`).
template <int NT, int D>
__device__ __forceinline__ void zero_span(bf16* dst, size_t stride, int r0, int rows, int n,
                                          int tid, int cols = D) {
    constexpr int DC = D / 8, SH = D == 64 ? 3 : 4;
    for (int i = tid; i < rows * DC; i += NT) {
        const int row = r0 + (i >> SH), c = i & (DC - 1);
        if (row < n && c * 8 < cols)
            *reinterpret_cast<uint4*>(dst + row * stride + c * 8) = make_uint4(0, 0, 0, 0);
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

// The descriptor of an N-major B operand of a [64][D] tile (its rows the K
// dimension): at D = 64 `sw128_desc`; at D >= 128 the leading offset is the
// WG_TILE bytes between the 64-column halves, the swizzle atoms along N.
template <int D>
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr) {
    if constexpr (D == 64) return sw128_desc(addr);
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(WG_TILE >> 4) << 16) |
           ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

// Shared address of the 16-deep K slice kk of a K-major [64][D] tile (of a
// [32][D] one with sub = WG_SUB32).
__device__ __forceinline__ uint32_t kslice(uint32_t base, int kk, uint32_t sub = WG_TILE) {
    return base + (kk >> 2) * sub + (kk & 3) * 32;
}

// The descriptor of an N-major B operand whose 64-column sub-tiles lie `lbo`
// bytes apart (WG_SUB32: the sub-tiles of a [32][D] tile).
__device__ __forceinline__ uint64_t mn_desc_lbo(uint32_t addr, uint32_t lbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
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

#define WG_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_OUT16(d)                                                                            \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15])

// d[64 x 32] (+)= A[64 x 16] B[16 x 32], bf16 in, f32 accumulate, A and B in
// shared memory (A K-major; B a K-major tile of 32 rows for TRANS_B 0): the
// scores of K9's 32-row tiles at D = 384 / 512. The accumulator layout of
// the 64-wide product, 4 column groups.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_D16
        ", %16, %17, p, 1, 1, 0, %19;\n}\n"
        : WG_OUT16(d)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
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

#define WG_D64                                                                                    \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "  \
    "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "   \
    "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "    \
    "%56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_OUT64(d)                                                                              \
    WG_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),          \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),          \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),          \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),          \
        "+f"(d[62]), "+f"(d[63])

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers as above, B in
// shared memory (its descriptor `mn_desc<128>` for an N-major [64][128]
// tile). The accumulator layout of the 64-wide product, 16 column groups.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : WG_OUT64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

#define WG_D96 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, " \
    "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
    "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, " \
    "%73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, " \
    "%91, %92, %93, %94, %95}"
#define WG_OUT96(d) \
    WG_OUT64(d), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), \
        "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), \
        "+f"(d[94]), "+f"(d[95])
#define WG_D128 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, " \
    "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
    "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, " \
    "%73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, " \
    "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, " \
    "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, " \
    "%122, %123, %124, %125, %126, %127}"
#define WG_OUT128(d) \
    WG_OUT64(d), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), \
        "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), \
        "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), \
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), \
        "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d[64 x 192] and d[64 x 256] (+)= A[64 x 16] B[16 x N], A from registers,
// B an N-major [64][N] tile (`mn_desc<N>`: its leading offset spans the N /
// 64 halves): the native wide kernels' O += P V, dv, dk and dq products at
// the head width N. The accumulator layout of the 64-wide product, N / 8
// column groups.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " WG_D96
        ", {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        : WG_OUT96(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TRANS_B));
}
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_D128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : WG_OUT128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// Columns 16kc .. 16kc + 15 of a 64 x 64 (64 x 32) accumulator as bf16 A
// fragments.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N], int kc) {
    a[0] = pack_bf16x2(d[8 * kc], d[8 * kc + 1]);
    a[1] = pack_bf16x2(d[8 * kc + 2], d[8 * kc + 3]);
    a[2] = pack_bf16x2(d[8 * kc + 4], d[8 * kc + 5]);
    a[3] = pack_bf16x2(d[8 * kc + 6], d[8 * kc + 7]);
}

// Row r (0: the thread's row 16w + g, 1: that + 8) of its part of a 64 x 2N
// accumulator, times `scale`, as bf16 at dst (the row's column 2t): columns
// 8i + 2t, 8i + 2t + 1 of each group i with 8i < cols.
template <int N>
__device__ __forceinline__ void store_acc_row(bf16* dst, const float (&acc)[N], int r, float scale,
                                              int cols) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
        if (i * 8 < cols)
            *reinterpret_cast<uint32_t*>(dst + i * 8) =
                pack_bf16x2(acc[4 * i + 2 * r] * scale, acc[4 * i + 2 * r + 1] * scale);
}

// The wide mode's two products over a UnitRing, each unit waited on before
// the next `ring.next` frees its stage. acc (+)= A B^T over m units, a
// unit A's [64][64] sub-tile then B's (K-major): the scores S, S^T, dP or
// dP^T over the whole width.
template <class Ring, class Load>
__device__ __forceinline__ void ring_scores(float (&acc)[32], Ring& ring, Load& load, int m) {
    for (int u = 0; u < m; ++u) {
        const uint32_t st = ring.next(load);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<0>(acc, sw128_desc(st + kk * 32), sw128_desc(st + WG_TILE + kk * 32),
                        u | kk);
        wg_commit();
        wg_wait0();
    }
    fence_regs(acc);
}

// acc += A B over one unit, B an N-major [64][128] tile (16 rows a step), A
// a 64 x 64 bf16 operand in registers: O += P V, dv += p^T dO, dk += ds^T q
// or dq += ds k at one 128-column slice.
template <class Ring, class Load>
__device__ __forceinline__ void ring_slice_mma(float (&acc)[64], const uint32_t (&a)[4][4],
                                               Ring& ring, Load& load) {
    const uint32_t st = ring.next(load);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(acc, a[kc], mn_desc<128>(st + kc * 2048), 1);
    wg_commit();
    wg_wait0();
    fence_regs(acc);
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

// ---------------------------------------------------------------------------
// TMA, mbarriers and named barriers: the native wide kernels (K7 / K9 at D =
// 192, 256, 384 and 512). One thread copies a whole tile (`tma_rows`,
// `tma_boxes`, completion
// counted in bytes on a stage's "full" mbarrier); the warpgroups wait on it
// once a tile, and arrive on the stage's "empty" barrier when done with it,
// where the thread that refills the stage waits.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// After the inits, before any thread or copy uses the barriers.
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// One arrival that also expects `bytes` of copies to complete on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed. A wait
// that outlasts ~2^28 polls (seconds) traps: a kernel fault the launch
// reports, not a card that never finishes.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    uint32_t done, polls = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
        if (++polls == (1u << 28)) __trap();
    } while (!done);
}

// The barriers of a native kernel's plan at `bar`: one for its resident
// tiles (count 1), then STAGES "full" (count 1) and STAGES "empty" (count
// `readers`), initialised by thread 0 before the block's first barrier.
template <int STAGES>
__device__ __forceinline__ void init_stage_bars(uint32_t bar, int readers) {
    if (threadIdx.x == 0) {
        mbar_init(bar, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(bar + 8 + 8 * s, 1);
            mbar_init(bar + 8 + 8 * (STAGES + s), readers);
        }
        mbar_init_fence();
    }
    __syncthreads();
}

// Named barrier `id` (1..15; 0 is __syncthreads') over `threads` threads:
// `bar_sync` waits for them, `bar_arrive` counts this thread's arrival
// (its earlier shared-memory writes visible to the waiters) and goes on.
__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The first `nbox` 64-column boxes from column col0 of rows [row0, row0 +
// rows) of slice `bh` (its `head_tensor_map` of `rows`-row boxes) into the
// sub-tiles of a [rows][D] tile at dst, `sub` bytes apart, completing on
// `bar`: the boxes that hold columns < d (the caller zeroes the tile's
// later sub-tiles once; no copy writes them).
__device__ __forceinline__ void tma_boxes(uint32_t dst, const CUtensorMap* map, int row0, int bh,
                                          uint32_t bar, int nbox, uint32_t sub, int col0 = 0) {
    for (int c = 0; c < nbox; ++c)
        asm volatile(
            "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst + c * sub),
            "l"(reinterpret_cast<uint64_t>(map)), "r"(col0 + c * 64), "r"(row0), "r"(bh),
            "r"(bar)
            : "memory");
}

// Rows [row0, row0 + 64) of slice `bh` of a [b * h][n][d] bf16 tensor (its
// `head_tensor_map`, d <= D) into a [64][D] tile at dst (the D / 64 swizzled
// halves of `tile_off`: TMA's 128-byte swizzle is wgmma's), D / 64 copies of
// a [64][64] box completing on `bar` (each box's bytes in full); rows at or
// past n and columns at or past d arrive as zeros.
template <int D>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, int row0, int bh,
                                         uint32_t bar) {
    tma_boxes(dst, map, row0, bh, bar, D / 64, WG_TILE);
}

// Zero the sub-tiles [first, last) (`sub` bytes each) of each of the `count`
// tiles at base, base + stride, ... by the NT threads of the block, then
// order the stores before the async proxy's (wgmma's) reads; the caller's
// next block barrier makes them every thread's.
template <int NT>
__device__ __forceinline__ void zero_subtiles(uint8_t* base, int count, uint32_t stride, int first,
                                              int last, uint32_t sub) {
    const int per = (last - first) * (int)(sub / 16);
    for (int i = threadIdx.x; i < count * per; i += NT) {
        const int t = i / per, j = i - t * per;
        *reinterpret_cast<uint4*>(base + t * stride + first * sub + j * 16) = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Thread block clusters of two (the pair kernels: two blocks on the same
// rows, each owning half of the width): the block's rank in its cluster and
// a barrier over every thread of the cluster.
__device__ __forceinline__ int cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return (int)r;
}
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}
// The shared::cluster address of `addr` (a shared::cta address) in block
// `cta` of the cluster.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int cta) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(cta));
    return r;
}
// Four f32 to the shared::cluster address `addr` of another block, counted
// in bytes on its mbarrier at `bar` (a shared::cluster address): the pair
// kernels' hand-over of partial scores.
__device__ __forceinline__ void st_async4(uint32_t addr, float a, float b, float c, float d,
                                          uint32_t bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
        "[%5];\n" ::"r"(addr),
        "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
        : "memory");
}
// A warpgroup's 4N f32 of a partial to block `cta`'s buffer at `buf`
// (float j * 4 * 128 + 4 * tid + e its part e of group j), counted on its
// mbarrier `bar` (both shared::cta addresses here, mapped there); `recv`
// adds this block's buffer, where the other block wrote its partial, once
// its barrier phase `parity` has completed (the caller arms the barrier
// with the buffer's bytes once a phase).
template <int N>
__device__ __forceinline__ void send_partial(const float (&v)[N], uint32_t buf, uint32_t bar,
                                             int cta, int tid) {
    const uint32_t rbuf = mapa(buf, cta), rbar = mapa(bar, cta);
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
        st_async4(rbuf + (j * 128 + tid) * 16, v[4 * j], v[4 * j + 1], v[4 * j + 2],
                  v[4 * j + 3], rbar);
}
template <int N>
__device__ __forceinline__ void recv_partial(float (&v)[N], const float* buf, uint32_t bar,
                                             int parity, int tid) {
    mbar_wait(bar, parity);
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(buf + (j * 128 + tid) * 4);
        v[4 * j] += x.x;
        v[4 * j + 1] += x.y;
        v[4 * j + 2] += x.z;
        v[4 * j + 3] += x.w;
    }
}

// Host: the tile width D at which K7 / K9 read and write head-layout rows of
// width d in place: the least of 64, 128, 192, 256, 384 and 512 that holds
// d (d % 8 == 0: 16-byte rows); 0 past 512 (their slice mode) or for any
// other d.
inline int head_tile_width(int d) {
    if (d <= 0 || d % 8 || d > 512) return 0;
    return d <= 64 ? 64 : d <= 128 ? 128 : d <= 192 ? 192 : d <= 256 ? 256 : d <= 384 ? 384 : 512;
}

// Host: the TMA map of a contiguous [bh][n][d] bf16 tensor at `base` (d % 8
// == 0: TMA's global strides are multiples of 16 bytes): [rows][64] boxes
// (64 or 32 rows), 128-byte swizzle, rows past n and columns past d read as
// zeros.
// cuTensorMapEncodeTiled is the driver's; its address is asked of the
// runtime once.
inline cudaError_t head_tensor_map(CUtensorMap* map, const void* base, int bh, int n, int d,
                                   int rows = 64) {
    typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                               const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                               const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                               CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
    static Encode encode = nullptr;
    static std::once_flag once;
    std::call_once(once, [] {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) ==
                cudaSuccess &&
            found == cudaDriverEntryPointSuccess)
            encode = (Encode)fn;
    });
    if (!encode) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
    const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
    const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1}, step[3] = {1, 1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                              dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
