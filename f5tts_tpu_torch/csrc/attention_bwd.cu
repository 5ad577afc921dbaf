// Attention backward kernels: K4 and its key-mask mode K8 (flat dQKV), and K9
// (head-layout dq/dk/dv from a saved row lse).
//
// K4: dQKV of K3 (fused QKV + interleaved RoPE + length-masked attention), flat layout.
// Replaces f5tts_tpu/ops/attention.py:886 _fused_qkv_bwd_kernel (n <= 1024) and
// :970 _fused_qkv_bwd_kernel_long (1024 < n <= 4096, launched from :1077) with one
// set of kernels for every n (the tail tile included).
//
// In:  qkv [b, n, 3*h*64] bf16 (the forward's input), cos/sin [>=n, h*64] bf16,
//      lengths [b] int32, out [b, n, h*64] bf16 and lse [b, h, n] f32 (K3's output
//      and row lse in its LSE mode), dO [b, n, h*64] bf16 (the incoming gradient).
// Out: dQKV [b, n, 3*h*64] bf16; scratch k_rot [b, h, n, 64] bf16 and
//      delta [b, h, n] f32.
//
// What it computes: q and k roped in f32 and rounded to bf16 (q NOT pre-scaled;
// the rounding points of the Pallas kernels, attention.py:876-959); p = exp(s *
// scale - lse) with s = q_rot k_rot^T, on live rows and keys, else 0; delta =
// rowsum(dO * O) in f32; dp = dO v^T; ds = p * (dp - delta); p and ds are rounded
// to bf16 before dv = p^T dO, dk = ds^T q_rot and dq = ds k_rot (f32
// accumulators); dq and dk are multiplied by the scale and un-roped (rope with
// -sin). The Pallas kernels take delta = rowsum(p * dp) from recomputed scores;
// the two are equal in exact arithmetic (O = p V) and differ by O's bf16
// rounding. K3's lse is that of its pre-scaled bf16 q; the scale 1/8 is a power
// of two, so it is exactly the statistic of the scores here. Dead query rows
// (>= length) are K3's zero rows, so their gradient is 0 for any dO: dO is read
// as 0 there. Dead keys get p = 0, so their dk and dv are exactly 0.
//
// K8: dQKV of K5 (the same attention under a [b, n] key mask, MMDiT's joint
// audio + text sequence). Replaces :1503 _fused_bias_bwd_kernel (joint n <= 1536,
// dispatch :1622-1641) and the bias-row branch of :970 _fused_qkv_bwd_kernel_long
// (1536 < n <= 4096), and covers every joint n past 4096 too, where the JAX
// package takes the XLA VJP of _bias_decomposed_ref. It is K4 in its BIAS mode,
// with kmask [b, n] bool in place of lengths and K5's output and lse: every
// query row is live (K5 computes every row; the caller masks dead rows after
// to_out), so dO is read as it is; a key is live where kmask is set. The
// block's kmask row is staged in shared memory, and 64-key tiles whose keys are
// all dead are skipped.
//
// Bound: tensor-core operations, 10*h*64*sum(live query x key pairs) flops (the
// 5 products of the function) against ~(3 + 2 + 3)*b*n*h*64*2 bytes. Design,
// three launches a backward, no atomics (deterministic):
//  - prologue, one thread per 8 lanes of a (row, head): q_rot into dQKV's dq
//    lanes (each dq block reads its own rows before it overwrites them), k_rot
//    into a head-layout scratch, delta. The main loops never rope again.
//  - dk/dv kernel, one block per (64*BW_WG keys, head, batch): BW_WG
//    warpgroups of 64 keys each (one, by measurement), K and V resident in
//    128-byte-swizzled shared tiles. The q tiles (64 rows of q_rot and dO, their lse and delta) stream
//    through a two-stage ring filled by cp.async, so the next tile's copy
//    overlaps this tile's products. s^T = K q^T and dp^T = V dO^T are wgmma
//    with both operands in shared memory; dv += p^T dO and dk += ds^T q are
//    wgmma with A from registers (the f32 accumulator repacked as bf16).
//    K4 stops at the last q tile with a live row.
//  - dq kernel, one block per (64*BW_WG query rows, head, batch): q_rot, dO,
//    lse and delta resident, K and V tiles streaming the same way: s, dp and
//    dq += ds K (7 products a live pair and head, with the dk/dv kernel's 4).
//    Scaling and un-roping are fused into the store epilogue, which writes
//    straight into the flat dQKV.
// K4 and K8 are template instantiations with their own __global__ entries, so
// the profiler names them apart.
//
// K9: the head-layout backward of K7, from the forward's saved row lse.
// Replaces :357 _flash_bwd_fused_kernel and the split pair :249
// _flash_bwd_dq_kernel + :300 _flash_bwd_dkv_kernel (all three compute one
// function; `_flash_backward` (:462) always takes the fused body).
// In:  q, k, v [b, h, n, 64] bf16 (already roped), lengths [b] int32, O (K7's
//      output) and dO [b, h, n, 64] bf16, lse [b, h, n] f32 (K7's lse mode).
// Out: dq, dk, dv [b, h, n, 64] bf16; scratch delta [b, h, n] f32.
// Function (the Pallas bodies'): a row is live where lse > -5e29 (K7 writes
// -1e30 on q tiles wholly past the length); p = exp(s * scale - lse) on live
// rows and keys < length, else 0; delta = rowsum(dO * O) in f32 (in XLA in the
// JAX package, :424; here in the dq kernel); ds = p * (dp - delta); p and ds
// are rounded to bf16 before dv = p^T dO, dk = ds^T q * scale, dq = ds k * scale.
// Design (mma.sync, synchronous loads):
//  - dq kernel per (64-row q tile, head, batch): skips a tile with no live row,
//    computes delta for its rows (written for the dk/dv kernel), then dq over
//    the key tiles up to the length;
//  - dk/dv kernel per (64-key tile, head, batch): over the q tiles that hold a
//    live row (a vote on their lse), s^T and dp^T computed transposed.
#include "common.cuh"

#define BW_T 64     // rows of a q tile and of a key tile
#define BW_LDS 72   // padded shared row (bf16): conflict-free fragment loads
#define BW_NEG -1e30f

// ---------------------------------------------------------------------------
// mma.sync helpers (K9)
// ---------------------------------------------------------------------------

// 64 rows x 64 lanes of bf16 from src (row stride `stride`); rows >= lim read as 0.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t stride, int r0,
                                          int lim, int tid) {
    for (int i = tid; i < BW_T * 8; i += 128) {
        const int r = i >> 3, c = (i & 7) * 8;
        const int row = r0 + r;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row < lim) v = *reinterpret_cast<const uint4*>(src + row * stride + c);
        *reinterpret_cast<uint4*>(dst + r * BW_LDS + c) = v;
    }
}

// Zero 64 lanes of rows [r0, min(r0 + 64, n)) of dst (row stride `stride`).
__device__ __forceinline__ void zero_rows(bf16* dst, size_t stride, int r0, int n, int tid) {
    for (int i = tid; i < BW_T * 8; i += 128) {
        const int row = r0 + (i >> 3);
        if (row < n)
            *reinterpret_cast<uint4*>(dst + row * stride + (i & 7) * 8) = make_uint4(0, 0, 0, 0);
    }
}

// A fragments of this warp's 16 rows of a [64][64] shared tile.
__device__ __forceinline__ void load_a(uint32_t a[4][4], const bf16* tile, int warp, int g,
                                       int t4) {
    const bf16* lo = tile + (warp * 16 + g) * BW_LDS + t4 * 2;
    const bf16* hi = lo + 8 * BW_LDS;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        a[kk][0] = lds32(lo + kk * 16);
        a[kk][1] = lds32(hi + kk * 16);
        a[kk][2] = lds32(lo + kk * 16 + 8);
        a[kk][3] = lds32(hi + kk * 16 + 8);
    }
}

// c[16 x 64] = A[16 x 64] . T^T for a row-major shared tile T [64 rows][64 lanes].
__device__ __forceinline__ void mma_abt(float c[8][4], const uint32_t a[4][4], const bf16* tile,
                                        int g, int t4) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
        const bf16* r = tile + (nt * 8 + g) * BW_LDS + t4 * 2;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            mma_16816(c[nt], a[kk], lds32(r + kk * 16), lds32(r + kk * 16 + 8));
    }
}

// acc[16 x 64] += bf16(P)[16 x 64] . T with P in accumulator layout (its 64
// columns are the contraction) and T a row-major shared tile [64][64 lanes].
__device__ __forceinline__ void mma_pt(float acc[8][4], const float p[8][4], const bf16* tile,
                                       int lane) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
        uint32_t pa[4];
        pa[0] = pack_bf16x2(p[2 * kc][0], p[2 * kc][1]);
        pa[1] = pack_bf16x2(p[2 * kc][2], p[2 * kc][3]);
        pa[2] = pack_bf16x2(p[2 * kc + 1][0], p[2 * kc + 1][1]);
        pa[3] = pack_bf16x2(p[2 * kc + 1][2], p[2 * kc + 1][3]);
        const bf16* base = tile + (kc * 16 + (lane & 15)) * BW_LDS + (lane >> 4) * 8;
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
            uint32_t bfr[4];
            ldsm_x4_trans(bfr, base + dp * 16);
            mma_16816(acc[2 * dp], pa, bfr[0], bfr[1]);
            mma_16816(acc[2 * dp + 1], pa, bfr[2], bfr[3]);
        }
    }
}

// Scale, optionally un-rope (rope with -sin), and store this warp's 16 rows of
// an accumulator as bf16 lanes h*64.. of dst (row stride `stride`).
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride, float acc[8][4], int row0,
                                           int n, int h, int hd, float scale, bool unrope,
                                           const bf16* cos_t, const bf16* sin_t, int t4) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + r * 8;
        if (row >= n) continue;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int lane_d = h * 64 + nt * 8 + t4 * 2;
            float x0 = acc[nt][2 * r] * scale, x1 = acc[nt][2 * r + 1] * scale;
            if (unrope) {
                const float2 c = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(cos_t + (size_t)row * hd + lane_d));
                const float2 s = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(sin_t + (size_t)row * hd + lane_d));
                const float y0 = x0 * c.x + x1 * s.x;
                const float y1 = x1 * c.y - x0 * s.y;
                x0 = y0;
                x1 = y1;
            }
            *reinterpret_cast<uint32_t*>(dst + row * stride + nt * 8 + t4 * 2) = pack_bf16x2(x0, x1);
        }
    }
}

// ---------------------------------------------------------------------------
// K4 / K8: prologue, dk/dv and dq kernels (wgmma, cp.async ring)
// ---------------------------------------------------------------------------

// Tiling of the flat dk/dv and dq kernels, measured on the H100 (PERF.md,
// `kernel_ab.py --other . --define ...`): one warpgroup a block (64 rows) is
// as fast as two at K4's n = 1024 and faster at K8's joint 1152 and K4's n =
// 3072 / 4096; three blocks an SM (<= 168 registers) take 10% off K8 at joint
// 3200 / 4352 and leave K4 as it was.
#ifndef BW_WG
#define BW_WG 1  // warpgroups a block: 64 rows each
#endif
#ifndef BW_MINB
#define BW_MINB 3  // the blocks an SM must hold at once (__launch_bounds__)
#endif
#define BW_LOG2E 1.4426950408889634f
#define BW_NT (128 * BW_WG)           // threads a block
#define BW_TILE 8192                  // bytes of one [64][64] bf16 tile, 128-byte rows
#define BW_SMEM_MAX 232448            // the opt-in maximum of dynamic shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
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
// This thread's copies have landed and are visible to wgmma (the async proxy);
// a __syncthreads after it makes every thread's copies visible.
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [r0, r0 + 64) of a bf16 matrix (64 lanes from src, row stride `stride`
// elements) into a 128-byte-swizzled tile at shared address dst (1024-aligned:
// 16-byte chunk c of row r at r * 128 + ((c ^ (r % 8)) * 16), the layout of
// wgmma's 128B swizzle); rows >= lim are zero-filled.
__device__ __forceinline__ void tile_async(uint32_t dst, const bf16* src, size_t stride, int r0,
                                           int lim, int tid) {
#pragma unroll
    for (int i = tid; i < 512; i += BW_NT) {
        const int r = i >> 3, c = i & 7;
        const int row = r0 + r;
        const bool ok = row < lim;
        cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), src + (size_t)(ok ? row : 0) * stride + c * 8,
                   ok);
    }
}

// wgmma matrix descriptor of a 128B-swizzled tile of 128-byte rows: the start
// address, 1024 bytes between groups of 8 rows (in both offset fields: a
// K-major operand reads it as the stride of its 8-row groups; an MN-major one,
// 64 wide, as the stride of its 8-row K groups), swizzle mode 128B.
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

// Scale, optionally un-rope (rope with -sin), and store this thread's rows of a
// 64 x 64 accumulator (row0 = the row of d[0]) as bf16 lanes h*64.. of dst
// (dst at lane h*64 of row 0, row stride `stride`).
__device__ __forceinline__ void store_acc(bf16* dst, size_t stride, const float (&d)[32], int row0,
                                          int n, int h, int hd, float scale, bool unrope,
                                          const bf16* cos_t, const bf16* sin_t, int t4) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + r * 8;
        if (row >= n) continue;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int lane_d = h * 64 + nt * 8 + t4 * 2;
            float x0 = d[4 * nt + 2 * r] * scale, x1 = d[4 * nt + 2 * r + 1] * scale;
            if (unrope) {
                const float2 c = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(cos_t + (size_t)row * hd + lane_d));
                const float2 s = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(sin_t + (size_t)row * hd + lane_d));
                const float y0 = x0 * c.x + x1 * s.x;
                const float y1 = x1 * c.y - x0 * s.y;
                x0 = y0;
                x1 = y1;
            }
            *reinterpret_cast<uint32_t*>(dst + row * stride + nt * 8 + t4 * 2) = pack_bf16x2(x0, x1);
        }
    }
}

// Zero 64 lanes of rows [r0, min(r0 + rows, n)) of dst (row stride `stride`).
__device__ __forceinline__ void zero_span(bf16* dst, size_t stride, int r0, int rows, int n,
                                          int tid) {
    for (int i = tid; i < rows * 8; i += BW_NT) {
        const int row = r0 + (i >> 3);
        if (row < n)
            *reinterpret_cast<uint4*>(dst + row * stride + (i & 7) * 8) = make_uint4(0, 0, 0, 0);
    }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

extern __shared__ __align__(16) uint8_t bw_smem[];

// Prologue: one thread per 8 lanes of a (row, head). q and k roped in f32 and
// rounded to bf16, q into the dq lanes of dqkv, k into krot [b, h, n, 64];
// delta [b, h, n] = rowsum(dO *
// O) in f32, dO read as 0 on dead rows (K4: >= length).
template <bool BIAS>
__device__ __forceinline__ void flat_bwd_prologue(
    const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
    const int* __restrict__ lengths, const bf16* __restrict__ out, const bf16* __restrict__ dout,
    bf16* __restrict__ dqkv, bf16* __restrict__ krot, float* __restrict__ delta, int bsz, int n,
    int heads) {
    const long long pair = (long long)blockIdx.x * 32 + (threadIdx.x >> 3);
    const int c = (threadIdx.x & 7) * 8;
    const int hd = heads * 64;
    const bool valid = pair < (long long)bsz * n * heads;
    const long long row = valid ? pair / heads : 0;  // b * n + i
    const int hh = (int)(pair - row * heads) * valid;
    const int bb = (int)(row / n), i = (int)(row - (long long)bb * n);
    float acc = 0.f;
    if (valid) {
        const int len = BIAS ? n : min(max(lengths[bb], 0), n);
        const bf16* src = qkv + row * 3 * hd + hh * 64 + c;
        float q[8], k[8], cs[8], sn[8];
        unpack8(*reinterpret_cast<const uint4*>(src), q);
        unpack8(*reinterpret_cast<const uint4*>(src + hd), k);
        unpack8(*reinterpret_cast<const uint4*>(cos_t + (size_t)i * hd + hh * 64 + c), cs);
        unpack8(*reinterpret_cast<const uint4*>(sin_t + (size_t)i * hd + hh * 64 + c), sn);
        rope8(q, cs, sn);
        rope8(k, cs, sn);
        *reinterpret_cast<uint4*>(dqkv + row * 3 * hd + hh * 64 + c) = pack8(q);
        *reinterpret_cast<uint4*>(krot + (((size_t)bb * heads + hh) * n + i) * 64 + c) = pack8(k);
        if (i < len) {
            float o[8], g[8];
            unpack8(*reinterpret_cast<const uint4*>(out + row * hd + hh * 64 + c), o);
            unpack8(*reinterpret_cast<const uint4*>(dout + row * hd + hh * 64 + c), g);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc += o[j] * g[j];
        }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    if (valid && c == 0) delta[((size_t)bb * heads + hh) * n + i] = acc;
}

// Shared-memory plan of the dk/dv kernel (every tile 1024-aligned): K and V
// tiles (BW_WG each), two stages of (q_rot tile, dO tile), then the two
// stages' lse[64] and delta[64].
#define DKV_STAGE (2 * BW_TILE)
#define DKV_LD (2 * BW_WG * BW_TILE + 2 * DKV_STAGE)
#define DKV_FIXED (DKV_LD + 2 * 512)

template <bool BIAS>
__device__ __forceinline__ void flat_bwd_dkdv(
    const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
    const int* __restrict__ lengths, const uint8_t* __restrict__ kmask,
    const float* __restrict__ lse, const bf16* __restrict__ dout, const bf16* __restrict__ krot,
    const float* __restrict__ delta, bf16* dqkv, int n, int heads, float scale) {
    const int k0 = blockIdx.x * 64 * BW_WG;
    const int h = blockIdx.y, b = blockIdx.z;
    const int hd = heads * 64;
    const int tid = threadIdx.x;
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t row3 = (size_t)3 * hd;
    const size_t bh = (size_t)b * heads + h;
    const int len = BIAS ? n : min(max(lengths[b], 0), n);
    const uint8_t* km = BIAS ? kmask + (size_t)b * n : nullptr;
    bf16* dkb = dqkv + (size_t)b * n * row3 + hd + h * 64;
    bf16* dvb = dkb + hd;

    bool dead;
    if constexpr (BIAS) {
        bool live = false;
        for (int j = tid; j < 64 * BW_WG; j += BW_NT) live |= k0 + j < n && km[k0 + j];
        dead = !__syncthreads_or(live);
    } else {
        dead = k0 >= len;
    }
    if (dead) {  // every key of the block is dead: dk = dv = 0
        zero_span(dkb, row3, k0, 64 * BW_WG, n, tid);
        zero_span(dvb, row3, k0, 64 * BW_WG, n, tid);
        return;
    }

    uint8_t* smem = align1024(bw_smem);
    const uint32_t sbase = smem_u32(smem);
    const uint32_t sK = sbase, sV = sbase + BW_WG * BW_TILE;
    const uint32_t sStage = sbase + 2 * BW_WG * BW_TILE;
    const uint32_t sLDs = sbase + DKV_LD;
    const float* sLD = reinterpret_cast<const float*>(smem + DKV_LD);

    const bf16* qb = dqkv + (size_t)b * n * row3 + h * 64;  // q_rot, in the dq lanes
    const bf16* ob = dout + (size_t)b * n * hd + h * 64;
    const float* lseb = lse + bh * n;
    const float* deltab = delta + bh * n;
    for (int j = 0; j < BW_WG; ++j) {
        tile_async(sK + j * BW_TILE, krot + bh * n * 64, 64, k0 + 64 * j, n, tid);
        tile_async(sV + j * BW_TILE, qkv + (size_t)b * n * row3 + 2 * hd + h * 64, row3,
                   k0 + 64 * j, n, tid);
    }
    auto load_stage = [&](int q0, int s) {
        const uint32_t st = sStage + s * DKV_STAGE;
        tile_async(st, qb, row3, q0, n, tid);
        tile_async(st + BW_TILE, ob, hd, q0, len, tid);
        for (int i = tid; i < 128; i += BW_NT) {
            const int row = q0 + (i & 63);
            const bool ok = row < len;
            cp_async4(sLDs + s * 512 + i * 4, (i < 64 ? lseb : deltab) + (ok ? row : 0), ok);
        }
        cp_async_commit();
    };

    // this thread's two accumulator rows are keys
    const int key_lo = k0 + wg * 64 + warp * 16 + g;
    bool key_live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int key = key_lo + r * 8;
        key_live[r] = BIAS ? (key < n && km[key]) : key < len;
    }
    const uint32_t aK = sK + wg * BW_TILE, aV = sV + wg * BW_TILE;
    const float scale2 = scale * BW_LOG2E;  // p = 2^(s * scale * log2(e) - lse * log2(e))

    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    const int n_qt = (len + 63) / 64;  // K4: only q tiles with a live row (K8: all)
    load_stage(0, 0);
    for (int qt = 0; qt < n_qt; ++qt) {
        const int q0 = qt * 64, s = qt & 1;
        cp_async_wait_all();
        __syncthreads();  // stage s landed; every thread is done with stage s ^ 1
        if (qt + 1 < n_qt) load_stage(q0 + 64, s ^ 1);
        const uint32_t sQ = sStage + s * DKV_STAGE, sO = sQ + BW_TILE;
        const float* sL = sLD + s * 128;
        const float* sD = sL + 64;

        float st[32], dpt[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // s^T = K q^T: 64 keys x 64 queries
            wgmma_ss<0>(st, sw128_desc(aK + kk * 32), sw128_desc(sQ + kk * 32), kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dp^T = V dO^T
            wgmma_ss<0>(dpt, sw128_desc(aV + kk * 32), sw128_desc(sO + kk * 32), kk);
        wg_commit();
        wg_wait0();
        fence_regs(st);
        fence_regs(dpt);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qi = nt * 8 + t4 * 2 + (e & 1);
                const bool live = key_live[e >> 1] && (BIAS || q0 + qi < len);
                const float p =
                    live ? exp2f(fmaf(st[4 * nt + e], scale2, -sL[qi] * BW_LOG2E)) : 0.f;
                st[4 * nt + e] = p;
                dpt[4 * nt + e] = p * (dpt[4 * nt + e] - sD[qi]);
            }
        }
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
            acc_to_a(pa[kc], st, kc);
            acc_to_a(da[kc], dpt, kc);
        }
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)  // dv += p^T dO (dO N-major: 16 q rows a step)
            wgmma_rs<1>(dv, pa[kc], sw128_desc(sO + kc * 2048), 1);
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)  // dk += ds^T q_rot
            wgmma_rs<1>(dk, da[kc], sw128_desc(sQ + kc * 2048), 1);
        wg_commit();
        wg_wait0();
        fence_regs(dv);
        fence_regs(dk);
    }
    cp_async_wait_all();
    store_acc(dkb, row3, dk, key_lo, n, h, hd, scale, true, cos_t, sin_t, t4);
    store_acc(dvb, row3, dv, key_lo, n, h, hd, 1.f, false, cos_t, sin_t, t4);
}

// Shared-memory plan of the dq kernel: q_rot and dO tiles (BW_WG each), then
// two stages of (k_rot tile, V tile), then (BIAS) the key mask as one 64-bit
// word a 64-key tile.
#define DQ_STAGE (2 * BW_TILE)
#define DQ_FIXED (2 * BW_WG * BW_TILE + 2 * DQ_STAGE)

template <bool BIAS>
__device__ __forceinline__ void flat_bwd_dq(
    const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
    const int* __restrict__ lengths, const uint8_t* __restrict__ kmask,
    const float* __restrict__ lse, const bf16* __restrict__ dout, const bf16* __restrict__ krot,
    const float* __restrict__ delta, bf16* dqkv, int n, int heads, float scale) {
    const int q0 = blockIdx.x * 64 * BW_WG;
    const int h = blockIdx.y, b = blockIdx.z;
    const int hd = heads * 64;
    const int tid = threadIdx.x;
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t row3 = (size_t)3 * hd;
    const size_t bh = (size_t)b * heads + h;
    const int len = BIAS ? n : min(max(lengths[b], 0), n);
    bf16* dqb = dqkv + (size_t)b * n * row3 + h * 64;

    if (!BIAS && q0 >= len) {  // no live row: dq = 0
        zero_span(dqb, row3, q0, 64 * BW_WG, n, tid);
        return;
    }

    uint8_t* smem = align1024(bw_smem);
    const uint32_t sbase = smem_u32(smem);
    const uint32_t sQ = sbase, sO = sbase + BW_WG * BW_TILE;
    const uint32_t sStage = sbase + 2 * BW_WG * BW_TILE;
    uint32_t* sBits = reinterpret_cast<uint32_t*>(smem + DQ_FIXED);  // BIAS: key j is bit j
    const int n_kt = (len + 63) / 64;

    const bf16* kb = krot + bh * n * 64;
    const bf16* vb = qkv + (size_t)b * n * row3 + 2 * hd + h * 64;
    for (int j = 0; j < BW_WG; ++j) {
        tile_async(sQ + j * BW_TILE, dqb, row3, q0 + 64 * j, n, tid);  // q_rot, then dq
        tile_async(sO + j * BW_TILE, dout + (size_t)b * n * hd + h * 64, hd, q0 + 64 * j, len, tid);
    }
    if constexpr (BIAS) {  // a warp packs 32 keys into a word by ballot
        const uint8_t* km = kmask + (size_t)b * n;
        for (int base = (tid >> 5) * 32; base < n_kt * 64; base += BW_NT) {
            const int key = base + lane;
            const unsigned bits = __ballot_sync(0xffffffffu, key < n && km[key]);
            if (lane == 0) sBits[base >> 5] = bits;
        }
        __syncthreads();
    }
    auto tile_bits = [&](int kt) -> uint64_t {
        return ((uint64_t)sBits[2 * kt + 1] << 32) | sBits[2 * kt];
    };
    auto next_tile = [&](int kt) -> int {  // the first tile >= kt with a live key
        if constexpr (BIAS)
            while (kt < n_kt && !tile_bits(kt)) ++kt;
        return kt;
    };
    auto load_stage = [&](int k0, int s) {
        const uint32_t st = sStage + s * DQ_STAGE;
        tile_async(st, kb, 64, k0, n, tid);
        tile_async(st + BW_TILE, vb, row3, k0, n, tid);
        cp_async_commit();
    };

    // this thread's two accumulator rows are queries
    const int row_lo = q0 + wg * 64 + warp * 16 + g;
    const float scale2 = scale * BW_LOG2E;  // p = 2^(s * scale * log2(e) - lse * log2(e))
    float lse2[2], dlt[2];
    bool row_live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_lo + r * 8;
        row_live[r] = row < len;
        lse2[r] = row_live[r] ? lse[bh * n + row] * BW_LOG2E : 0.f;
        dlt[r] = row_live[r] ? delta[bh * n + row] : 0.f;
    }
    const uint32_t aQ = sQ + wg * BW_TILE, aO = sO + wg * BW_TILE;

    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    int kt = next_tile(0);
    if (kt < n_kt) load_stage(kt * 64, 0);
    else cp_async_commit();
    for (int it = 0; kt < n_kt; ++it) {
        const int k0 = kt * 64, s = it & 1;
        cp_async_wait_all();
        __syncthreads();  // stage s landed; every thread is done with stage s ^ 1
        const int nxt = next_tile(kt + 1);
        if (nxt < n_kt) load_stage(nxt * 64, s ^ 1);
        const uint32_t sK = sStage + s * DQ_STAGE, sV = sK + BW_TILE;

        // BIAS: this thread's keys k0 + nt * 8 + t4 * 2 + {0, 1} are bits nt * 8 + {0, 1}
        const uint64_t kbits = BIAS ? tile_bits(kt) >> (t4 * 2) : 0;
        float sc[32], dp[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // s = q K^T: 64 queries x 64 keys
            wgmma_ss<0>(sc, sw128_desc(aQ + kk * 32), sw128_desc(sK + kk * 32), kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dp = dO V^T
            wgmma_ss<0>(dp, sw128_desc(aO + kk * 32), sw128_desc(sV + kk * 32), kk);
        wg_commit();
        wg_wait0();
        fence_regs(sc);
        fence_regs(dp);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = k0 + nt * 8 + t4 * 2 + (e & 1);
                const bool key_ok = BIAS ? (kbits >> (nt * 8 + (e & 1))) & 1 : key < len;
                const int r = e >> 1;
                const float p =
                    (key_ok && row_live[r]) ? exp2f(fmaf(sc[4 * nt + e], scale2, -lse2[r])) : 0.f;
                sc[4 * nt + e] = p * (dp[4 * nt + e] - dlt[r]);
            }
        }
        uint32_t da[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a(da[kc], sc, kc);
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)  // dq += ds K (K N-major: 16 keys a step)
            wgmma_rs<1>(dq, da[kc], sw128_desc(sK + kc * 2048), 1);
        wg_commit();
        wg_wait0();
        fence_regs(dq);
        kt = nxt;
    }
    cp_async_wait_all();
    store_acc(dqb, row3, dq, row_lo, n, h, hd, scale, true, cos_t, sin_t, t4);
}

#define FLAT_BWD_ARGS                                                                             \
    const bf16 *__restrict__ qkv, const bf16 *__restrict__ cos_t, const bf16 *__restrict__ sin_t, \
        const void *__restrict__ mask, const float *__restrict__ lse,                            \
        const bf16 *__restrict__ dout, const bf16 *__restrict__ krot,                            \
        const float *__restrict__ delta, bf16 *dqkv, int n, int heads, float scale
#define FLAT_BWD_PASS(BIAS)                                                                       \
    qkv, cos_t, sin_t, BIAS ? nullptr : (const int*)mask, BIAS ? (const uint8_t*)mask : nullptr, \
        lse, dout, krot, delta, dqkv, n, heads, scale
#define PROLOGUE_ARGS                                                                             \
    const bf16 *__restrict__ qkv, const bf16 *__restrict__ cos_t, const bf16 *__restrict__ sin_t, \
        const int *__restrict__ lengths, const bf16 *__restrict__ out,                           \
        const bf16 *__restrict__ dout, bf16 *__restrict__ dqkv, bf16 *__restrict__ krot,          \
        float *__restrict__ delta, int bsz, int n, int heads

// K4
__global__ void __launch_bounds__(256) attn_bwd_prologue_kernel(PROLOGUE_ARGS) {
    flat_bwd_prologue<false>(qkv, cos_t, sin_t, lengths, out, dout, dqkv, krot, delta, bsz, n, heads);
}
__global__ void __launch_bounds__(BW_NT, BW_MINB) attn_bwd_dkdv_kernel(FLAT_BWD_ARGS) {
    flat_bwd_dkdv<false>(FLAT_BWD_PASS(false));
}
__global__ void __launch_bounds__(BW_NT, BW_MINB) attn_bwd_dq_kernel(FLAT_BWD_ARGS) {
    flat_bwd_dq<false>(FLAT_BWD_PASS(false));
}

// K8
__global__ void __launch_bounds__(256) attn_bias_bwd_prologue_kernel(PROLOGUE_ARGS) {
    flat_bwd_prologue<true>(qkv, cos_t, sin_t, lengths, out, dout, dqkv, krot, delta, bsz, n, heads);
}
__global__ void __launch_bounds__(BW_NT, BW_MINB) attn_bias_bwd_dkdv_kernel(FLAT_BWD_ARGS) {
    flat_bwd_dkdv<true>(FLAT_BWD_PASS(true));
}
__global__ void __launch_bounds__(BW_NT, BW_MINB) attn_bias_bwd_dq_kernel(FLAT_BWD_ARGS) {
    flat_bwd_dq<true>(FLAT_BWD_PASS(true));
}

// ---------------------------------------------------------------------------
// K4 / K8 launch: prologue, dk/dv, dq on the caller's stream
// ---------------------------------------------------------------------------

typedef void (*flat_prologue_t)(const bf16*, const bf16*, const bf16*, const int*, const bf16*,
                                const bf16*, bf16*, bf16*, float*, int, int, int);
typedef void (*flat_kernel_t)(const bf16*, const bf16*, const bf16*, const void*, const float*,
                              const bf16*, const bf16*, const float*, bf16*, int, int, float);

static int launch_flat_bwd(flat_prologue_t prologue, flat_kernel_t dkdv, flat_kernel_t dq,
                           bool bias, const void* qkv, const void* cos_t, const void* sin_t,
                           const void* mask, const void* out, const void* lse, const void* dout,
                           void* dqkv, void* k_rot, void* delta, int b, int n, int heads,
                           float scale, void* stream) {
    if (b <= 0 || n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    const size_t rows = (size_t)b * n * heads;
    bf16* krot = (bf16*)k_rot;
    prologue<<<(unsigned)((rows + 31) / 32), 256, 0, s>>>(
        (const bf16*)qkv, (const bf16*)cos_t, (const bf16*)sin_t,
        bias ? nullptr : (const int*)mask, (const bf16*)out, (const bf16*)dout, (bf16*)dqkv, krot,
        (float*)delta, b, n, heads);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int dkv_smem = 1024 + DKV_FIXED;
    const int dq_smem = 1024 + DQ_FIXED + (bias ? (n + 63) / 64 * 8 : 0);
    if (dq_smem > BW_SMEM_MAX) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n + 64 * BW_WG - 1) / (64 * BW_WG), heads, b);
    dkdv<<<grid, BW_NT, dkv_smem, s>>>((const bf16*)qkv, (const bf16*)cos_t, (const bf16*)sin_t,
                                       mask, (const float*)lse, (const bf16*)dout, krot,
                                       (const float*)delta, (bf16*)dqkv, n, heads, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dq<<<grid, BW_NT, dq_smem, s>>>((const bf16*)qkv, (const bf16*)cos_t, (const bf16*)sin_t, mask,
                                    (const float*)lse, (const bf16*)dout, krot,
                                    (const float*)delta, (bf16*)dqkv, n, heads, scale);
    return (int)cudaGetLastError();
}

extern "C" int f5_fused_qkv_rope_attn_bwd_bf16(const void* qkv, const void* cos_t,
                                               const void* sin_t, const void* lengths,
                                               const void* out, const void* lse,
                                               const void* dout, void* dqkv, void* k_rot,
                                               void* delta, int b, int n, int heads, float scale,
                                               void* stream) {
    return launch_flat_bwd(attn_bwd_prologue_kernel, attn_bwd_dkdv_kernel, attn_bwd_dq_kernel,
                           false, qkv, cos_t, sin_t, lengths, out, lse, dout, dqkv, k_rot, delta,
                           b, n, heads, scale, stream);
}

extern "C" int f5_fused_qkv_rope_attn_bias_bwd_bf16(const void* qkv, const void* cos_t,
                                                    const void* sin_t, const void* kmask,
                                                    const void* out, const void* lse,
                                                    const void* dout, void* dqkv, void* k_rot,
                                                    void* delta, int b, int n, int heads,
                                                    float scale, void* stream) {
    return launch_flat_bwd(attn_bias_bwd_prologue_kernel, attn_bias_bwd_dkdv_kernel,
                           attn_bias_bwd_dq_kernel, true, qkv, cos_t, sin_t, kmask, out, lse, dout,
                           dqkv, k_rot, delta, b, n, heads, scale, stream);
}

// ---------------------------------------------------------------------------
// K9: head-layout backward from the saved row lse
// ---------------------------------------------------------------------------

#define BW_DEAD -5e29f  // a row whose lse is below this is dead (K7 writes -1e30)

__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ lengths, const bf16* __restrict__ o, const float* __restrict__ lse,
    const bf16* __restrict__ dout, bf16* __restrict__ dq, float* __restrict__ delta_out, int n,
    int heads, float scale) {
    const int q0 = blockIdx.x * BW_T;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int len = min(max(lengths[b], 0), n);
    const size_t rows = ((size_t)b * heads + h) * n;  // this (batch, head)'s row 0
    const float* lseb = lse + rows;
    bf16* dqb = dq + rows * 64;

    __shared__ __align__(16) bf16 sQ[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sO[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sK[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sV[BW_T * BW_LDS];
    __shared__ float sL[BW_T], sD[BW_T];

    const int row_t = q0 + tid;
    const float l_t = (tid < BW_T && row_t < n) ? lseb[row_t] : BW_NEG;
    if (!__syncthreads_or(l_t > BW_DEAD)) {  // no live row: dq = 0
        zero_rows(dqb, 64, q0, n, tid);
        if (tid < BW_T && row_t < n) delta_out[rows + row_t] = 0.f;
        return;
    }
    if (tid < BW_T) sL[tid] = l_t;
    load_rows(sQ, q + rows * 64, 64, q0, n, tid);
    load_rows(sO, dout + rows * 64, 64, q0, n, tid);
    load_rows(sK, o + rows * 64, 64, q0, n, tid);  // O, for delta only
    __syncthreads();
    {  // delta = rowsum(dO * O) in f32: two threads a row, 32 lanes each
        const int r = tid >> 1, c0 = (tid & 1) * 32;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < 32; c += 8) {
            float a[8], bb[8];
            unpack8(*reinterpret_cast<const uint4*>(sO + r * BW_LDS + c0 + c), a);
            unpack8(*reinterpret_cast<const uint4*>(sK + r * BW_LDS + c0 + c), bb);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc += a[j] * bb[j];
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if ((tid & 1) == 0) {
            sD[r] = acc;
            if (q0 + r < n) delta_out[rows + q0 + r] = acc;
        }
    }
    __syncthreads();
    uint32_t qa[4][4], oa[4][4];
    load_a(qa, sQ, warp, g, t4);
    load_a(oa, sO, warp, g, t4);

    const int row_lo = q0 + warp * 16 + g;
    float lse_r[2], dlt[2];
    bool live_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int i = warp * 16 + g + r * 8;
        lse_r[r] = sL[i];
        live_r[r] = sL[i] > BW_DEAD;
        dlt[r] = sD[i];
    }

    float s[8][4], dp[8][4], acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    const int n_kt = (len + BW_T - 1) / BW_T;
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BW_T;
        __syncthreads();  // the previous tile's (and delta's) shared reads are done
        load_rows(sK, k + rows * 64, 64, k0, n, tid);
        load_rows(sV, v + rows * 64, 64, k0, n, tid);
        __syncthreads();
        mma_abt(s, qa, sK, g, t4);
        mma_abt(dp, oa, sV, g, t4);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int key = k0 + nt * 8 + t4 * 2;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                const bool live = live_r[r] && key + (e & 1) < len;
                const float p = live ? __expf(s[nt][e] * scale - lse_r[r]) : 0.f;
                s[nt][e] = p * (dp[nt][e] - dlt[r]);
            }
        }
        mma_pt(acc, s, sK, lane);  // dq += ds K
    }
    store_rows(dqb, 64, acc, row_lo, n, 0, 0, scale, false, nullptr, nullptr, t4);
}

__global__ void __launch_bounds__(128) flash_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ lengths, const float* __restrict__ lse,
    const float* __restrict__ delta_in, const bf16* __restrict__ dout, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int n, int heads, float scale) {
    const int k0 = blockIdx.x * BW_T;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int len = min(max(lengths[b], 0), n);
    const size_t rows = ((size_t)b * heads + h) * n;
    bf16* dkb = dk + rows * 64;
    bf16* dvb = dv + rows * 64;

    if (k0 >= len) {  // dead key tile: dk = dv = 0
        zero_rows(dkb, 64, k0, n, tid);
        zero_rows(dvb, 64, k0, n, tid);
        return;
    }

    __shared__ __align__(16) bf16 sQ[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sO[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sK[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sV[BW_T * BW_LDS];
    __shared__ float sL[BW_T], sD[BW_T];

    load_rows(sK, k + rows * 64, 64, k0, n, tid);
    load_rows(sV, v + rows * 64, 64, k0, n, tid);
    __syncthreads();
    uint32_t ka[4][4], va[4][4];
    load_a(ka, sK, warp, g, t4);
    load_a(va, sV, warp, g, t4);

    const int key_lo = k0 + warp * 16 + g;
    const bool key_live[2] = {key_lo < len, key_lo + 8 < len};
    const float* lseb = lse + rows;
    float dka[8][4], dva[8][4], st[8][4], dpt[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
        dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
    }
    const int n_qt = (n + BW_T - 1) / BW_T;
    for (int qt = 0; qt < n_qt; ++qt) {
        const int q0 = qt * BW_T;
        const int row = q0 + tid;
        const float l_t = (tid < BW_T && row < n) ? lseb[row] : BW_NEG;
        const bool live_t = l_t > BW_DEAD;
        // ends the previous tile's shared reads; a q tile with no live row
        // contributes nothing and is skipped
        if (!__syncthreads_or(live_t)) continue;
        if (tid < BW_T) {
            sL[tid] = l_t;
            sD[tid] = live_t ? delta_in[rows + row] : 0.f;
        }
        load_rows(sQ, q + rows * 64, 64, q0, n, tid);
        load_rows(sO, dout + rows * 64, 64, q0, n, tid);
        __syncthreads();
        mma_abt(st, ka, sQ, g, t4);   // s^T: this warp's 16 keys x 64 queries
        mma_abt(dpt, va, sO, g, t4);  // dp^T
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int ql = nt * 8 + t4 * 2;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qi = ql + (e & 1);
                const bool live = key_live[e >> 1] && sL[qi] > BW_DEAD;
                const float p = live ? __expf(st[nt][e] * scale - sL[qi]) : 0.f;
                st[nt][e] = p;
                dpt[nt][e] = p * (dpt[nt][e] - sD[qi]);
            }
        }
        mma_pt(dva, st, sO, lane);   // dv += p^T dO
        mma_pt(dka, dpt, sQ, lane);  // dk += ds^T q
    }
    store_rows(dkb, 64, dka, key_lo, n, 0, 0, scale, false, nullptr, nullptr, t4);
    store_rows(dvb, 64, dva, key_lo, n, 0, 0, 1.f, false, nullptr, nullptr, t4);
}

extern "C" int f5_flash_attn_bwd_bf16(const void* q, const void* k, const void* v,
                                      const void* lengths, const void* o, const void* lse,
                                      const void* dout, void* dq, void* dk, void* dv,
                                      void* delta, int b, int n, int heads, float scale,
                                      void* stream) {
    if (b > 0 && n > 0) {
        dim3 grid((n + BW_T - 1) / BW_T, heads, b);
        cudaStream_t s = (cudaStream_t)stream;
        flash_bwd_dq_kernel<<<grid, 128, 0, s>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths, (const bf16*)o,
            (const float*)lse, (const bf16*)dout, (bf16*)dq, (float*)delta, n, heads, scale);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        flash_bwd_dkdv_kernel<<<grid, 128, 0, s>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths,
            (const float*)lse, (const float*)delta, (const bf16*)dout, (bf16*)dk, (bf16*)dv, n,
            heads, scale);
    }
    return (int)cudaGetLastError();
}
