// Attention backward kernels: K4 and its key-mask mode K8 (flat dQKV), and K9
// (head-layout dq/dk/dv from a saved row lse), three modes of one core, each
// at the head width D = 64 and 128 (the JAX bodies' d in {64, 128},
// attention.py:1189 / :1628; K9 reads and writes rows of any width d <= D,
// d % 8 == 0, in place: the tiles' lanes at or past d zero-filled as they
// are copied, the gradients' not stored, in its NARROW instantiations; d =
// D runs the others, whose strides are constants). K9 takes d in (128, 256]
// the same way in its native wide kernels at D = 192 / 256
// (flash_bwd_native_*: the scores of a tile computed once over the whole
// width, the resident tiles copied once, the streamed ones through TMA
// stages, whose maps read the columns past d as zeros), d in (256, 512] in
// its pair kernels at D = 384 / 512 (flash_bwd_pair_*: clusters of two
// blocks each owning half of the width, trading partial scores) and any d >
// 512 in its slice mode (flash_bwd_wide_*: one 128-column output slice a
// block, the scores over the whole width, every operand streamed), all at
// the end of this file.
//
// K4: dQKV of K3 (fused QKV + interleaved RoPE + length-masked attention), flat layout.
// Replaces f5tts_tpu/ops/attention.py:886 _fused_qkv_bwd_kernel (n <= 1024) and
// :970 _fused_qkv_bwd_kernel_long (1024 < n <= 4096, launched from :1077) with one
// set of kernels for every n (the tail tile included).
//
// In:  qkv [b, n, 3*h*D] bf16 (the forward's input), cos/sin [>=n, h*D] bf16,
//      lengths [b] int32, out [b, n, h*D] bf16 and lse [b, h, n] f32 (K3's output
//      and row lse in its LSE mode), dO [b, n, h*D] bf16 (the incoming gradient).
// Out: dQKV [b, n, 3*h*D] bf16; scratch k_rot [b, h, n, D] bf16 and
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
// rounding. K3's lse is that of its pre-scaled bf16 q; at D = 64 the scale 1/8
// is a power of two, so it is exactly the statistic of the scores here (at D =
// 128 within q's bf16 rounding, as the from-lse plain version reads it too).
// Dead query rows
// (>= length) are K3's zero rows, so their gradient is 0 for any dO: dO is read
// as 0 there. Dead keys get p = 0, so their dk and dv are exactly 0.
//
// K8: dQKV of K5 (the same attention under a [b, n] key mask, MMDiT's joint
// audio + text sequence). Replaces :1503 _fused_bias_bwd_kernel (joint n <= 1536,
// dispatch :1622-1641) and the bias-row branch of :970 _fused_qkv_bwd_kernel_long
// (1536 < n <= 4096), and covers every joint n past 4096 too, where the JAX
// package takes the XLA VJP of _bias_decomposed_ref. It is the BIAS mode, with
// kmask [b, n] bool in place of lengths and K5's output and lse: every query
// row is live (K5 computes every row; the caller masks dead rows after
// to_out), so dO is read as it is; a key is live where kmask is set; 64-key
// tiles whose keys are all dead are skipped.
//
// K9: the head-layout backward of K7, from the forward's saved row lse.
// Replaces :357 _flash_bwd_fused_kernel and the split pair :249
// _flash_bwd_dq_kernel + :300 _flash_bwd_dkv_kernel (all three compute one
// function; `_flash_backward` (:462) always takes the fused body). It is the
// HEAD mode of the same core.
// In:  q, k, v [b, h, n, d] bf16 (already roped; d <= D), lengths [b] int32,
//      O (K7's output) and dO [b, h, n, d] bf16, lse [b, h, n] f32 (K7's lse
//      mode).
// Out: dq, dk, dv [b, h, n, d] bf16; scratch delta [b, h, n] f32.
// Function (the Pallas bodies'): a row is live where lse > -5e29 (K7 writes
// -1e30 on q tiles wholly past the length, so those tiles are skipped); a key
// is live where key < length; p = exp(s * scale - lse) on live pairs, else 0;
// delta = rowsum(dO * O) in f32 (in XLA in the JAX package, :424); ds = p *
// (dp - delta); p and ds are rounded to bf16 before dv = p^T dO, dk = ds^T q *
// scale, dq = ds k * scale. Rows past the length inside the last live q tile
// have a real lse (K7 computes them, as Pallas does) and their dO is used as
// given.
//
// Bound: tensor-core operations, 10*h*d*sum(live query x key pairs) flops (the
// 5 products of the function) against ~(3 + 2 + 3)*b*n*h*d*2 bytes. Design,
// three launches a backward, no atomics (deterministic):
//  - prologue, one thread per 8 lanes of a (row, head). Flat modes: q_rot into
//    dQKV's dq lanes (each dq block reads its own rows before it overwrites
//    them), k_rot into a head-layout scratch, delta; the main loops never rope
//    again. HEAD: delta only (q and k come roped).
//  - dk/dv kernel, one block per (64*BW_WG keys, head, batch): BW_WG
//    warpgroups of 64 keys each (one, by measurement), K and V resident in
//    128-byte-swizzled shared tiles (D = 128: two 64-column halves, as the
//    forward's). The q tiles (64 rows of q and dO, their
//    lse and delta) stream through a two-stage ring filled by cp.async, so the
//    next tile's copy overlaps this tile's products. s^T = K q^T and dp^T = V
//    dO^T are wgmma with both operands in shared memory; dv += p^T dO and dk
//    += ds^T q are wgmma with A from registers (the f32 accumulator repacked
//    as bf16). K4 and K9 stop at the last q tile with a live row.
//  - dq kernel, one block per (64*BW_WG query rows, head, batch): q, dO, lse
//    and delta resident, K and V tiles streaming the same way: s, dp and dq
//    += ds K (7 products a live pair and head, with the dk/dv kernel's 4).
//    Scaling (and in the flat modes un-roping) is fused into the store
//    epilogue, which writes straight into dQKV or the head-layout dq.
//  - D = 128: S^T and dP^T take 8 k-steps across the halves; the products
//    into dk / dv / dq are m64n128k16 with the N-major B's descriptor spanning
//    the halves. The dk/dv kernel holds two 64 x 128 f32 accumulators (128
//    registers a thread) beside S^T and dP^T (64): its D = 128
//    instantiation runs two blocks an SM, 255 registers a thread at most
//    (`BW_MINB_OF`), the dk and dv accumulators of its 64 keys in one
//    warpgroup, not split over two (which would compute S^T and dP^T twice).
// The modes are template instantiations with their own __global__ entries, so
// the profiler names them apart.
#include "wgmma.cuh"

// Tiling of the dk/dv and dq kernels, measured on the H100 (PERF.md,
// `kernel_ab.py --other . --define ...`): one warpgroup a block (64 rows) is
// as fast as two at K4's n = 1024 and faster at K8's joint 1152 and K4's n =
// 3072 / 4096; three blocks an SM (<= 168 registers) take 10% off K8 at joint
// 3200 / 4352 and leave K4 as it was.
#ifndef BW_WG
#define BW_WG 1  // warpgroups a block: 64 rows each
#endif
#ifndef BW_MINB
#define BW_MINB 3  // the blocks an SM must hold at once (__launch_bounds__) at D = 64
#endif
// at D = 128 two: a 255-register cap for the dk/dv kernel's 192 accumulator
// registers, and 2 x 97 KB of its shared plan. The wide mode (d > 128) keeps
// D = 128's accumulators a block (one 128-column slice) and its two blocks.
#define BW_MINB_OF(D) ((D) == 64 ? BW_MINB : 2)
#define BW_LOG2E 1.4426950408889634f
#define BW_DEAD -5e29f                // K9: a row whose lse is below this is dead
#define BW_NT (128 * BW_WG)           // threads a block
#define BW_SMEM_MAX 232448            // the opt-in maximum of dynamic shared memory

enum BwdMode { MODE_LEN = 0, MODE_BIAS = 1, MODE_HEAD = 2 };  // K4, K8, K9

// The pointers of one backward (null where a mode has none).
struct BwdArgs {
    const bf16 *qkv, *cos_t, *sin_t;  // flat modes: the forward's input and rope tables
    const bf16 *q, *k, *v;            // HEAD: roped q and k, and v
    const int* lengths;               // LEN, HEAD
    const uint8_t* kmask;             // BIAS
    const bf16 *out, *dout;           // the forward's output and the incoming gradient
    const float* lse;
    bf16* krot;                       // flat modes: k_rot scratch [b, h, n, D]
    float* delta;                     // scratch [b, h, n]
    bf16* dqkv;                       // flat modes: the output
    bf16 *dq, *dk, *dv;               // HEAD: the outputs
    int bsz, n, heads;
    int d;                            // HEAD: the width of every operand's rows (<= D)
    float scale;
};

// Row 0 of one (batch, head) of every operand, their row strides (elements)
// and the lanes a row holds: the flat modes read q_rot from dQKV's dq lanes,
// k_rot from the scratch, v from qkv and dO flat, D lanes a row; HEAD reads
// and writes the caller's [b, h, n, d] throughout, with NARROW d < D lanes
// a row, else d = D and every stride and limit a constant (as K7's
// `FwdView`).
template <int MODE, int D, bool NARROW = false>
struct BwdView {
    const bf16 *q, *k, *v, *dO;
    bf16 *dq, *dk, *dv;
    size_t qs, ks, vs, os, gs;  // q / dq, k, v, dO, dk / dv
    int cols;
    __device__ __forceinline__ BwdView(const BwdArgs& a, int b, int h) {
        const size_t bh = (size_t)b * a.heads + h, n = a.n;
        if constexpr (MODE == MODE_HEAD) {
            const int d = NARROW ? a.d : D;
            q = a.q + bh * n * d;
            k = a.k + bh * n * d;
            v = a.v + bh * n * d;
            dO = a.dout + bh * n * d;
            dq = a.dq + bh * n * d;
            dk = a.dk + bh * n * d;
            dv = a.dv + bh * n * d;
            qs = ks = vs = os = gs = d;
            cols = d;
        } else {
            const size_t hd = (size_t)a.heads * D, row3 = 3 * hd;
            bf16* base = a.dqkv + b * n * row3 + h * D;
            q = dq = base;
            dk = base + hd;
            dv = base + 2 * hd;
            k = a.krot + bh * n * D;
            v = a.qkv + b * n * row3 + 2 * hd + h * D;
            dO = a.dout + b * n * hd + h * D;
            qs = vs = gs = row3;
            ks = D;
            os = hd;
            cols = D;
        }
    }
};

// Scale, optionally un-rope (rope with -sin), and store this thread's rows of a
// 64 x D accumulator (row0 = the row of d[0]) as bf16 lanes 0..cols-1 of dst
// (dst at row 0, row stride `stride`; the rope tables' lanes are h*D..).
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, size_t stride, const float (&d)[D / 2],
                                          int row0, int n, int h, int hd, float scale,
                                          bool unrope, const bf16* cos_t, const bf16* sin_t,
                                          int t4, int cols) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + r * 8;
        if (row >= n) continue;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
            if (nt * 8 >= cols) continue;
            const int lane_d = h * D + nt * 8 + t4 * 2;
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

extern __shared__ __align__(16) uint8_t bw_smem[];

// The sum of v over the D / 8 consecutive lanes of a warp that hold one row.
template <int D>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
    for (int o = 1; o < D / 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Flat prologue: one thread per 8 lanes of a (row, head). q and k roped in f32
// and rounded to bf16, q into the dq lanes of dqkv, k into krot [b, h, n, D];
// delta [b, h, n] = rowsum(dO * O) in f32, dO read as 0 on dead rows (K4: >=
// length).
template <bool BIAS, int D>
__device__ __forceinline__ void flat_bwd_prologue(const BwdArgs& a) {
    const int n = a.n, heads = a.heads;
    constexpr int SH = D == 64 ? 3 : 4;  // a (row, head) is D / 8 threads of a 256-thread block
    const long long pair = (long long)blockIdx.x * (256 >> SH) + (threadIdx.x >> SH);
    const int c = (threadIdx.x & (D / 8 - 1)) * 8;
    const int hd = heads * D;
    const bool valid = pair < (long long)a.bsz * n * heads;
    const long long row = valid ? pair / heads : 0;  // b * n + i
    const int hh = (int)(pair - row * heads) * valid;
    const int bb = (int)(row / n), i = (int)(row - (long long)bb * n);
    float acc = 0.f;
    if (valid) {
        const int len = BIAS ? n : min(max(a.lengths[bb], 0), n);
        const bf16* src = a.qkv + row * 3 * hd + hh * D + c;
        float q[8], k[8], cs[8], sn[8];
        unpack8(*reinterpret_cast<const uint4*>(src), q);
        unpack8(*reinterpret_cast<const uint4*>(src + hd), k);
        unpack8(*reinterpret_cast<const uint4*>(a.cos_t + (size_t)i * hd + hh * D + c), cs);
        unpack8(*reinterpret_cast<const uint4*>(a.sin_t + (size_t)i * hd + hh * D + c), sn);
        rope8(q, cs, sn);
        rope8(k, cs, sn);
        *reinterpret_cast<uint4*>(a.dqkv + row * 3 * hd + hh * D + c) = pack8(q);
        *reinterpret_cast<uint4*>(a.krot + (((size_t)bb * heads + hh) * n + i) * D + c) = pack8(k);
        if (i < len) {
            float o[8], g[8];
            unpack8(*reinterpret_cast<const uint4*>(a.out + row * hd + hh * D + c), o);
            unpack8(*reinterpret_cast<const uint4*>(a.dout + row * hd + hh * D + c), g);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc += o[j] * g[j];
        }
    }
    acc = row_sum<D>(acc);
    if (valid && c == 0) a.delta[((size_t)bb * heads + hh) * n + i] = acc;
}

// HEAD prologue: delta [b, h, n] = rowsum(dO * O) in f32 over every row, one
// thread per 8 of the D lanes of a [b * h * n, d] row (the lanes at or past
// d add 0, as a zero-padded row's).
template <int D, bool NARROW>
__device__ __forceinline__ void head_bwd_prologue(const BwdArgs& a) {
    constexpr int SH = D == 64 ? 3 : 4;  // a row is D / 8 threads of a 256-thread block
    const long long row = (long long)blockIdx.x * (256 >> SH) + (threadIdx.x >> SH);
    const int c = (threadIdx.x & (D / 8 - 1)) * 8;
    const int d = NARROW ? a.d : D;
    const bool valid = row < (long long)a.bsz * a.heads * a.n;
    float acc = 0.f;
    if (valid && c < d) {
        float o[8], g[8];
        unpack8(*reinterpret_cast<const uint4*>(a.out + row * d + c), o);
        unpack8(*reinterpret_cast<const uint4*>(a.dout + row * d + c), g);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc += o[j] * g[j];
    }
    acc = row_sum<D>(acc);
    if (valid && c == 0) a.delta[row] = acc;
}

// Shared-memory plan of the dk/dv kernel (every tile 1024-aligned): K and V
// tiles (BW_WG each), two stages of (q tile, dO tile), then the two
// stages' lse[64] and delta[64]; a [64][D] tile is BW_TILE(D) bytes.
#define BW_TILE(D) ((D) / 64 * WG_TILE)
#define DKV_LD(D) (2 * BW_WG * BW_TILE(D) + 4 * BW_TILE(D))
#define DKV_FIXED(D) (DKV_LD(D) + 2 * 512)

template <int MODE, int D, bool NARROW = false>
__device__ __forceinline__ void bwd_dkdv(const BwdArgs& a) {
    constexpr bool BIAS = MODE == MODE_BIAS;
    constexpr int TILE = BW_TILE(D), NA = D / 2;  // NA: a 64 x D accumulator's registers
    const int n = a.n;
    const int k0 = blockIdx.x * 64 * BW_WG;
    const int h = blockIdx.y, b = blockIdx.z;
    const int hd = a.heads * D;
    const int tid = threadIdx.x;
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t bh = (size_t)b * a.heads + h;
    const int len = BIAS ? n : min(max(a.lengths[b], 0), n);
    const uint8_t* km = BIAS ? a.kmask + (size_t)b * n : nullptr;
    const BwdView<MODE, D, NARROW> t(a, b, h);

    bool dead;
    if constexpr (BIAS) {
        bool live = false;
        for (int j = tid; j < 64 * BW_WG; j += BW_NT) live |= k0 + j < n && km[k0 + j];
        dead = !__syncthreads_or(live);
    } else {
        dead = k0 >= len;
    }
    if (dead) {  // every key of the block is dead: dk = dv = 0
        zero_span<BW_NT, D>(t.dk, t.gs, k0, 64 * BW_WG, n, tid, t.cols);
        zero_span<BW_NT, D>(t.dv, t.gs, k0, 64 * BW_WG, n, tid, t.cols);
        return;
    }

    uint8_t* smem = align1024(bw_smem);
    const uint32_t sbase = smem_u32(smem);
    const uint32_t sK = sbase, sV = sbase + BW_WG * TILE;
    const uint32_t sStage = sbase + 2 * BW_WG * TILE;
    const uint32_t sLDs = sbase + DKV_LD(D);
    const float* sLD = reinterpret_cast<const float*>(smem + DKV_LD(D));

    // K4 reads dO, lse and delta as 0 past the length; K8 and K9 as they are
    const int row_lim = MODE == MODE_LEN ? len : n;
    const float* lseb = a.lse + bh * n;
    const float* deltab = a.delta + bh * n;
    for (int j = 0; j < BW_WG; ++j) {
        tile_async<BW_NT, D>(sK + j * TILE, t.k, t.ks, k0 + 64 * j, n, tid, t.cols);
        tile_async<BW_NT, D>(sV + j * TILE, t.v, t.vs, k0 + 64 * j, n, tid, t.cols);
    }
    auto load_stage = [&](int q0, int s) {
        const uint32_t st = sStage + s * 2 * TILE;
        tile_async<BW_NT, D>(st, t.q, t.qs, q0, n, tid, t.cols);
        tile_async<BW_NT, D>(st + TILE, t.dO, t.os, q0, row_lim, tid, t.cols);
        for (int i = tid; i < 128; i += BW_NT) {
            const int row = q0 + (i & 63);
            const bool ok = row < row_lim;
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
    const uint32_t aK = sK + wg * TILE, aV = sV + wg * TILE;
    const float scale2 = a.scale * BW_LOG2E;  // p = 2^(s * scale * log2(e) - lse * log2(e))

    float dk[NA], dv[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dk[i] = dv[i] = 0.f;
    // K4 / K9: only the q tiles up to the length (K9's tiles past it are
    // dead by K7's lse); K8: all
    const int n_qt = (len + 63) / 64;
    load_stage(0, 0);
    for (int qt = 0; qt < n_qt; ++qt) {
        const int q0 = qt * 64, s = qt & 1;
        cp_async_wait_all();
        __syncthreads();  // stage s landed; every thread is done with stage s ^ 1
        if (qt + 1 < n_qt) load_stage(q0 + 64, s ^ 1);
        const uint32_t sQ = sStage + s * 2 * TILE, sO = sQ + TILE;
        const float* sL = sLD + s * 128;
        const float* sD = sL + 64;

        float st[32], dpt[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // s^T = K q^T: 64 keys x 64 queries
            wgmma_ss<0>(st, sw128_desc(kslice(aK, kk)), sw128_desc(kslice(sQ, kk)), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // dp^T = V dO^T
            wgmma_ss<0>(dpt, sw128_desc(kslice(aV, kk)), sw128_desc(kslice(sO, kk)), kk);
        wg_commit();
        wg_wait0();
        fence_regs(st);
        fence_regs(dpt);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qi = nt * 8 + t4 * 2 + (e & 1);
                // K9's rows past n read lse 0 but a zero q and dO row: they add 0
                const bool row_ok = MODE == MODE_LEN    ? q0 + qi < len
                                    : MODE == MODE_HEAD ? sL[qi] > BW_DEAD
                                                        : true;
                const bool live = key_live[e >> 1] && row_ok;
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
            wgmma_rs<1>(dv, pa[kc], mn_desc<D>(sO + kc * 2048), 1);
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)  // dk += ds^T q
            wgmma_rs<1>(dk, da[kc], mn_desc<D>(sQ + kc * 2048), 1);
        wg_commit();
        wg_wait0();
        fence_regs(dv);
        fence_regs(dk);
    }
    cp_async_wait_all();
    constexpr bool FLAT = MODE != MODE_HEAD;
    store_acc<D>(t.dk, t.gs, dk, key_lo, n, h, hd, a.scale, FLAT, a.cos_t, a.sin_t, t4, t.cols);
    store_acc<D>(t.dv, t.gs, dv, key_lo, n, h, hd, 1.f, false, a.cos_t, a.sin_t, t4, t.cols);
}

// Shared-memory plan of the dq kernel: q and dO tiles (BW_WG each), then
// two stages of (K tile, V tile), then (BIAS) the key mask as one 64-bit
// word a 64-key tile.
#define DQ_FIXED(D) (2 * BW_WG * BW_TILE(D) + 4 * BW_TILE(D))

template <int MODE, int D, bool NARROW = false>
__device__ __forceinline__ void bwd_dq(const BwdArgs& a) {
    constexpr bool BIAS = MODE == MODE_BIAS;
    constexpr int TILE = BW_TILE(D), NA = D / 2;
    const int n = a.n;
    const int q0 = blockIdx.x * 64 * BW_WG;
    const int h = blockIdx.y, b = blockIdx.z;
    const int hd = a.heads * D;
    const int tid = threadIdx.x;
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t bh = (size_t)b * a.heads + h;
    const int len = BIAS ? n : min(max(a.lengths[b], 0), n);
    const BwdView<MODE, D, NARROW> t(a, b, h);

    // no live row (K4: past the length; K9: q tiles past the length, whose
    // lse K7 writes as -1e30): dq = 0
    if (!BIAS && q0 >= len) {
        zero_span<BW_NT, D>(t.dq, t.qs, q0, 64 * BW_WG, n, tid, t.cols);
        return;
    }

    uint8_t* smem = align1024(bw_smem);
    const uint32_t sbase = smem_u32(smem);
    const uint32_t sQ = sbase, sO = sbase + BW_WG * TILE;
    const uint32_t sStage = sbase + 2 * BW_WG * TILE;
    uint32_t* sBits = reinterpret_cast<uint32_t*>(smem + DQ_FIXED(D));  // BIAS: key j is bit j
    const int n_kt = (len + 63) / 64;

    for (int j = 0; j < BW_WG; ++j) {
        tile_async<BW_NT, D>(sQ + j * TILE, t.q, t.qs, q0 + 64 * j, n, tid,
                             t.cols);  // flat: q_rot, then dq
        tile_async<BW_NT, D>(sO + j * TILE, t.dO, t.os, q0 + 64 * j,
                             MODE == MODE_LEN ? len : n, tid, t.cols);
    }
    if constexpr (BIAS) {
        mask_bits<BW_NT>(sBits, a.kmask + (size_t)b * n, n, n_kt * 64, tid);
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
        const uint32_t st = sStage + s * 2 * TILE;
        tile_async<BW_NT, D>(st, t.k, t.ks, k0, n, tid, t.cols);
        tile_async<BW_NT, D>(st + TILE, t.v, t.vs, k0, n, tid, t.cols);
        cp_async_commit();
    };

    // this thread's two accumulator rows are queries
    const int row_lo = q0 + wg * 64 + warp * 16 + g;
    const float scale2 = a.scale * BW_LOG2E;  // p = 2^(s * scale * log2(e) - lse * log2(e))
    float lse2[2], dlt[2];
    bool row_live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_lo + r * 8;
        const float l = row < n ? a.lse[bh * n + row] : 0.f;
        row_live[r] = MODE == MODE_HEAD ? row < n && l > BW_DEAD : row < len;
        lse2[r] = row_live[r] ? l * BW_LOG2E : 0.f;
        dlt[r] = row_live[r] ? a.delta[bh * n + row] : 0.f;
    }
    const uint32_t aQ = sQ + wg * TILE, aO = sO + wg * TILE;

    float dq[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dq[i] = 0.f;
    int kt = next_tile(0);
    if (kt < n_kt) load_stage(kt * 64, 0);
    else cp_async_commit();
    for (int it = 0; kt < n_kt; ++it) {
        const int k0 = kt * 64, s = it & 1;
        cp_async_wait_all();
        __syncthreads();  // stage s landed; every thread is done with stage s ^ 1
        const int nxt = next_tile(kt + 1);
        if (nxt < n_kt) load_stage(nxt * 64, s ^ 1);
        const uint32_t sK = sStage + s * 2 * TILE, sV = sK + TILE;

        // BIAS: this thread's keys k0 + nt * 8 + t4 * 2 + {0, 1} are bits nt * 8 + {0, 1}
        const uint64_t kbits = BIAS ? tile_bits(kt) >> (t4 * 2) : 0;
        float sc[32], dp[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // s = q K^T: 64 queries x 64 keys
            wgmma_ss<0>(sc, sw128_desc(kslice(aQ, kk)), sw128_desc(kslice(sK, kk)), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // dp = dO V^T
            wgmma_ss<0>(dp, sw128_desc(kslice(aO, kk)), sw128_desc(kslice(sV, kk)), kk);
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
            wgmma_rs<1>(dq, da[kc], mn_desc<D>(sK + kc * 2048), 1);
        wg_commit();
        wg_wait0();
        fence_regs(dq);
        kt = nxt;
    }
    cp_async_wait_all();
    store_acc<D>(t.dq, t.qs, dq, row_lo, n, h, hd, a.scale, MODE != MODE_HEAD, a.cos_t, a.sin_t,
                 t4, t.cols);
}

// K4
template <int D>
__global__ void __launch_bounds__(256) attn_bwd_prologue_kernel(const BwdArgs a) {
    flat_bwd_prologue<false, D>(a);
}
template <int D>
__global__ void __launch_bounds__(BW_NT, BW_MINB_OF(D)) attn_bwd_dkdv_kernel(const BwdArgs a) {
    bwd_dkdv<MODE_LEN, D>(a);
}
template <int D>
__global__ void __launch_bounds__(BW_NT, BW_MINB_OF(D)) attn_bwd_dq_kernel(const BwdArgs a) {
    bwd_dq<MODE_LEN, D>(a);
}

// K8
template <int D>
__global__ void __launch_bounds__(256) attn_bias_bwd_prologue_kernel(const BwdArgs a) {
    flat_bwd_prologue<true, D>(a);
}
template <int D>
__global__ void __launch_bounds__(BW_NT, BW_MINB_OF(D)) attn_bias_bwd_dkdv_kernel(const BwdArgs a) {
    bwd_dkdv<MODE_BIAS, D>(a);
}
template <int D>
__global__ void __launch_bounds__(BW_NT, BW_MINB_OF(D)) attn_bias_bwd_dq_kernel(const BwdArgs a) {
    bwd_dq<MODE_BIAS, D>(a);
}

// K9 (NARROW: rows of d < D)
template <int D, bool NARROW>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const BwdArgs a) {
    head_bwd_prologue<D, NARROW>(a);
}
template <int D, bool NARROW>
__global__ void __launch_bounds__(BW_NT, BW_MINB_OF(D)) flash_bwd_dkdv_kernel(const BwdArgs a) {
    bwd_dkdv<MODE_HEAD, D, NARROW>(a);
}
template <int D, bool NARROW>
__global__ void __launch_bounds__(BW_NT, BW_MINB_OF(D)) flash_bwd_dq_kernel(const BwdArgs a) {
    bwd_dq<MODE_HEAD, D, NARROW>(a);
}

// ---------------------------------------------------------------------------
// K9's slice mode: the head-layout backward at a head width d > 128 (d % 8 == 0)
// ---------------------------------------------------------------------------

// The function of K9 at d > 128 (the wrapper sends it d > 512). A block
// computes one slice of at most 128
// output columns [c0, c0 + 128) of its 64 rows (blockIdx.y = head * slices
// + slice), so its accumulators are D = 128's; S^T / dP^T (S / dP in the dq
// kernel) contract the whole width, m = ceil(d / 64) products of 64-column
// sub-tiles. Every operand streams through one ring of BWW_STAGES 16 KB
// stages, a unit a stage, columns at or past d zero-filled as they are
// copied, so shared memory does not grow with d. Three launches, no
// atomics: delta, dk/dv, dq. Every slice recomputes the scores: at d = 256
// the tensor work is ~1.57x the function's.
#define BWW_NT 128
#define BWW_STAGES 4
#define BWW_UNIT (2 * WG_TILE)
#define BWW_SLICE 128
#define BWW_SMEM (1024 + BWW_STAGES * BWW_UNIT + 2 * 512)  // the ring, then two lse / delta slots

struct BwdWideArgs {
    const bf16 *q, *k, *v;  // [b, h, n, d], roped q and k
    const int* lengths;
    const bf16 *out, *dout;
    const float* lse;
    float* delta;           // scratch [b, h, n]
    bf16 *dq, *dk, *dv;
    int bsz, n, heads, d;
    float scale;
};

// delta [b, h, n] = rowsum(dO * O) in f32, a warp a row.
__global__ void __launch_bounds__(256) flash_bwd_wide_delta_kernel(const BwdWideArgs a) {
    const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= (long long)a.bsz * a.heads * a.n) return;
    float acc = 0.f;
    for (int c = lane * 8; c < a.d; c += 256) {
        float o[8], g[8];
        unpack8(*reinterpret_cast<const uint4*>(a.out + row * a.d + c), o);
        unpack8(*reinterpret_cast<const uint4*>(a.dout + row * a.d + c), g);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += o[e] * g[e];
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) a.delta[row] = acc;
}

// Scale and store this thread's rows of a 64 x 128 accumulator slice (row0
// = the row of acc[0]) as bf16 columns [c0, min(c0 + 128, d)) of dst [n, d].
__device__ __forceinline__ void store_slice(bf16* dst, const float (&acc)[64], int row0, int n,
                                            int d, int c0, float scale, int t4) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
        if (row0 + r * 8 < n)
            store_acc_row(dst + (size_t)(row0 + r * 8) * d + c0 + t4 * 2, acc, r, scale, d - c0);
}

// dk / dv of 64 keys at one slice. Units a q tile: m (k_u, q_u) pairs, m
// (v_u, dO_u) pairs, then the q tile's dO and q at the slice's columns
// (the B operands of dv += p^T dO and dk += ds^T q). The q tile's lse and
// delta ride with its first unit into one of two slots (a q tile has at
// least 8 units, more than the ring's lookahead, so a slot is rewritten
// only after its tile's softmax). A key block wholly past the length walks
// no q tile: its dk and dv are written as zeros.
__global__ void __launch_bounds__(BWW_NT, 2) flash_bwd_wide_dkdv_kernel(const BwdWideArgs a) {
    const int n = a.n, d = a.d;
    const int m = (d + 63) / 64;
    const int slices = (d + BWW_SLICE - 1) / BWW_SLICE;
    const int k0 = blockIdx.x * 64;
    const int h = blockIdx.y / slices, j = blockIdx.y - h * slices, b = blockIdx.z;
    const int c0 = j * BWW_SLICE;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t bh = (size_t)b * a.heads + h, off = bh * n * d;
    const bf16 *Q = a.q + off, *K = a.k + off, *V = a.v + off, *dO = a.dout + off;
    const float* lseb = a.lse + bh * n;
    const float* deltab = a.delta + bh * n;
    const int len = min(max(a.lengths[b], 0), n);
    const int n_qt = k0 < len ? (len + 63) / 64 : 0;  // the q tiles up to the length
    const int per_qt = 2 * m + 2;

    uint8_t* smem = align1024(bw_smem);
    const uint32_t sLDs = smem_u32(smem) + BWW_STAGES * BWW_UNIT;
    const float* sLD = reinterpret_cast<const float*>(smem + BWW_STAGES * BWW_UNIT);
    UnitRing<BWW_STAGES, BWW_UNIT> ring{smem_u32(smem), n_qt * per_qt};
    auto load = [&](int unit, uint32_t st) {
        const int qt = unit / per_qt, u = unit - qt * per_qt, q0 = qt * 64;
        if (u < m) {
            cols_async<BWW_NT, 8>(st, K, d, k0, n, u * 64, d, tid);
            cols_async<BWW_NT, 8>(st + WG_TILE, Q, d, q0, n, u * 64, d, tid);
            if (u == 0)
                for (int i = tid; i < 128; i += BWW_NT) {
                    const int row = q0 + (i & 63);
                    const bool ok = row < n;
                    cp_async4(sLDs + (qt & 1) * 512 + i * 4,
                              (i < 64 ? lseb : deltab) + (ok ? row : 0), ok);
                }
        } else if (u < 2 * m) {
            cols_async<BWW_NT, 8>(st, V, d, k0, n, (u - m) * 64, d, tid);
            cols_async<BWW_NT, 8>(st + WG_TILE, dO, d, q0, n, (u - m) * 64, d, tid);
        } else {
            cols_async<BWW_NT, 16>(st, u == 2 * m ? dO : Q, d, q0, n, c0, d, tid);
        }
    };
    ring.fill(load);

    // this thread's two accumulator rows are keys
    const int key_lo = k0 + warp * 16 + g;
    const bool key_live[2] = {key_lo < len, key_lo + 8 < len};
    const float scale2 = a.scale * BW_LOG2E;
    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    for (int qt = 0; qt < n_qt; ++qt) {
        float st[32], dpt[32];
        ring_scores(st, ring, load, m);   // s^T = K q^T: 64 keys x 64 queries
        ring_scores(dpt, ring, load, m);  // dp^T = V dO^T
        const float* sL = sLD + (qt & 1) * 128;
        const float* sD = sL + 64;
        const int q0 = qt * 64;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qi = nt * 8 + t4 * 2 + (e & 1);
                // a row past n, or of a q tile K7 wrote dead, adds nothing
                const bool live = key_live[e >> 1] && q0 + qi < n && sL[qi] > BW_DEAD;
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
        ring_slice_mma(dv, pa, ring, load);  // dv += p^T dO_slice
        ring_slice_mma(dk, da, ring, load);  // dk += ds^T q_slice
    }
    cp_async_wait_all();
    store_slice(a.dk + off, dk, key_lo, n, d, c0, a.scale, t4);
    store_slice(a.dv + off, dv, key_lo, n, d, c0, 1.f, t4);
}

// dq of 64 q rows at one slice. Units a key tile: m (q_u, k_u) pairs, m
// (dO_u, v_u) pairs, then the key tile's k at the slice's columns (the B
// operand of dq += ds k). A q tile wholly past the length (K7 wrote its lse
// dead) walks no key tile: its dq is written as zeros.
__global__ void __launch_bounds__(BWW_NT, 2) flash_bwd_wide_dq_kernel(const BwdWideArgs a) {
    const int n = a.n, d = a.d;
    const int m = (d + 63) / 64;
    const int slices = (d + BWW_SLICE - 1) / BWW_SLICE;
    const int q0 = blockIdx.x * 64;
    const int h = blockIdx.y / slices, j = blockIdx.y - h * slices, b = blockIdx.z;
    const int c0 = j * BWW_SLICE;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t bh = (size_t)b * a.heads + h, off = bh * n * d;
    const bf16 *Q = a.q + off, *K = a.k + off, *V = a.v + off, *dO = a.dout + off;
    const int len = min(max(a.lengths[b], 0), n);
    const int n_kt = q0 < len ? (len + 63) / 64 : 0;
    const int per_kt = 2 * m + 1;

    UnitRing<BWW_STAGES, BWW_UNIT> ring{smem_u32(align1024(bw_smem)), n_kt * per_kt};
    auto load = [&](int unit, uint32_t st) {
        const int kt = unit / per_kt, u = unit - kt * per_kt, kb = kt * 64;
        if (u < m) {
            cols_async<BWW_NT, 8>(st, Q, d, q0, n, u * 64, d, tid);
            cols_async<BWW_NT, 8>(st + WG_TILE, K, d, kb, n, u * 64, d, tid);
        } else if (u < 2 * m) {
            cols_async<BWW_NT, 8>(st, dO, d, q0, n, (u - m) * 64, d, tid);
            cols_async<BWW_NT, 8>(st + WG_TILE, V, d, kb, n, (u - m) * 64, d, tid);
        } else {
            cols_async<BWW_NT, 16>(st, K, d, kb, n, c0, d, tid);
        }
    };
    ring.fill(load);

    // this thread's two accumulator rows are queries
    const int row_lo = q0 + warp * 16 + g;
    const float scale2 = a.scale * BW_LOG2E;
    float lse2[2], dlt[2];
    bool row_live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_lo + r * 8;
        const float l = row < n ? a.lse[bh * n + row] : 0.f;
        row_live[r] = row < n && l > BW_DEAD;
        lse2[r] = row_live[r] ? l * BW_LOG2E : 0.f;
        dlt[r] = row_live[r] ? a.delta[bh * n + row] : 0.f;
    }
    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    for (int kt = 0; kt < n_kt; ++kt) {
        float sc[32], dp[32];
        ring_scores(sc, ring, load, m);  // s = q K^T: 64 queries x 64 keys
        ring_scores(dp, ring, load, m);  // dp = dO V^T
        const int k0 = kt * 64;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = k0 + nt * 8 + t4 * 2 + (e & 1);
                const int r = e >> 1;
                const float p = (key < len && row_live[r])
                                    ? exp2f(fmaf(sc[4 * nt + e], scale2, -lse2[r]))
                                    : 0.f;
                sc[4 * nt + e] = p * (dp[4 * nt + e] - dlt[r]);
            }
        }
        uint32_t da[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a(da[kc], sc, kc);
        ring_slice_mma(dq, da, ring, load);  // dq += ds K_slice
    }
    cp_async_wait_all();
    store_slice(a.dq + off, dq, row_lo, n, d, c0, a.scale, t4);
}

// ---------------------------------------------------------------------------
// K9 native wide: the head-layout backward at D = 192 and 256
// ---------------------------------------------------------------------------

// The function of K9 at D = 192 and 256, on rows of any width d in (128,
// 256] (d % 8 == 0) read and written in place: the tensor maps' rows are d
// wide (TMA fills the columns at or past d with zeros), the epilogues store
// columns < d, delta sums over d (d in (256, 512] takes the pair kernels
// below, d > 512 the slice mode above). Three
// launches, no atomics: delta (`flash_bwd_wide_delta_kernel`), dk/dv and dq,
// each product of the two kernels computed once over the whole width. The
// copies are TMA copies through stages with "full" / "empty" mbarriers, as
// K7's native kernel makes them: a warpgroup waits once a tile.
//  - dk/dv: a block 64 keys, K and V resident; each q tile (q and dO) streams
//    in once through BWN_DKV_STAGES stages. dk and dv [64][D] f32 together
//    pass a thread's registers, so two warpgroups split them: A computes
//    s^T = K q^T, p^T and dv += p^T dO; B computes dp^T = V dO^T, takes A's
//    p^T (f32, in the accumulator layout) through shared memory under two
//    named barriers, forms ds^T and dk += ds^T q, and refills the stage
//    once both are done with it (its thread 0: no producer warp, since
//    beside two warpgroups one makes a 288-thread block, which ptxas caps
//    at 168 registers a thread: dk and dv spilled). Each thread reads its
//    16 q columns' lse (A) or delta (B) from global memory while its first
//    product runs.
//  - dq: a block 64 q rows, q and dO resident; each key tile (K, V) streams
//    in once through BWN_DQ_STAGES stages, copied by a producer warp as
//    K7's; one warpgroup computes s = q K^T, dp = dO V^T and dq += ds K.
// One block an SM (~210 / ~193 KB of shared memory at D = 256).
#define BWN_TILE(D) ((D) / 64 * WG_TILE)
#define BWN_DKV_STAGES(D) ((D) == 256 ? 2 : 3)
#define BWN_DQ_STAGES(D) ((D) == 256 ? 2 : 3)
#define BWN_DKV_NT 256              // warpgroups A and B
#define BWN_DQ_NT 160               // the consumer warpgroup, then the producer warp
#define BWN_P_BYTES (128 * 32 * 4)  // p^T from warpgroup A to B: 32 f32 a thread
#define BWN_P_FULL 1                // named barriers of the p^T hand-over
#define BWN_P_FREE 2
// dk/dv: K, V, the stages of (q, dO), p^T, the barriers (K / V, then full
// and empty a stage); dq: q, dO, the stages of (K, V), the barriers
#define BWN_DKV_SMEM(D)                                                  \
    (1024 + BWN_TILE(D) * (2 + 2 * BWN_DKV_STAGES(D)) + BWN_P_BYTES + \
     8 * (1 + 2 * BWN_DKV_STAGES(D)))
#define BWN_DQ_SMEM(D) \
    (1024 + BWN_TILE(D) * (2 + 2 * BWN_DQ_STAGES(D)) + 8 * (1 + 2 * BWN_DQ_STAGES(D)))

struct BwdNativeArgs {
    CUtensorMap q, k, v, dout;  // [b * h][n][d] bf16 (`head_tensor_map`), roped q and k
    const int* lengths;
    const float *lse, *delta;
    bf16 *dq, *dk, *dv;         // [b, h, n, d]
    int n, heads, d;            // d <= D, a multiple of 8: the rows' width in place
    float scale;
};

template <int D>
__global__ void __launch_bounds__(BWN_DKV_NT, 1)
    flash_bwd_native_dkdv_kernel(const __grid_constant__ BwdNativeArgs a) {
    constexpr int TILE = BWN_TILE(D), STAGES = BWN_DKV_STAGES(D), NA = D / 2;
    const int n = a.n;
    const int k0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
    const int bh = b * a.heads + h;
    const int len = min(max(a.lengths[b], 0), n);
    // the q tiles up to the length (those past it are dead by K7's lse); a
    // key block wholly past the length walks none: its dk and dv are zeros
    const int n_qt = k0 < len ? (len + 63) / 64 : 0;
    uint8_t* smem = align1024(bw_smem);
    const uint32_t sK = smem_u32(smem), sV = sK + TILE, sStage = sV + TILE;
    float* sP = reinterpret_cast<float*>(smem + (2 + 2 * STAGES) * TILE);
    const uint32_t bKV = smem_u32(sP) + BWN_P_BYTES, bFull = bKV + 8, bEmpty = bFull + 8 * STAGES;
    init_stage_bars<STAGES>(bKV, 256);  // both warpgroups read every stage
    // warpgroup 0 (A): s^T, p^T, dv; warpgroup 1 (B): dp^T, ds^T, dk. The two
    // accumulators of a thread hold the same (key, query) entries.
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);  // uniform to ptxas
    const int tid = threadIdx.x & 127;
    const int g = (tid & 31) >> 2, t4 = tid & 3;
    auto load_q = [&](int qt, int s) {
        mbar_expect_tx(bFull + 8 * s, 2 * TILE);
        tma_rows<D>(sStage + 2 * s * TILE, &a.q, qt * 64, bh, bFull + 8 * s);
        tma_rows<D>(sStage + (2 * s + 1) * TILE, &a.dout, qt * 64, bh, bFull + 8 * s);
    };
    if (threadIdx.x == 0 && n_qt > 0) {
        mbar_expect_tx(bKV, 2 * TILE);
        tma_rows<D>(sK, &a.k, k0, bh, bKV);
        tma_rows<D>(sV, &a.v, k0, bh, bKV);
        for (int qt = 0; qt < STAGES && qt < n_qt; ++qt) load_q(qt, qt);
    }

    const int key_lo = k0 + (tid >> 5) * 16 + g;  // this thread's rows are keys
    const bool key_live[2] = {key_lo < len, key_lo + 8 < len};
    const float scale2 = a.scale * BW_LOG2E;  // p = 2^(s * scale * log2(e) - lse * log2(e))
    const uint32_t aS = wg == 0 ? sK : sV;     // A of the scores product
    // A reads the q rows' lse, B their delta; a row past n is dead (lse
    // -1e30) and adds nothing
    const float* rowv = (wg == 0 ? a.lse : a.delta) + (size_t)bh * n;
    const float past_n = wg == 0 ? -1e30f : 0.f;
    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;
    if (n_qt > 0) {
        mbar_wait(bKV, 0);
        if (wg == 1) bar_arrive(BWN_P_FREE, 256);  // p^T's buffer starts free
    }
    for (int qt = 0; qt < n_qt; ++qt) {
        const int s = qt % STAGES, parity = (qt / STAGES) & 1, q0 = qt * 64;
        mbar_wait(bFull + 8 * s, parity);
        const uint32_t sQ = sStage + 2 * s * TILE, sO = sQ + TILE;
        float t[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // A: s^T = K q^T; B: dp^T = V dO^T
            wgmma_ss<0>(t, sw128_desc(kslice(aS, kk)), sw128_desc(kslice(wg == 0 ? sQ : sO, kk)),
                        kk);
        wg_commit();
        float rv[16];  // at this thread's q columns (i >> 1) * 8 + t4 * 2 + (i & 1)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int row = q0 + (i >> 1) * 8 + t4 * 2 + (i & 1);
            rv[i] = row < n ? rowv[row] : past_n;
        }
        wg_wait0();
        fence_regs(t);
        if (wg == 0) {
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const float l = rv[(i >> 2) * 2 + (i & 1)];
                t[i] = key_live[(i >> 1) & 1] && l > BW_DEAD
                           ? exp2f(fmaf(t[i], scale2, -l * BW_LOG2E))
                           : 0.f;
            }
            bar_sync(BWN_P_FREE, 256);
#pragma unroll
            for (int i = 0; i < 32; ++i) sP[i * 128 + tid] = t[i];
            bar_arrive(BWN_P_FULL, 256);
        } else {
            bar_sync(BWN_P_FULL, 256);
#pragma unroll
            for (int i = 0; i < 32; ++i)
                t[i] = sP[i * 128 + tid] * (t[i] - rv[(i >> 2) * 2 + (i & 1)]);
            if (qt + 1 < n_qt) bar_arrive(BWN_P_FREE, 256);
        }
        uint32_t fa[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a(fa[kc], t, kc);
        const uint32_t bM = wg == 0 ? sO : sQ;  // A: dv += p^T dO; B: dk += ds^T q
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(acc, fa[kc], mn_desc<D>(bM + kc * 2048), 1);
        wg_commit();
        wg_wait0();
        fence_regs(acc);
        mbar_arrive(bEmpty + 8 * s);
        if (wg == 1 && tid == 0 && qt + STAGES < n_qt) {  // B, the later reader, refills
            mbar_wait(bEmpty + 8 * s, parity);
            load_q(qt + STAGES, s);
        }
    }
    bf16* dst = (wg == 0 ? a.dv : a.dk) + (size_t)bh * n * a.d;
    const float sc = wg == 0 ? 1.f : a.scale;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = key_lo + r * 8;
        if (row < n) store_acc_row(dst + (size_t)row * a.d + t4 * 2, acc, r, sc, a.d);
    }
}

template <int D>
__global__ void __launch_bounds__(BWN_DQ_NT, 1)
    flash_bwd_native_dq_kernel(const __grid_constant__ BwdNativeArgs a) {
    constexpr int TILE = BWN_TILE(D), STAGES = BWN_DQ_STAGES(D), NA = D / 2;
    const int n = a.n;
    const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
    const int bh = b * a.heads + h;
    const int len = min(max(a.lengths[b], 0), n);
    // a q tile wholly past the length (K7 wrote its lse dead) walks no key
    // tile: its dq is written as zeros
    const int n_kt = q0 < len ? (len + 63) / 64 : 0;
    uint8_t* smem = align1024(bw_smem);
    const uint32_t sQ = smem_u32(smem), sO = sQ + TILE, sStage = sO + TILE;
    const uint32_t bQO = sStage + 2 * STAGES * TILE, bFull = bQO + 8, bEmpty = bFull + 8 * STAGES;
    init_stage_bars<STAGES>(bQO, 128);
    const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);  // uniform to ptxas
    if (warp == 4) {  // the producer
        if ((threadIdx.x & 31) == 0 && n_kt > 0) {
            mbar_expect_tx(bQO, 2 * TILE);
            tma_rows<D>(sQ, &a.q, q0, bh, bQO);
            tma_rows<D>(sO, &a.dout, q0, bh, bQO);
            for (int kt = 0; kt < n_kt; ++kt) {
                const int s = kt % STAGES, use = kt / STAGES;
                if (use) mbar_wait(bEmpty + 8 * s, (use - 1) & 1);
                mbar_expect_tx(bFull + 8 * s, 2 * TILE);
                tma_rows<D>(sStage + 2 * s * TILE, &a.k, kt * 64, bh, bFull + 8 * s);
                tma_rows<D>(sStage + (2 * s + 1) * TILE, &a.v, kt * 64, bh, bFull + 8 * s);
            }
        }
        return;
    }
    const int tid = threadIdx.x, g = (tid & 31) >> 2, t4 = tid & 3;
    const int row_lo = q0 + warp * 16 + g;  // this thread's rows are queries
    const float scale2 = a.scale * BW_LOG2E;
    float lse2[2], dlt[2];
    bool row_live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_lo + r * 8;
        const float l = row < n ? a.lse[(size_t)bh * n + row] : 0.f;
        row_live[r] = row < n && l > BW_DEAD;
        lse2[r] = row_live[r] ? l * BW_LOG2E : 0.f;
        dlt[r] = row_live[r] ? a.delta[(size_t)bh * n + row] : 0.f;
    }
    float dq[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dq[i] = 0.f;
    if (n_kt > 0) mbar_wait(bQO, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(bFull + 8 * s, (kt / STAGES) & 1);
        const uint32_t sK = sStage + 2 * s * TILE, sV = sK + TILE;
        float sc[32], dp[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // s = q K^T: 64 queries x 64 keys
            wgmma_ss<0>(sc, sw128_desc(kslice(sQ, kk)), sw128_desc(kslice(sK, kk)), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // dp = dO V^T
            wgmma_ss<0>(dp, sw128_desc(kslice(sO, kk)), sw128_desc(kslice(sV, kk)), kk);
        wg_commit();
        wg_wait0();
        fence_regs(sc);
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int key = kt * 64 + (i >> 2) * 8 + t4 * 2 + (i & 1);
            const int r = (i >> 1) & 1;
            const float p =
                (key < len && row_live[r]) ? exp2f(fmaf(sc[i], scale2, -lse2[r])) : 0.f;
            sc[i] = p * (dp[i] - dlt[r]);
        }
        uint32_t da[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a(da[kc], sc, kc);
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)  // dq += ds K (K N-major: 16 keys a step)
            wgmma_rs<1>(dq, da[kc], mn_desc<D>(sK + kc * 2048), 1);
        wg_commit();
        wg_wait0();
        fence_regs(dq);
        mbar_arrive(bEmpty + 8 * s);
    }
    bf16* dst = a.dq + (size_t)bh * n * a.d;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_lo + r * 8;
        if (row < n) store_acc_row(dst + (size_t)row * a.d + t4 * 2, dq, r, a.scale, a.d);
    }
}

// ---------------------------------------------------------------------------
// K9 pair: the head-layout backward at D = 384 and 512, the width over a
// cluster of two blocks
// ---------------------------------------------------------------------------

// The function of K9 at D = 384 and 512 as clusters of two blocks, block r
// owning column half r of the gradients and half r of every contraction;
// each block copies only its halves (TMA boxes from column r D / 2), and
// the two hand their partial scores to each other (`send_partial`:
// `st.async` into the other block's shared memory, counted on its barrier;
// `recv_partial`), so each score is computed once: the tensor work is the
// function's. Three launches, no atomics: delta, dk/dv, dq.
//  - dk/dv: a cluster a 64-key block. Warpgroup A holds dv[:, r] (128 f32
//    registers a thread at D = 512) and computes the partial s^T = K[:, r]
//    q[:, r]^T; B holds dk[:, r] and computes the partial dp^T = V[:, r]
//    dO[:, r]^T; each trades its partial with the same warpgroup of the
//    other block and forms the whole product; A hands p^T to B in shared
//    memory (two named barriers), A adds p^T dO[:, r] to dv, B ds^T q[:, r]
//    to dk. K and V halves resident (64 KB at D = 512); 32-row q tiles (q
//    and dO halves, 32 KB) through BWP_DKV_STAGES stages (three at D = 512,
//    four at 384), refilled by B's thread 0 once both warpgroups are done.
//  - dq: a cluster 64 q rows, q and dO halves resident; 32-key steps of K
//    and V halves through BWP_DQ_STAGES stages fed by a producer warp; one
//    consumer warpgroup computes the partial s and dp, trades both, forms
//    ds and adds ds K[:, r] to dq[:, r] (128 registers at D = 512).
// Each partial goes through two buffers by the step's parity: a block writes
// the other's buffer of a parity again only after that block's next partial
// has reached it, which it sends after reading that buffer.
// At D = 512: dk/dv 197 registers a thread, ~201 KB of shared memory; dq 194
// and ~225 KB; one block an SM, two a cluster. Measured in turns
// (`kernel_ab.py`, PERF.md §6) against two warpgroups of one block
// splitting the width (dk/dv a block per (64 keys, column half) computing
// s^T and dp^T in both, 1.5x the function's tensor work, one q stage at D
// = 512; dq the split as here inside one block, the partials traded in its
// shared memory): 1.39x faster at [2, 2, 1024, 512], 1.19x at 4224. That
// block's dq beside this dk/dv was 7% faster than this dq at [2, 2, 4224,
// 512] (a full card) and 18% slower at [2, 2, 1024, 512]; one design is
// kept for the three kernels.
#define BWP_QR 32                                 // dk/dv: q rows a step; dq: keys a step
#define BWP_HT(D) ((D) / 128)                     // 64-column sub-tiles of a half
#define BWP_RES(D) (BWP_HT(D) * WG_TILE)          // a [64][D / 2] half tile
#define BWP_STEP(D) (BWP_HT(D) * WG_SUB32)        // a [32][D / 2] half tile
#define BWP_PART (128 * 16 * 4)                   // a partial of a step: 16 f32 a thread
#define BWP_DKV_NT 256                            // warpgroups A and B
#define BWP_DKV_STAGES(D) ((D) == 512 ? 3 : 4)
#define BWP_DQ_NT 160                             // the consumer warpgroup, then the producer warp
#define BWP_DQ_STAGES 4
#define BWP_P_BYTES (128 * 16 * 4)  // dk/dv: p^T from A to B, 16 f32 a thread
#define BWP_P_FULL 1                // dk/dv: the named barriers of the p^T hand-over
#define BWP_P_FREE 2
// dk/dv: K, V, the stages of (q, dO), p^T, the partials (two parities x A's,
// B's), the barriers (K / V, full and empty a stage, a partial's)
#define BWP_DKV_SMEM(D)                                                             \
    (1024 + 2 * BWP_RES(D) + 2 * BWP_DKV_STAGES(D) * BWP_STEP(D) + BWP_P_BYTES + \
     4 * BWP_PART + 8 * (1 + 2 * BWP_DKV_STAGES(D) + 4))
// dq: q, dO, the stages of (K, V), the partials (two parities x s and dp),
// the barriers (q / dO, full and empty a stage, a partial's a parity)
#define BWP_DQ_SMEM(D)                                                           \
    (1024 + 2 * BWP_RES(D) + 2 * BWP_DQ_STAGES * BWP_STEP(D) + 4 * BWP_PART + \
     8 * (1 + 2 * BWP_DQ_STAGES + 2))

struct BwdPairArgs {
    CUtensorMap q, k, v, dout;  // [b * h][n][d] bf16, roped q and k: the resident tiles'
                                // maps of 64-row boxes, the streamed ones' of 32-row boxes
    const int* lengths;
    const float *lse, *delta;
    bf16 *dq, *dk, *dv;         // [b, h, n, d]
    int n, heads, d;            // d <= D, a multiple of 8: the rows' width in place
    float scale;
};

template <int D>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(BWP_DKV_NT, 1)
    flash_bwd_pair_dkdv_kernel(const __grid_constant__ BwdPairArgs a) {
    constexpr int HALF = D / 2, HT = BWP_HT(D), RES = BWP_RES(D), STEP = BWP_STEP(D),
                  STAGES = BWP_DKV_STAGES(D), NA = HALF / 2;
    const int n = a.n;
    const int r = cluster_rank();  // this block's column half
    const int k0 = (blockIdx.x >> 1) * 64, h = blockIdx.y, b = blockIdx.z;
    const int bh = b * a.heads + h;
    const int len = min(max(a.lengths[b], 0), n);
    // the 32-row q tiles up to the length's 64-row tile (the rows past the
    // length inside it have a real lse; those of the tiles past it are dead
    // by K7's lse) and n; a key block wholly past the length walks none: its
    // dk and dv are zeros
    const int n_qt = k0 < len ? min(2 * ((len + 63) / 64), (n + 31) / 32) : 0;
    const int hbox = min(max((a.d - r * HALF + 63) / 64, 0), HT);  // this half's boxes < d
    uint8_t* smem = align1024(bw_smem);
    const uint32_t sK = smem_u32(smem), sV = sK + RES, sStage = sV + RES;
    float* sP = reinterpret_cast<float*>(smem + 2 * RES + 2 * STAGES * STEP);
    float* sX = sP + BWP_P_BYTES / 4;  // [parity][A, B] partials from the other block
    const uint32_t bKV = smem_u32(sX) + 4 * BWP_PART, bFull = bKV + 8,
                   bEmpty = bFull + 8 * STAGES, bX = bEmpty + 8 * STAGES;
    zero_subtiles<BWP_DKV_NT>(smem, 2, RES, hbox, HT, WG_TILE);
    zero_subtiles<BWP_DKV_NT>(smem + 2 * RES, 2 * STAGES, STEP, hbox, HT, WG_SUB32);
    if (threadIdx.x == 0) {
        mbar_init(bKV, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(bFull + 8 * s, 1);
            mbar_init(bEmpty + 8 * s, BWP_DKV_NT);  // both warpgroups read every stage
        }
        for (int i = 0; i < 4; ++i) mbar_init(bX + 8 * i, 1);
        mbar_init_fence();
    }
    cluster_sync();  // both blocks' barriers ready before any hand-over
    // warpgroup 0 (A): s^T, p^T, dv[:, r]; warpgroup 1 (B): dp^T, ds^T,
    // dk[:, r]. The two accumulators of a thread hold the same (key, query)
    // entries, and so do those of a thread and its peer in the other block.
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);  // uniform to ptxas
    const int tid = threadIdx.x & 127;
    const int g = (tid & 31) >> 2, t4 = tid & 3;
    auto load_q = [&](int qt, int s) {
        mbar_expect_tx(bFull + 8 * s, 2 * hbox * WG_SUB32);
        tma_boxes(sStage + 2 * s * STEP, &a.q, qt * BWP_QR, bh, bFull + 8 * s, hbox, WG_SUB32,
                  r * HALF);
        tma_boxes(sStage + (2 * s + 1) * STEP, &a.dout, qt * BWP_QR, bh, bFull + 8 * s, hbox,
                  WG_SUB32, r * HALF);
    };
    if (threadIdx.x == 0 && n_qt > 0) {
        mbar_expect_tx(bKV, 2 * hbox * WG_TILE);
        tma_boxes(sK, &a.k, k0, bh, bKV, hbox, WG_TILE, r * HALF);
        tma_boxes(sV, &a.v, k0, bh, bKV, hbox, WG_TILE, r * HALF);
        for (int qt = 0; qt < STAGES && qt < n_qt; ++qt) load_q(qt, qt);
    }

    const int key_lo = k0 + (tid >> 5) * 16 + g;  // this thread's rows are keys
    const bool key_live[2] = {key_lo < len, key_lo + 8 < len};
    const float scale2 = a.scale * BW_LOG2E;  // p = 2^(s * scale * log2(e) - lse * log2(e))
    const uint32_t aS = wg == 0 ? sK : sV;     // A of the scores product
    // A reads the q rows' lse, B their delta; a row past n is dead (lse
    // -1e30) and adds nothing
    const float* rowv = (wg == 0 ? a.lse : a.delta) + (size_t)bh * n;
    const float past_n = wg == 0 ? -1e30f : 0.f;
    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;
    if (n_qt > 0) {
        mbar_wait(bKV, 0);
        if (wg == 1) bar_arrive(BWP_P_FREE, BWP_DKV_NT);  // p^T's buffer starts free
    }
    for (int qt = 0; qt < n_qt; ++qt) {
        const int s = qt % STAGES, parity = (qt / STAGES) & 1, q0 = qt * BWP_QR;
        const int xi = (qt & 1) * 2 + wg;  // this warpgroup's partial buffer of the step
        mbar_wait(bFull + 8 * s, parity);
        const uint32_t sQ = sStage + 2 * s * STEP, sO = sQ + STEP;
        float t[16];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < HALF / 16; ++kk)  // A: s^T = K q^T; B: dp^T = V dO^T, half r
            wgmma_ss<0>(t, sw128_desc(kslice(aS, kk)),
                        sw128_desc(kslice(wg == 0 ? sQ : sO, kk, WG_SUB32)), kk);
        wg_commit();
        float rv[8];  // at this thread's q columns (i >> 1) * 8 + t4 * 2 + (i & 1)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int row = q0 + (i >> 1) * 8 + t4 * 2 + (i & 1);
            rv[i] = row < n ? rowv[row] : past_n;
        }
        wg_wait0();
        fence_regs(t);
        if (tid == 0) mbar_expect_tx(bX + 8 * xi, BWP_PART);  // the other's partial
        send_partial(t, smem_u32(sX) + xi * BWP_PART, bX + 8 * xi, r ^ 1, tid);
        recv_partial(t, sX + xi * (BWP_PART / 4), bX + 8 * xi, (qt >> 1) & 1, tid);
        if (wg == 0) {
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                const float l = rv[(i >> 2) * 2 + (i & 1)];
                t[i] = key_live[(i >> 1) & 1] && l > BW_DEAD
                           ? exp2f(fmaf(t[i], scale2, -l * BW_LOG2E))
                           : 0.f;
            }
            bar_sync(BWP_P_FREE, BWP_DKV_NT);
#pragma unroll
            for (int i = 0; i < 16; ++i) sP[i * 128 + tid] = t[i];
            bar_arrive(BWP_P_FULL, BWP_DKV_NT);
        } else {
            bar_sync(BWP_P_FULL, BWP_DKV_NT);
#pragma unroll
            for (int i = 0; i < 16; ++i)
                t[i] = sP[i * 128 + tid] * (t[i] - rv[(i >> 2) * 2 + (i & 1)]);
            if (qt + 1 < n_qt) bar_arrive(BWP_P_FREE, BWP_DKV_NT);
        }
        uint32_t fa[2][4];
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) acc_to_a(fa[kc], t, kc);
        const uint32_t bM = wg == 0 ? sO : sQ;  // A: dv += p^T dO[:, r]; B: dk += ds^T q[:, r]
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < 2; ++kc)
            wgmma_rs<1>(acc, fa[kc], mn_desc_lbo(bM + kc * 2048, WG_SUB32), 1);
        wg_commit();
        wg_wait0();
        fence_regs(acc);
        mbar_arrive(bEmpty + 8 * s);
        if (wg == 1 && tid == 0 && qt + STAGES < n_qt) {  // B, the later reader, refills
            mbar_wait(bEmpty + 8 * s, parity);
            load_q(qt + STAGES, s);
        }
    }
    bf16* dst = (wg == 0 ? a.dv : a.dk) + (size_t)bh * n * a.d + r * HALF;
    const float sc = wg == 0 ? 1.f : a.scale;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = key_lo + i * 8;
        if (row < n) store_acc_row(dst + (size_t)row * a.d + t4 * 2, acc, i, sc, a.d - r * HALF);
    }
    cluster_sync();  // no block leaves while the other may still hand it a partial
}

template <int D>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(BWP_DQ_NT, 1)
    flash_bwd_pair_dq_kernel(const __grid_constant__ BwdPairArgs a) {
    constexpr int HALF = D / 2, HT = BWP_HT(D), RES = BWP_RES(D), STEP = BWP_STEP(D),
                  STAGES = BWP_DQ_STAGES, NA = HALF / 2;
    const int n = a.n;
    const int r = cluster_rank();  // this block's column half
    const int q0 = (blockIdx.x >> 1) * 64, h = blockIdx.y, b = blockIdx.z;
    const int bh = b * a.heads + h;
    const int len = min(max(a.lengths[b], 0), n);
    // a q tile wholly past the length (K7 wrote its lse dead) walks no key
    // step: its dq is written as zeros; keys >= len add nothing
    const int n_kt = q0 < len ? (len + BWP_QR - 1) / BWP_QR : 0;
    const int hbox = min(max((a.d - r * HALF + 63) / 64, 0), HT);  // this half's boxes < d
    uint8_t* smem = align1024(bw_smem);
    const uint32_t sQ = smem_u32(smem), sO = sQ + RES, sStage = sO + RES;
    float* sX = reinterpret_cast<float*>(smem + 2 * RES + 2 * STAGES * STEP);  // [parity][s, dp]
    const uint32_t bQO = smem_u32(sX) + 4 * BWP_PART, bFull = bQO + 8,
                   bEmpty = bFull + 8 * STAGES, bX = bEmpty + 8 * STAGES;
    zero_subtiles<BWP_DQ_NT>(smem, 2, RES, hbox, HT, WG_TILE);
    zero_subtiles<BWP_DQ_NT>(smem + 2 * RES, 2 * STAGES, STEP, hbox, HT, WG_SUB32);
    if (threadIdx.x == 0) {
        mbar_init(bQO, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(bFull + 8 * s, 1);
            mbar_init(bEmpty + 8 * s, 128);
        }
        mbar_init(bX, 1);
        mbar_init(bX + 8, 1);
        mbar_init_fence();
    }
    cluster_sync();  // both blocks' barriers ready before any hand-over
    // warp-uniform to ptxas: wgmma under a role branch it cannot prove
    // uniform would be serialised (note C7520)
    const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
    if (warp == 4) {  // the producer
        if ((threadIdx.x & 31) == 0 && n_kt > 0) {
            mbar_expect_tx(bQO, 2 * hbox * WG_TILE);
            tma_boxes(sQ, &a.q, q0, bh, bQO, hbox, WG_TILE, r * HALF);
            tma_boxes(sO, &a.dout, q0, bh, bQO, hbox, WG_TILE, r * HALF);
            for (int kt = 0; kt < n_kt; ++kt) {
                const int s = kt % STAGES, use = kt / STAGES;
                if (use) mbar_wait(bEmpty + 8 * s, (use - 1) & 1);
                mbar_expect_tx(bFull + 8 * s, 2 * hbox * WG_SUB32);
                tma_boxes(sStage + 2 * s * STEP, &a.k, kt * BWP_QR, bh, bFull + 8 * s, hbox,
                          WG_SUB32, r * HALF);
                tma_boxes(sStage + (2 * s + 1) * STEP, &a.v, kt * BWP_QR, bh, bFull + 8 * s,
                          hbox, WG_SUB32, r * HALF);
            }
        }
        cluster_sync();  // no block leaves while the other may still hand it a partial
        return;
    }
    const int tid = threadIdx.x, g = (tid & 31) >> 2, t4 = tid & 3;
    const int row_lo = q0 + warp * 16 + g;  // this thread's rows are queries
    const float scale2 = a.scale * BW_LOG2E;
    float lse2[2], dlt[2];
    bool row_live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = row_lo + i * 8;
        const float l = row < n ? a.lse[(size_t)bh * n + row] : 0.f;
        row_live[i] = row < n && l > BW_DEAD;
        lse2[i] = row_live[i] ? l * BW_LOG2E : 0.f;
        dlt[i] = row_live[i] ? a.delta[(size_t)bh * n + row] : 0.f;
    }
    float dq[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dq[i] = 0.f;
    if (n_kt > 0) mbar_wait(bQO, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES, xp = kt & 1;
        mbar_wait(bFull + 8 * s, (kt / STAGES) & 1);
        const uint32_t sK = sStage + 2 * s * STEP, sV = sK + STEP;
        float sd[32];  // the partial s (16), then dp (16)
        float(&sc)[16] = *reinterpret_cast<float(*)[16]>(sd);
        float(&dp)[16] = *reinterpret_cast<float(*)[16]>(sd + 16);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < HALF / 16; ++kk)  // s = q K^T, half r
            wgmma_ss<0>(sc, sw128_desc(kslice(sQ, kk)), sw128_desc(kslice(sK, kk, WG_SUB32)),
                        kk);
#pragma unroll
        for (int kk = 0; kk < HALF / 16; ++kk)  // dp = dO V^T, half r
            wgmma_ss<0>(dp, sw128_desc(kslice(sO, kk)), sw128_desc(kslice(sV, kk, WG_SUB32)),
                        kk);
        wg_commit();
        wg_wait0();
        fence_regs(sd);
        if (tid == 0) mbar_expect_tx(bX + 8 * xp, 2 * BWP_PART);  // the other's partials
        send_partial(sd, smem_u32(sX) + xp * 2 * BWP_PART, bX + 8 * xp, r ^ 1, tid);
        recv_partial(sd, sX + xp * (BWP_PART / 2), bX + 8 * xp, (kt >> 1) & 1, tid);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int key = kt * BWP_QR + (i >> 2) * 8 + t4 * 2 + (i & 1);
            const int ri = (i >> 1) & 1;
            const float p =
                (key < len && row_live[ri]) ? exp2f(fmaf(sc[i], scale2, -lse2[ri])) : 0.f;
            sc[i] = p * (dp[i] - dlt[ri]);
        }
        uint32_t da[2][4];
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) acc_to_a(da[kc], sc, kc);
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < 2; ++kc)  // dq[:, r] += ds K[:, r] (K N-major: 16 keys a step)
            wgmma_rs<1>(dq, da[kc], mn_desc_lbo(sK + kc * 2048, WG_SUB32), 1);
        wg_commit();
        wg_wait0();
        fence_regs(dq);
        mbar_arrive(bEmpty + 8 * s);
    }
    bf16* dst = a.dq + (size_t)bh * n * a.d + r * HALF;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = row_lo + i * 8;
        if (row < n)
            store_acc_row(dst + (size_t)row * a.d + t4 * 2, dq, i, a.scale, a.d - r * HALF);
    }
    cluster_sync();
}

// ---------------------------------------------------------------------------
// Launch: prologue, dk/dv, dq on the caller's stream
// ---------------------------------------------------------------------------

typedef void (*bwd_kernel_t)(const BwdArgs);

// The three kernels of a mode at the head width d (null at any other).
struct BwdKernels {
    bwd_kernel_t prologue, dkdv, dq;
};
#define BW_PICK(d, pro, dkdv, dq)                                             \
    ((d) == 64    ? BwdKernels{pro<64>, dkdv<64>, dq<64>}                    \
     : (d) == 128 ? BwdKernels{pro<128>, dkdv<128>, dq<128>}                 \
                  : BwdKernels{nullptr, nullptr, nullptr})

static int launch_bwd(BwdKernels k, bool bias, const BwdArgs& a, int d, void* stream) {
    if (!k.prologue) return (int)cudaErrorInvalidValue;  // a head width of neither instantiation
    if (a.bsz <= 0 || a.n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    const size_t threads = (size_t)a.bsz * a.n * a.heads * (d / 8);
    k.prologue<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int dkv_smem = 1024 + DKV_FIXED(d);
    const int dq_smem = 1024 + DQ_FIXED(d) + (bias ? (a.n + 63) / 64 * 8 : 0);
    if (dq_smem > BW_SMEM_MAX || dkv_smem > BW_SMEM_MAX) return (int)cudaErrorInvalidValue;
    err = smem_limit_once((const void*)k.dkdv, BW_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    err = smem_limit_once((const void*)k.dq, BW_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.n + 64 * BW_WG - 1) / (64 * BW_WG), a.heads, a.bsz);
    k.dkdv<<<grid, BW_NT, dkv_smem, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    k.dq<<<grid, BW_NT, dq_smem, s>>>(a);
    return (int)cudaGetLastError();
}

static BwdArgs flat_args(const void* qkv, const void* cos_t, const void* sin_t, const void* mask,
                         bool bias, const void* out, const void* lse, const void* dout,
                         void* dqkv, void* k_rot, void* delta, int b, int n, int heads,
                         float scale) {
    BwdArgs a = {};
    a.qkv = (const bf16*)qkv;
    a.cos_t = (const bf16*)cos_t;
    a.sin_t = (const bf16*)sin_t;
    if (bias) a.kmask = (const uint8_t*)mask;
    else a.lengths = (const int*)mask;
    a.out = (const bf16*)out;
    a.dout = (const bf16*)dout;
    a.lse = (const float*)lse;
    a.krot = (bf16*)k_rot;
    a.delta = (float*)delta;
    a.dqkv = (bf16*)dqkv;
    a.bsz = b;
    a.n = n;
    a.heads = heads;
    a.scale = scale;
    return a;
}

extern "C" int f5_fused_qkv_rope_attn_bwd_bf16(const void* qkv, const void* cos_t,
                                               const void* sin_t, const void* lengths,
                                               const void* out, const void* lse,
                                               const void* dout, void* dqkv, void* k_rot,
                                               void* delta, int b, int n, int heads,
                                               int head_dim, float scale, void* stream) {
    return launch_bwd(
        BW_PICK(head_dim, attn_bwd_prologue_kernel, attn_bwd_dkdv_kernel, attn_bwd_dq_kernel),
        false,
        flat_args(qkv, cos_t, sin_t, lengths, false, out, lse, dout, dqkv, k_rot, delta, b, n,
                  heads, scale),
        head_dim, stream);
}

extern "C" int f5_fused_qkv_rope_attn_bias_bwd_bf16(const void* qkv, const void* cos_t,
                                                    const void* sin_t, const void* kmask,
                                                    const void* out, const void* lse,
                                                    const void* dout, void* dqkv, void* k_rot,
                                                    void* delta, int b, int n, int heads,
                                                    int head_dim, float scale, void* stream) {
    return launch_bwd(BW_PICK(head_dim, attn_bias_bwd_prologue_kernel, attn_bias_bwd_dkdv_kernel,
                              attn_bias_bwd_dq_kernel),
                      true,
                      flat_args(qkv, cos_t, sin_t, kmask, true, out, lse, dout, dqkv, k_rot,
                                delta, b, n, heads, scale),
                      head_dim, stream);
}

// K9's slice mode: delta, dk/dv, dq; a block a (64 rows, head x slice, batch).
static int launch_bwd_wide(const void* q, const void* k, const void* v, const void* lengths,
                           const void* o, const void* lse, const void* dout, void* dq, void* dk,
                           void* dv, void* delta, int b, int n, int heads, int d, float scale,
                           void* stream) {
    if (d <= 128 || d % 8) return (int)cudaErrorInvalidValue;
    if (b <= 0 || n <= 0) return (int)cudaGetLastError();
    const BwdWideArgs a = {(const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths,
                           (const bf16*)o, (const bf16*)dout, (const float*)lse, (float*)delta,
                           (bf16*)dq, (bf16*)dk, (bf16*)dv, b, n, heads, d, scale};
    cudaStream_t s = (cudaStream_t)stream;
    const long long rows = (long long)b * heads * n;
    flash_bwd_wide_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = smem_limit_once((const void*)flash_bwd_wide_dkdv_kernel, BW_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    err = smem_limit_once((const void*)flash_bwd_wide_dq_kernel, BW_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n + 63) / 64, heads * ((d + BWW_SLICE - 1) / BWW_SLICE), b);
    flash_bwd_wide_dkdv_kernel<<<grid, BWW_NT, BWW_SMEM, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_wide_dq_kernel<<<grid, BWW_NT, BWW_SMEM, s>>>(a);
    return (int)cudaGetLastError();
}

// K9's native wide kernels at D = 192 / 256 on rows of width d <= D: delta
// (the slice mode's kernel, over d), dk/dv, dq; a block a (64 rows, head,
// batch).
template <int D>
static int launch_bwd_native(const void* q, const void* k, const void* v, const void* lengths,
                             const void* o, const void* lse, const void* dout, void* dq,
                             void* dk, void* dv, void* delta, int b, int n, int heads, int d,
                             float scale, void* stream) {
    if (b <= 0 || n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    const BwdWideArgs w = {(const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths,
                           (const bf16*)o, (const bf16*)dout, (const float*)lse, (float*)delta,
                           (bf16*)dq, (bf16*)dk, (bf16*)dv, b, n, heads, d, scale};
    const long long rows = (long long)b * heads * n;
    flash_bwd_wide_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(w);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    BwdNativeArgs a;
    if ((err = head_tensor_map(&a.q, q, b * heads, n, d)) != cudaSuccess ||
        (err = head_tensor_map(&a.k, k, b * heads, n, d)) != cudaSuccess ||
        (err = head_tensor_map(&a.v, v, b * heads, n, d)) != cudaSuccess ||
        (err = head_tensor_map(&a.dout, dout, b * heads, n, d)) != cudaSuccess)
        return (int)err;
    a.lengths = (const int*)lengths;
    a.lse = (const float*)lse;
    a.delta = (const float*)delta;
    a.dq = (bf16*)dq;
    a.dk = (bf16*)dk;
    a.dv = (bf16*)dv;
    a.n = n;
    a.heads = heads;
    a.d = d;
    a.scale = scale;
    if ((err = smem_limit_once((const void*)flash_bwd_native_dkdv_kernel<D>, BW_SMEM_MAX)) !=
            cudaSuccess ||
        (err = smem_limit_once((const void*)flash_bwd_native_dq_kernel<D>, BW_SMEM_MAX)) !=
            cudaSuccess)
        return (int)err;
    dim3 grid((n + 63) / 64, heads, b);
    flash_bwd_native_dkdv_kernel<D><<<grid, BWN_DKV_NT, BWN_DKV_SMEM(D), s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_native_dq_kernel<D><<<grid, BWN_DQ_NT, BWN_DQ_SMEM(D), s>>>(a);
    return (int)cudaGetLastError();
}

// K9's pair kernels at D = 384 / 512 on rows of width d <= D: delta (the
// slice mode's kernel, over d), dk/dv (a cluster of two blocks a (64 keys,
// head, batch)), dq (a cluster a (64 q rows, head, batch)).
template <int D>
static int launch_bwd_pair(const void* q, const void* k, const void* v, const void* lengths,
                           const void* o, const void* lse, const void* dout, void* dq, void* dk,
                           void* dv, void* delta, int b, int n, int heads, int d, float scale,
                           void* stream) {
    if (b <= 0 || n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    const BwdWideArgs w = {(const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths,
                           (const bf16*)o, (const bf16*)dout, (const float*)lse, (float*)delta,
                           (bf16*)dq, (bf16*)dk, (bf16*)dv, b, n, heads, d, scale};
    const long long rows = (long long)b * heads * n;
    flash_bwd_wide_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(w);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // dk/dv: K and V resident (64-row boxes), q and dO streamed (32-row);
    // dq: q and dO resident, K and V streamed
    BwdPairArgs kv, qd;
    const int bh = b * heads;
    if ((err = head_tensor_map(&kv.k, k, bh, n, d)) != cudaSuccess ||
        (err = head_tensor_map(&kv.v, v, bh, n, d)) != cudaSuccess ||
        (err = head_tensor_map(&kv.q, q, bh, n, d, 32)) != cudaSuccess ||
        (err = head_tensor_map(&kv.dout, dout, bh, n, d, 32)) != cudaSuccess ||
        (err = head_tensor_map(&qd.q, q, bh, n, d)) != cudaSuccess ||
        (err = head_tensor_map(&qd.dout, dout, bh, n, d)) != cudaSuccess ||
        (err = head_tensor_map(&qd.k, k, bh, n, d, 32)) != cudaSuccess ||
        (err = head_tensor_map(&qd.v, v, bh, n, d, 32)) != cudaSuccess)
        return (int)err;
    BwdPairArgs* both[2] = {&kv, &qd};
    for (BwdPairArgs* a : both) {
        a->lengths = (const int*)lengths;
        a->lse = (const float*)lse;
        a->delta = (const float*)delta;
        a->dq = (bf16*)dq;
        a->dk = (bf16*)dk;
        a->dv = (bf16*)dv;
        a->n = n;
        a->heads = heads;
        a->d = d;
        a->scale = scale;
    }
    if ((err = smem_limit_once((const void*)flash_bwd_pair_dkdv_kernel<D>, BW_SMEM_MAX)) !=
            cudaSuccess ||
        (err = smem_limit_once((const void*)flash_bwd_pair_dq_kernel<D>, BW_SMEM_MAX)) !=
            cudaSuccess)
        return (int)err;
    const dim3 grid(2 * ((n + 63) / 64), heads, b);
    flash_bwd_pair_dkdv_kernel<D><<<grid, BWP_DKV_NT, BWP_DKV_SMEM(D), s>>>(kv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_pair_dq_kernel<D><<<grid, BWP_DQ_NT, BWP_DQ_SMEM(D), s>>>(qd);
    return (int)cudaGetLastError();
}

// K9 takes any head width d % 8 == 0 and reads and writes the rows of [b,
// h, n, d] in place: d <= 128 the core at D = 64 / 128, d in (128, 256] the
// native wide kernels at D = 192 / 256, d in (256, 512] the pair kernels at
// D = 384 / 512, d > 512 the slice mode; any other d returns
// cudaErrorInvalidValue.
extern "C" int f5_flash_attn_bwd_bf16(const void* q, const void* k, const void* v,
                                      const void* lengths, const void* o, const void* lse,
                                      const void* dout, void* dq, void* dk, void* dv,
                                      void* delta, int b, int n, int heads, int head_dim,
                                      float scale, void* stream) {
    const int d = head_dim, D = head_tile_width(d);
    if (D == 512 || D == 384)
        return (D == 512 ? launch_bwd_pair<512> : launch_bwd_pair<384>)(
            q, k, v, lengths, o, lse, dout, dq, dk, dv, delta, b, n, heads, d, scale, stream);
    if (D == 256 || D == 192)
        return (D == 256 ? launch_bwd_native<256> : launch_bwd_native<192>)(
            q, k, v, lengths, o, lse, dout, dq, dk, dv, delta, b, n, heads, d, scale, stream);
    if (D == 0) return launch_bwd_wide(q, k, v, lengths, o, lse, dout, dq, dk, dv, delta, b, n,
                                       heads, d, scale, stream);
    BwdArgs a = {};
    a.q = (const bf16*)q;
    a.k = (const bf16*)k;
    a.v = (const bf16*)v;
    a.lengths = (const int*)lengths;
    a.out = (const bf16*)o;
    a.dout = (const bf16*)dout;
    a.lse = (const float*)lse;
    a.delta = (float*)delta;
    a.dq = (bf16*)dq;
    a.dk = (bf16*)dk;
    a.dv = (bf16*)dv;
    a.bsz = b;
    a.n = n;
    a.heads = heads;
    a.d = d;
    a.scale = scale;
#define K9_PICK(D, N) \
    BwdKernels{flash_bwd_delta_kernel<D, N>, flash_bwd_dkdv_kernel<D, N>, flash_bwd_dq_kernel<D, N>}
    const bool narrow = d != D;
    const BwdKernels kern = D == 64 ? (narrow ? K9_PICK(64, true) : K9_PICK(64, false))
                                    : (narrow ? K9_PICK(128, true) : K9_PICK(128, false));
#undef K9_PICK
    return launch_bwd(kern, false, a, D, stream);
}
