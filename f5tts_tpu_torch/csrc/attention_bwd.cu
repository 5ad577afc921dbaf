// Attention backward kernels: K4 and its key-mask mode K8 (flat dQKV), and K9
// (head-layout dq/dk/dv from a saved row lse), three modes of one core.
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
// In:  q, k, v [b, h, n, 64] bf16 (already roped), lengths [b] int32, O (K7's
//      output) and dO [b, h, n, 64] bf16, lse [b, h, n] f32 (K7's lse mode).
// Out: dq, dk, dv [b, h, n, 64] bf16; scratch delta [b, h, n] f32.
// Function (the Pallas bodies'): a row is live where lse > -5e29 (K7 writes
// -1e30 on q tiles wholly past the length, so those tiles are skipped); a key
// is live where key < length; p = exp(s * scale - lse) on live pairs, else 0;
// delta = rowsum(dO * O) in f32 (in XLA in the JAX package, :424); ds = p *
// (dp - delta); p and ds are rounded to bf16 before dv = p^T dO, dk = ds^T q *
// scale, dq = ds k * scale. Rows past the length inside the last live q tile
// have a real lse (K7 computes them, as Pallas does) and their dO is used as
// given.
//
// Bound: tensor-core operations, 10*h*64*sum(live query x key pairs) flops (the
// 5 products of the function) against ~(3 + 2 + 3)*b*n*h*64*2 bytes. Design,
// three launches a backward, no atomics (deterministic):
//  - prologue, one thread per 8 lanes of a (row, head). Flat modes: q_rot into
//    dQKV's dq lanes (each dq block reads its own rows before it overwrites
//    them), k_rot into a head-layout scratch, delta; the main loops never rope
//    again. HEAD: delta only (q and k come roped).
//  - dk/dv kernel, one block per (64*BW_WG keys, head, batch): BW_WG
//    warpgroups of 64 keys each (one, by measurement), K and V resident in
//    128-byte-swizzled shared tiles. The q tiles (64 rows of q and dO, their
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
#define BW_MINB 3  // the blocks an SM must hold at once (__launch_bounds__)
#endif
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
    bf16* krot;                       // flat modes: k_rot scratch [b, h, n, 64]
    float* delta;                     // scratch [b, h, n]
    bf16* dqkv;                       // flat modes: the output
    bf16 *dq, *dk, *dv;               // HEAD: the outputs
    int bsz, n, heads;
    float scale;
};

// Row 0 of one (batch, head) of every operand, and their row strides
// (elements): the flat modes read q_rot from dQKV's dq lanes, k_rot from the
// scratch, v from qkv and dO flat; HEAD reads [b, h, n, 64] throughout.
template <int MODE>
struct BwdView {
    const bf16 *q, *k, *v, *dO;
    bf16 *dq, *dk, *dv;
    size_t qs, vs, os, gs;  // q / dq, v, dO, dk / dv (k's is 64)
    __device__ __forceinline__ BwdView(const BwdArgs& a, int b, int h) {
        const size_t bh = (size_t)b * a.heads + h, n = a.n;
        if constexpr (MODE == MODE_HEAD) {
            q = a.q + bh * n * 64;
            k = a.k + bh * n * 64;
            v = a.v + bh * n * 64;
            dO = a.dout + bh * n * 64;
            dq = a.dq + bh * n * 64;
            dk = a.dk + bh * n * 64;
            dv = a.dv + bh * n * 64;
            qs = vs = os = gs = 64;
        } else {
            const size_t hd = (size_t)a.heads * 64, row3 = 3 * hd;
            bf16* base = a.dqkv + b * n * row3 + h * 64;
            q = dq = base;
            dk = base + hd;
            dv = base + 2 * hd;
            k = a.krot + bh * n * 64;
            v = a.qkv + b * n * row3 + 2 * hd + h * 64;
            dO = a.dout + b * n * hd + h * 64;
            qs = vs = gs = row3;
            os = hd;
        }
    }
};

// Scale, optionally un-rope (rope with -sin), and store this thread's rows of a
// 64 x 64 accumulator (row0 = the row of d[0]) as bf16 lanes 0..63 of dst
// (dst at row 0, row stride `stride`; the rope tables' lanes are h*64..).
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

extern __shared__ __align__(16) uint8_t bw_smem[];

// Flat prologue: one thread per 8 lanes of a (row, head). q and k roped in f32
// and rounded to bf16, q into the dq lanes of dqkv, k into krot [b, h, n, 64];
// delta [b, h, n] = rowsum(dO * O) in f32, dO read as 0 on dead rows (K4: >=
// length).
template <bool BIAS>
__device__ __forceinline__ void flat_bwd_prologue(const BwdArgs& a) {
    const int n = a.n, heads = a.heads;
    const long long pair = (long long)blockIdx.x * 32 + (threadIdx.x >> 3);
    const int c = (threadIdx.x & 7) * 8;
    const int hd = heads * 64;
    const bool valid = pair < (long long)a.bsz * n * heads;
    const long long row = valid ? pair / heads : 0;  // b * n + i
    const int hh = (int)(pair - row * heads) * valid;
    const int bb = (int)(row / n), i = (int)(row - (long long)bb * n);
    float acc = 0.f;
    if (valid) {
        const int len = BIAS ? n : min(max(a.lengths[bb], 0), n);
        const bf16* src = a.qkv + row * 3 * hd + hh * 64 + c;
        float q[8], k[8], cs[8], sn[8];
        unpack8(*reinterpret_cast<const uint4*>(src), q);
        unpack8(*reinterpret_cast<const uint4*>(src + hd), k);
        unpack8(*reinterpret_cast<const uint4*>(a.cos_t + (size_t)i * hd + hh * 64 + c), cs);
        unpack8(*reinterpret_cast<const uint4*>(a.sin_t + (size_t)i * hd + hh * 64 + c), sn);
        rope8(q, cs, sn);
        rope8(k, cs, sn);
        *reinterpret_cast<uint4*>(a.dqkv + row * 3 * hd + hh * 64 + c) = pack8(q);
        *reinterpret_cast<uint4*>(a.krot + (((size_t)bb * heads + hh) * n + i) * 64 + c) = pack8(k);
        if (i < len) {
            float o[8], g[8];
            unpack8(*reinterpret_cast<const uint4*>(a.out + row * hd + hh * 64 + c), o);
            unpack8(*reinterpret_cast<const uint4*>(a.dout + row * hd + hh * 64 + c), g);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc += o[j] * g[j];
        }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    if (valid && c == 0) a.delta[((size_t)bb * heads + hh) * n + i] = acc;
}

// HEAD prologue: delta [b, h, n] = rowsum(dO * O) in f32 over every row, one
// thread per 8 lanes of a [b * h * n, 64] row.
__device__ __forceinline__ void head_bwd_prologue(const BwdArgs& a) {
    const long long row = (long long)blockIdx.x * 32 + (threadIdx.x >> 3);
    const int c = (threadIdx.x & 7) * 8;
    const bool valid = row < (long long)a.bsz * a.heads * a.n;
    float acc = 0.f;
    if (valid) {
        float o[8], g[8];
        unpack8(*reinterpret_cast<const uint4*>(a.out + row * 64 + c), o);
        unpack8(*reinterpret_cast<const uint4*>(a.dout + row * 64 + c), g);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc += o[j] * g[j];
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    if (valid && c == 0) a.delta[row] = acc;
}

// Shared-memory plan of the dk/dv kernel (every tile 1024-aligned): K and V
// tiles (BW_WG each), two stages of (q tile, dO tile), then the two
// stages' lse[64] and delta[64].
#define DKV_STAGE (2 * WG_TILE)
#define DKV_LD (2 * BW_WG * WG_TILE + 2 * DKV_STAGE)
#define DKV_FIXED (DKV_LD + 2 * 512)

template <int MODE>
__device__ __forceinline__ void bwd_dkdv(const BwdArgs& a) {
    constexpr bool BIAS = MODE == MODE_BIAS;
    const int n = a.n;
    const int k0 = blockIdx.x * 64 * BW_WG;
    const int h = blockIdx.y, b = blockIdx.z;
    const int hd = a.heads * 64;
    const int tid = threadIdx.x;
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t bh = (size_t)b * a.heads + h;
    const int len = BIAS ? n : min(max(a.lengths[b], 0), n);
    const uint8_t* km = BIAS ? a.kmask + (size_t)b * n : nullptr;
    const BwdView<MODE> t(a, b, h);

    bool dead;
    if constexpr (BIAS) {
        bool live = false;
        for (int j = tid; j < 64 * BW_WG; j += BW_NT) live |= k0 + j < n && km[k0 + j];
        dead = !__syncthreads_or(live);
    } else {
        dead = k0 >= len;
    }
    if (dead) {  // every key of the block is dead: dk = dv = 0
        zero_span<BW_NT>(t.dk, t.gs, k0, 64 * BW_WG, n, tid);
        zero_span<BW_NT>(t.dv, t.gs, k0, 64 * BW_WG, n, tid);
        return;
    }

    uint8_t* smem = align1024(bw_smem);
    const uint32_t sbase = smem_u32(smem);
    const uint32_t sK = sbase, sV = sbase + BW_WG * WG_TILE;
    const uint32_t sStage = sbase + 2 * BW_WG * WG_TILE;
    const uint32_t sLDs = sbase + DKV_LD;
    const float* sLD = reinterpret_cast<const float*>(smem + DKV_LD);

    // K4 reads dO, lse and delta as 0 past the length; K8 and K9 as they are
    const int row_lim = MODE == MODE_LEN ? len : n;
    const float* lseb = a.lse + bh * n;
    const float* deltab = a.delta + bh * n;
    for (int j = 0; j < BW_WG; ++j) {
        tile_async<BW_NT>(sK + j * WG_TILE, t.k, 64, k0 + 64 * j, n, tid);
        tile_async<BW_NT>(sV + j * WG_TILE, t.v, t.vs, k0 + 64 * j, n, tid);
    }
    auto load_stage = [&](int q0, int s) {
        const uint32_t st = sStage + s * DKV_STAGE;
        tile_async<BW_NT>(st, t.q, t.qs, q0, n, tid);
        tile_async<BW_NT>(st + WG_TILE, t.dO, t.os, q0, row_lim, tid);
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
    const uint32_t aK = sK + wg * WG_TILE, aV = sV + wg * WG_TILE;
    const float scale2 = a.scale * BW_LOG2E;  // p = 2^(s * scale * log2(e) - lse * log2(e))

    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    // K4 / K9: only the q tiles up to the length (K9's tiles past it are
    // dead by K7's lse); K8: all
    const int n_qt = (len + 63) / 64;
    load_stage(0, 0);
    for (int qt = 0; qt < n_qt; ++qt) {
        const int q0 = qt * 64, s = qt & 1;
        cp_async_wait_all();
        __syncthreads();  // stage s landed; every thread is done with stage s ^ 1
        if (qt + 1 < n_qt) load_stage(q0 + 64, s ^ 1);
        const uint32_t sQ = sStage + s * DKV_STAGE, sO = sQ + WG_TILE;
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
            wgmma_rs<1>(dv, pa[kc], sw128_desc(sO + kc * 2048), 1);
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)  // dk += ds^T q
            wgmma_rs<1>(dk, da[kc], sw128_desc(sQ + kc * 2048), 1);
        wg_commit();
        wg_wait0();
        fence_regs(dv);
        fence_regs(dk);
    }
    cp_async_wait_all();
    constexpr bool FLAT = MODE != MODE_HEAD;
    store_acc(t.dk, t.gs, dk, key_lo, n, h, hd, a.scale, FLAT, a.cos_t, a.sin_t, t4);
    store_acc(t.dv, t.gs, dv, key_lo, n, h, hd, 1.f, false, a.cos_t, a.sin_t, t4);
}

// Shared-memory plan of the dq kernel: q and dO tiles (BW_WG each), then
// two stages of (K tile, V tile), then (BIAS) the key mask as one 64-bit
// word a 64-key tile.
#define DQ_STAGE (2 * WG_TILE)
#define DQ_FIXED (2 * BW_WG * WG_TILE + 2 * DQ_STAGE)

template <int MODE>
__device__ __forceinline__ void bwd_dq(const BwdArgs& a) {
    constexpr bool BIAS = MODE == MODE_BIAS;
    const int n = a.n;
    const int q0 = blockIdx.x * 64 * BW_WG;
    const int h = blockIdx.y, b = blockIdx.z;
    const int hd = a.heads * 64;
    const int tid = threadIdx.x;
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t bh = (size_t)b * a.heads + h;
    const int len = BIAS ? n : min(max(a.lengths[b], 0), n);
    const BwdView<MODE> t(a, b, h);

    // no live row (K4: past the length; K9: q tiles past the length, whose
    // lse K7 writes as -1e30): dq = 0
    if (!BIAS && q0 >= len) {
        zero_span<BW_NT>(t.dq, t.qs, q0, 64 * BW_WG, n, tid);
        return;
    }

    uint8_t* smem = align1024(bw_smem);
    const uint32_t sbase = smem_u32(smem);
    const uint32_t sQ = sbase, sO = sbase + BW_WG * WG_TILE;
    const uint32_t sStage = sbase + 2 * BW_WG * WG_TILE;
    uint32_t* sBits = reinterpret_cast<uint32_t*>(smem + DQ_FIXED);  // BIAS: key j is bit j
    const int n_kt = (len + 63) / 64;

    for (int j = 0; j < BW_WG; ++j) {
        tile_async<BW_NT>(sQ + j * WG_TILE, t.q, t.qs, q0 + 64 * j, n, tid);  // flat: q_rot, then dq
        tile_async<BW_NT>(sO + j * WG_TILE, t.dO, t.os, q0 + 64 * j,
                          MODE == MODE_LEN ? len : n, tid);
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
        const uint32_t st = sStage + s * DQ_STAGE;
        tile_async<BW_NT>(st, t.k, 64, k0, n, tid);
        tile_async<BW_NT>(st + WG_TILE, t.v, t.vs, k0, n, tid);
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
    const uint32_t aQ = sQ + wg * WG_TILE, aO = sO + wg * WG_TILE;

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
        const uint32_t sK = sStage + s * DQ_STAGE, sV = sK + WG_TILE;

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
    store_acc(t.dq, t.qs, dq, row_lo, n, h, hd, a.scale, MODE != MODE_HEAD, a.cos_t, a.sin_t, t4);
}

// K4
__global__ void __launch_bounds__(256) attn_bwd_prologue_kernel(const BwdArgs a) {
    flat_bwd_prologue<false>(a);
}
__global__ void __launch_bounds__(BW_NT, BW_MINB) attn_bwd_dkdv_kernel(const BwdArgs a) {
    bwd_dkdv<MODE_LEN>(a);
}
__global__ void __launch_bounds__(BW_NT, BW_MINB) attn_bwd_dq_kernel(const BwdArgs a) {
    bwd_dq<MODE_LEN>(a);
}

// K8
__global__ void __launch_bounds__(256) attn_bias_bwd_prologue_kernel(const BwdArgs a) {
    flat_bwd_prologue<true>(a);
}
__global__ void __launch_bounds__(BW_NT, BW_MINB) attn_bias_bwd_dkdv_kernel(const BwdArgs a) {
    bwd_dkdv<MODE_BIAS>(a);
}
__global__ void __launch_bounds__(BW_NT, BW_MINB) attn_bias_bwd_dq_kernel(const BwdArgs a) {
    bwd_dq<MODE_BIAS>(a);
}

// K9
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const BwdArgs a) {
    head_bwd_prologue(a);
}
__global__ void __launch_bounds__(BW_NT, BW_MINB) flash_bwd_dkdv_kernel(const BwdArgs a) {
    bwd_dkdv<MODE_HEAD>(a);
}
__global__ void __launch_bounds__(BW_NT, BW_MINB) flash_bwd_dq_kernel(const BwdArgs a) {
    bwd_dq<MODE_HEAD>(a);
}

// ---------------------------------------------------------------------------
// Launch: prologue, dk/dv, dq on the caller's stream
// ---------------------------------------------------------------------------

typedef void (*bwd_kernel_t)(const BwdArgs);

static int launch_bwd(bwd_kernel_t prologue, bwd_kernel_t dkdv, bwd_kernel_t dq, bool bias,
                      const BwdArgs& a, void* stream) {
    if (a.bsz <= 0 || a.n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    const size_t rows = (size_t)a.bsz * a.n * a.heads;
    prologue<<<(unsigned)((rows + 31) / 32), 256, 0, s>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int dkv_smem = 1024 + DKV_FIXED;
    const int dq_smem = 1024 + DQ_FIXED + (bias ? (a.n + 63) / 64 * 8 : 0);
    if (dq_smem > BW_SMEM_MAX) return (int)cudaErrorInvalidValue;
    err = smem_limit_once((const void*)dkdv, BW_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    err = smem_limit_once((const void*)dq, BW_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.n + 64 * BW_WG - 1) / (64 * BW_WG), a.heads, a.bsz);
    dkdv<<<grid, BW_NT, dkv_smem, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dq<<<grid, BW_NT, dq_smem, s>>>(a);
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
                                               void* delta, int b, int n, int heads, float scale,
                                               void* stream) {
    return launch_bwd(attn_bwd_prologue_kernel, attn_bwd_dkdv_kernel, attn_bwd_dq_kernel, false,
                      flat_args(qkv, cos_t, sin_t, lengths, false, out, lse, dout, dqkv, k_rot,
                                delta, b, n, heads, scale),
                      stream);
}

extern "C" int f5_fused_qkv_rope_attn_bias_bwd_bf16(const void* qkv, const void* cos_t,
                                                    const void* sin_t, const void* kmask,
                                                    const void* out, const void* lse,
                                                    const void* dout, void* dqkv, void* k_rot,
                                                    void* delta, int b, int n, int heads,
                                                    float scale, void* stream) {
    return launch_bwd(attn_bias_bwd_prologue_kernel, attn_bias_bwd_dkdv_kernel,
                      attn_bias_bwd_dq_kernel, true,
                      flat_args(qkv, cos_t, sin_t, kmask, true, out, lse, dout, dqkv, k_rot,
                                delta, b, n, heads, scale),
                      stream);
}

extern "C" int f5_flash_attn_bwd_bf16(const void* q, const void* k, const void* v,
                                      const void* lengths, const void* o, const void* lse,
                                      const void* dout, void* dq, void* dk, void* dv,
                                      void* delta, int b, int n, int heads, float scale,
                                      void* stream) {
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
    a.scale = scale;
    return launch_bwd(flash_bwd_delta_kernel, flash_bwd_dkdv_kernel, flash_bwd_dq_kernel, false,
                      a, stream);
}
