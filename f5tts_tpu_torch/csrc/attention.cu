// Forward attention kernels, in two loops: a wgmma core over a cp.async ring
// (K3, K5 and K11, with the lse modes of K3 and K5) and an mma.sync tile loop
// (K7 and its lse mode).
//
// The wgmma core has two template axes:
//  - layout: FLAT (qkv [b, n, 3*h*64], the fused to_qkv projection output,
//    with flat cos/sin [>=n, h*64] bf16 tables: q and k are roped in the
//    kernel) or HEAD (q, k, v [b, h, n, 64] bf16, already normed and roped);
//  - key liveness: LENGTH (keys < lengths[b], int32 [b]) or KMASK (where a
//    [b, n] bool key mask is set).
// Its modes:
// K3 (FLAT + LENGTH) fused_qkv_rope_attn_kernel: fused QKV + interleaved RoPE
//    + length-masked attention. Replaces f5tts_tpu/ops/attention.py:567
//    _fused_qkv_attn_kernel and its streaming twin :659
//    _fused_qkv_attn_kernel_stream with ONE kernel: the online softmax over
//    64-key tiles covers every n, so there is no single-pass/streaming split
//    and no VMEM-driven dispatch threshold.
//    Out: [b, n, h*64] bf16; rows >= lengths[b] are written as zeros.
//    fused_qkv_rope_attn_lse_kernel, its LSE mode under grad for the backward
//    K4 (csrc/attention_bwd.cu): also lse [b, h, n] f32 = m + log(l) over the
//    scaled scores, -1e30 on the q tiles wholly past the length; rows past the
//    length inside a live q tile keep their real lse (K4 reads dO as 0 there).
//    The lse is of the scores of K3's pre-scaled bf16 q; the scale 1/8 is a
//    power of two, so that q equals the backward's unscaled roped q times the
//    scale exactly, and the lse is the statistic of the backward's scores.
// K5 (FLAT + KMASK) fused_qkv_rope_attn_bias_kernel: the same attention under
//    an arbitrary key mask. Replaces :1240 _fused_qkv_attn_bias_kernel and
//    :1307 _fused_qkv_attn_bias_kernel_stream (MMDiT joint attention: audio
//    padding leaves dead keys in the MIDDLE of the joint audio+text sequence,
//    so no prefix length can express it; the joint cos/sin rotate audio rows
//    with audio positions, text rows with text positions).
//    fused_qkv_rope_attn_bias_lse_kernel is its LSE mode under grad, for the
//    backward K8. Out: [b, n, h*64] bf16, every row computed (the caller masks
//    dead rows after to_out); the LSE mode also lse [b, h, n] f32, -1e30
//    where l == 0.
// K11 (HEAD + KMASK) masked_flash_attn_kernel: head-layout attention under a
//    key mask. Replaces :1653 _flash_kernel_bias (behind :1706
//    masked_flash_attention): MMDiT joint attention when the flat K5 cannot
//    take it (qk-norm, whose per-head RMSNorm comes before RoPE, or unfused
//    projections). Out: [b, h, n, 64] bf16, every row computed. A batch row
//    with no live key gets zeros (l == 0); the JAX reference gives the
//    uniform mean of v there. No model path makes such a row: the audio's
//    first frame is always live.
// Function (every mode): q (FLAT: roped in f32) multiplied by 1/sqrt(d) and
//    rounded to bf16 once; k (FLAT: roped in f32) rounded to bf16 once; dead
//    keys add -1e30 (not -inf, which makes dead rows NaN); f32 online
//    softmax; p rounded to bf16 before P V; l == 0 guarded.
// Bound: tensor-core operations, 4*h*64 flops a live (query, key) pair: K3
//    0.0068 ms at b = 2, n = 1024, lengths [1024, 777] (6.8 GFLOP at 989
//    TFLOP/s) against ~21 MB of bytes (0.0063 ms); K5 0.133 ms at joint 4352
//    (7,388 live keys, every query row) against ~89 MB (0.027 ms).
// Design:
//  - FLAT: a prologue ropes k once into a k_rot [b, h, n, 64] scratch (one
//    thread per 8 lanes of a (row, head); LENGTH skips the rows past the
//    length, which no block reads); the main loop never ropes a key tile.
//    HEAD: one launch, K and V read as they are.
//  - the main kernel, one warpgroup a block per (64 q rows, head, batch): the
//    block ropes (FLAT) and scales its 64 q rows once into a 128-byte-swizzled
//    shared tile; K (k_rot or k) and V (FLAT: 128 contiguous bytes a row of
//    qkv, no transpose) tiles stream through a two-stage ring filled by
//    cp.async, so the next tile's copy overlaps this tile's products; S = Q
//    K^T is wgmma with both operands in shared memory (K K-major), O += P V
//    wgmma with P from registers (the f32 scores repacked as bf16) and V the
//    N-major B; the online softmax runs in f32 on the accumulator layout with
//    exp2f, log2(e) folded into one FMA; no barrier a tile but the ring's.
//  - the keys walked: each 64-key tile's live keys are one 64-bit word.
//    LENGTH walks tiles 0 .. ceil(len / 64) - 1, the word all ones below the
//    last tile; a q tile wholly past the length walks none, so its rows are
//    zeros and its lse -1e30 with no early return (which would put the
//    block's wgmma on a path ptxas thinks divergent: it then serialises every
//    wgmma of the kernel, note C7520). KMASK stages the block's key-mask row
//    once as bits (one ballot a 32-key word) and walks only tiles with a live
//    key. Only a tile with a dead key takes the select.
//
// The mma.sync tile loop, K7 flash_attn_kernel: head-layout prefix-length
//    attention forward. Replaces :123 _flash_kernel_single and :50
//    _flash_kernel (the Pallas n <= 2048 / online-softmax split is a VMEM
//    artefact; one loop here).
//    In:  q, k, v [b, h, n, 64] bf16 (already roped), lengths [b] int32.
//    Out: [b, h, n, 64] bf16; q tiles wholly past the length are zeros, rows
//         past the length inside a live tile are computed, as in Pallas.
//    flash_attn_lse_kernel, the training mode (the Pallas bodies with their
//    lse_ref, :115-120 and :161-164, behind :193 _flash_forward(return_lse)):
//    also writes lse [b, h, n] f32 = m + log(l) over the scaled scores, and
//    -1e30 for the rows of q tiles wholly past the length, for the backward
//    K9 (csrc/attention_bwd.cu).
//    Bound as the core's. Design: one 128-thread block per (64-row q tile,
//    head, batch). Q is scaled by 1/sqrt(d) and kept as bf16 mma.sync A
//    fragments in registers. The loop over 64-key tiles stops at the length
//    (bucket padding costs no compute); each tile's K is stored into shared
//    memory, V is stored transposed so the P@V B fragments are single 32-bit
//    shared loads; scores and the running (max, sum, acc) stay in f32
//    registers. Loads are synchronous.
#include "wgmma.cuh"

#define AT_D 64
#define AT_BQ 64
#define AT_BK 64
#define AT_LDS 72  // padded shared row (bf16): conflict-free fragment loads
#define AT_NEG -1e30f

// ---------------------------------------------------------------------------
// K7: head-layout prefix-length attention forward (mma.sync tile loop)
// ---------------------------------------------------------------------------

// LSE: write each row's lse to lseb. qb/kb/vb/outb point at row 0 of this
// (batch, head), rows 64 elements apart; lseb at its n rows.
template <bool LSE>
__device__ __forceinline__ void attn_fwd_tile(const bf16* __restrict__ qb,
                                              const bf16* __restrict__ kb,
                                              const bf16* __restrict__ vb, int len,
                                              bf16* __restrict__ outb, int n, float sm_scale,
                                              float* __restrict__ lseb) {
    const int q0 = blockIdx.x * AT_BQ;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;

    if (q0 >= len) {  // whole q tile past the length: zeros
        for (int i = tid; i < AT_BQ * 8; i += 128) {
            const int row = q0 + (i >> 3);
            if (row < n)
                *reinterpret_cast<uint4*>(outb + row * AT_D + (i & 7) * 8) =
                    make_uint4(0, 0, 0, 0);
        }
        if (LSE && tid < AT_BQ && q0 + tid < n) lseb[q0 + tid] = AT_NEG;
        return;
    }

    __shared__ __align__(16) bf16 sQ[AT_BQ * AT_LDS];
    __shared__ __align__(16) bf16 sK[AT_BK * AT_LDS];
    __shared__ __align__(16) bf16 sVt[AT_D * AT_LDS];  // V transposed: [dim][key]

    // q tile: * 1/sqrt(d), round to bf16
    for (int i = tid; i < AT_BQ * 8; i += 128) {
        const int r = i >> 3, c = (i & 7) * 8;
        const int row = q0 + r;
        float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (row < n) {
            unpack8(*reinterpret_cast<const uint4*>(qb + row * AT_D + c), f);
#pragma unroll
            for (int e = 0; e < 8; ++e) f[e] *= sm_scale;
        }
        *reinterpret_cast<uint4*>(sQ + r * AT_LDS + c) = pack8(f);
    }
    __syncthreads();

    uint32_t qa[4][4];
    {
        const bf16* q_lo = sQ + (warp * 16 + g) * AT_LDS + t4 * 2;
        const bf16* q_hi = q_lo + 8 * AT_LDS;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            qa[kk][0] = lds32(q_lo + kk * 16);
            qa[kk][1] = lds32(q_hi + kk * 16);
            qa[kk][2] = lds32(q_lo + kk * 16 + 8);
            qa[kk][3] = lds32(q_hi + kk * 16 + 8);
        }
    }

    float m_run[2] = {AT_NEG, AT_NEG};
    float l_run[2] = {0.f, 0.f};
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

    const int n_tiles = (len + AT_BK - 1) / AT_BK;
    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = kt * AT_BK;
        __syncthreads();  // previous tile's sK / sVt reads are done
        // K tile
        for (int i = tid; i < AT_BK * 8; i += 128) {
            const int r = i >> 3, c = (i & 7) * 8;
            const int key = k0 + r;
            float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            if (key < n) unpack8(*reinterpret_cast<const uint4*>(kb + key * AT_D + c), f);
            *reinterpret_cast<uint4*>(sK + r * AT_LDS + c) = pack8(f);
        }
        // V tile, transposed: lane = dim pair, each thread 8 consecutive keys
        for (int i = tid; i < 32 * (AT_BK / 8); i += 128) {
            const int dp = i & 31, kg = (i >> 5) * 8;
            uint32_t w[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int key = k0 + kg + j;
                w[j] = key < n ? *reinterpret_cast<const uint32_t*>(vb + key * AT_D + dp * 2)
                               : 0u;
            }
            uint4 lo, hi;  // dim 2dp gets the low halves, dim 2dp+1 the high
            uint32_t* plo = reinterpret_cast<uint32_t*>(&lo);
            uint32_t* phi = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                plo[j] = (w[2 * j] & 0xffffu) | (w[2 * j + 1] << 16);
                phi[j] = (w[2 * j] >> 16) | (w[2 * j + 1] & 0xffff0000u);
            }
            *reinterpret_cast<uint4*>(sVt + (2 * dp) * AT_LDS + kg) = lo;
            *reinterpret_cast<uint4*>(sVt + (2 * dp + 1) * AT_LDS + kg) = hi;
        }
        __syncthreads();

        // S = Q K^T for this warp's 16 rows x 64 keys
        float s[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
            const bf16* kr = sK + (nt * 8 + g) * AT_LDS + t4 * 2;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                mma_16816(s[nt], qa[kk], lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
        }

        // key mask + online softmax (rows g and g+8 of the warp's 16)
        float mx[2] = {AT_NEG, AT_NEG};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int key = k0 + nt * 8 + t4 * 2;
            if (key >= len) { s[nt][0] += AT_NEG; s[nt][2] += AT_NEG; }
            if (key + 1 >= len) { s[nt][1] += AT_NEG; s[nt][3] += AT_NEG; }
            mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_run[r], mx[r]);
            alpha[r] = __expf(m_run[r] - m_new);
            m_run[r] = m_new;
            l_run[r] *= alpha[r];
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            s[nt][0] = __expf(s[nt][0] - m_run[0]);
            s[nt][1] = __expf(s[nt][1] - m_run[0]);
            s[nt][2] = __expf(s[nt][2] - m_run[1]);
            s[nt][3] = __expf(s[nt][3] - m_run[1]);
            l_run[0] += s[nt][0] + s[nt][1];
            l_run[1] += s[nt][2] + s[nt][3];
            acc[nt][0] *= alpha[0];
            acc[nt][1] *= alpha[0];
            acc[nt][2] *= alpha[1];
            acc[nt][3] *= alpha[1];
        }

        // acc += P V: P re-packed from the score fragments as bf16 A operands
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
            uint32_t pa[4];
            pa[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
            pa[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
            pa[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
            pa[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
            for (int dt = 0; dt < 8; ++dt) {
                const bf16* vr = sVt + (dt * 8 + g) * AT_LDS + kc * 16 + t4 * 2;
                mma_16816(acc[dt], pa, lds32(vr), lds32(vr + 8));
            }
        }
    }

    // finish: quad-reduce l, normalise
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + r * 8;
        if (row >= n) continue;
        const float inv = l_run[r] != 0.f ? 1.f / l_run[r] : 0.f;
        if (LSE && t4 == 0) lseb[row] = l_run[r] > 0.f ? m_run[r] + logf(l_run[r]) : AT_NEG;
        bf16* orow = outb + row * AT_D + t4 * 2;
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
            *reinterpret_cast<uint32_t*>(orow + dt * 8) =
                pack_bf16x2(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
}

__global__ void __launch_bounds__(128) flash_attn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ lengths, bf16* __restrict__ out, int n, int heads,
    float sm_scale) {
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t base = ((size_t)b * heads + h) * n * AT_D;
    attn_fwd_tile<false>(q + base, k + base, v + base, min(max(lengths[b], 0), n), out + base, n,
                         sm_scale, nullptr);
}

__global__ void __launch_bounds__(128) flash_attn_lse_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ lengths, bf16* __restrict__ out, float* __restrict__ lse, int n,
    int heads, float sm_scale) {
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t rows = ((size_t)b * heads + h) * n;
    attn_fwd_tile<true>(q + rows * AT_D, k + rows * AT_D, v + rows * AT_D,
                        min(max(lengths[b], 0), n), out + rows * AT_D, n, sm_scale, lse + rows);
}

extern "C" int f5_flash_attn_bf16(const void* q, const void* k, const void* v,
                                  const void* lengths, void* out, int b, int n, int heads,
                                  float sm_scale, void* stream) {
    if (b > 0 && n > 0) {
        dim3 grid((n + AT_BQ - 1) / AT_BQ, heads, b);
        flash_attn_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths,
            (bf16*)out, n, heads, sm_scale);
    }
    return (int)cudaGetLastError();
}

extern "C" int f5_flash_attn_lse_bf16(const void* q, const void* k, const void* v,
                                      const void* lengths, void* out, void* lse, int b, int n,
                                      int heads, float sm_scale, void* stream) {
    if (b > 0 && n > 0) {
        dim3 grid((n + AT_BQ - 1) / AT_BQ, heads, b);
        flash_attn_lse_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths,
            (bf16*)out, (float*)lse, n, heads, sm_scale);
    }
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wgmma core: K3 (FLAT + LENGTH), K5 (FLAT + KMASK), K11 (HEAD + KMASK)
// ---------------------------------------------------------------------------

// One warpgroup a block, at most 168 registers (three blocks an SM; the
// kernel takes ~110, so four fit): measured on the H100 (PERF.md,
// `kernel_ab.py`), two warpgroups a block, a 102-register cap, 128-key tiles,
// and issuing the next tile's S beside this tile's P V (a three-stage or a
// split K / V ring, the softmax overlapping P V) were no faster for K5.
#define FW_NT 128
#define FW_MINB 3
#define FW_LOG2E 1.4426950408889634f
#define FW_SMEM_MAX 232448  // the opt-in maximum of dynamic shared memory
// Shared-memory plan (every tile 1024-aligned): the q tile, two stages of
// (K tile, V tile), then (KMASK) the key mask, one 64-bit word a 64-key tile.
#define FW_STAGE (2 * WG_TILE)
#define FW_FIXED (WG_TILE + 2 * FW_STAGE)

enum FwdLayout { FW_FLAT = 0, FW_HEAD = 1 };
enum FwdLive { FW_LENGTH = 0, FW_KMASK = 1 };

// The pointers of one forward (null where a mode has none).
struct FwdArgs {
    const bf16 *qkv, *cos_t, *sin_t;  // FLAT: the fused projection and the rope tables
    const bf16 *q, *k, *v;            // HEAD: normed and roped q and k, and v
    const int* lengths;               // LENGTH
    const uint8_t* kmask;             // KMASK
    bf16* krot;                       // FLAT: roped k scratch [b, h, n, 64]
    bf16* out;
    float* lse;                       // the LSE modes
    int bsz, n, heads;
    float scale;
};

// Row 0 of one (batch, head) of q, k, v and the output, and their row strides
// (elements; k's is 64): FLAT reads q and v from qkv, k from k_rot, and writes
// the flat output; HEAD reads and writes [b, h, n, 64].
template <int LAYOUT>
struct FwdView {
    const bf16 *q, *k, *v;
    bf16* out;
    size_t qs, vs, os;
    __device__ __forceinline__ FwdView(const FwdArgs& a, int b, int h) {
        const size_t bh = (size_t)b * a.heads + h, n = a.n;
        if constexpr (LAYOUT == FW_HEAD) {
            q = a.q + bh * n * 64;
            k = a.k + bh * n * 64;
            v = a.v + bh * n * 64;
            out = a.out + bh * n * 64;
            qs = vs = os = 64;
        } else {
            const size_t hd = (size_t)a.heads * 64, row3 = 3 * hd;
            q = a.qkv + b * n * row3 + h * 64;
            k = a.krot + bh * n * 64;
            v = q + 2 * hd;
            out = a.out + b * n * hd + h * 64;
            qs = vs = row3;
            os = hd;
        }
    }
};

extern __shared__ __align__(16) uint8_t fw_smem[];

// FLAT prologue: k roped in f32 and rounded to bf16 into krot [b, h, n, 64],
// one thread per 8 lanes of a (row, head); LENGTH skips the rows past the
// length, which no block reads.
template <int LIVE>
__device__ __forceinline__ void krot_prologue(const FwdArgs& a) {
    const int n = a.n, heads = a.heads;
    const long long pair = (long long)blockIdx.x * 32 + (threadIdx.x >> 3);
    if (pair >= (long long)a.bsz * n * heads) return;
    const int c = (threadIdx.x & 7) * 8;
    const int hd = heads * 64;
    const long long row = pair / heads;  // b * n + i
    const int hh = (int)(pair - row * heads);
    const int bb = (int)(row / n), i = (int)(row - (long long)bb * n);
    if (LIVE == FW_LENGTH && i >= a.lengths[bb]) return;
    float k[8], cs[8], sn[8];
    unpack8(*reinterpret_cast<const uint4*>(a.qkv + row * 3 * hd + hd + hh * 64 + c), k);
    unpack8(*reinterpret_cast<const uint4*>(a.cos_t + (size_t)i * hd + hh * 64 + c), cs);
    unpack8(*reinterpret_cast<const uint4*>(a.sin_t + (size_t)i * hd + hh * 64 + c), sn);
    rope8(k, cs, sn);
    *reinterpret_cast<uint4*>(a.krot + (((size_t)bb * heads + hh) * n + i) * 64 + c) = pack8(k);
}

template <int LAYOUT, int LIVE, bool LSE>
__device__ __forceinline__ void wg_fwd(const FwdArgs& a) {
    constexpr bool KMASK = LIVE == FW_KMASK;
    const int n = a.n;
    const int q0 = blockIdx.x * 64;
    const int h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t bh = (size_t)b * a.heads + h;
    const FwdView<LAYOUT> t(a, b, h);
    // LENGTH: keys < len are live, and a q tile wholly past the length walks
    // no key tile (its rows are written as zeros, its lse as -1e30); KMASK:
    // the mask decides, len = n
    const int len = KMASK ? n : min(max(a.lengths[b], 0), n);
    const bool live_tile = KMASK || q0 < len;
    const int n_kt = live_tile ? (len + 63) / 64 : 0;

    uint8_t* smem = align1024(fw_smem);
    const uint32_t sQ = smem_u32(smem);
    const uint32_t sStage = sQ + WG_TILE;
    uint32_t* sBits = reinterpret_cast<uint32_t*>(smem + FW_FIXED);  // KMASK: key j is bit j
    if constexpr (KMASK) {
        mask_bits<FW_NT>(sBits, a.kmask + (size_t)b * n, n, n_kt * 64, tid);
        __syncthreads();
    }
    auto tile_bits = [&](int kt) -> uint64_t {  // key kt * 64 + j is bit j
        if constexpr (KMASK) {
            return ((uint64_t)sBits[2 * kt + 1] << 32) | sBits[2 * kt];
        } else {
            const int rem = len - kt * 64;
            return rem >= 64 ? ~0ull : (1ull << rem) - 1;
        }
    };
    auto next_tile = [&](int kt) -> int {  // the first tile >= kt with a live key
        if constexpr (KMASK)
            while (kt < n_kt && !tile_bits(kt)) ++kt;
        return kt;
    };
    auto load_stage = [&](int k0, int s) {  // keys >= len zero-filled
        const uint32_t st = sStage + s * FW_STAGE;
        tile_async<FW_NT>(st, t.k, 64, k0, len, tid);
        tile_async<FW_NT>(st + WG_TILE, t.v, t.vs, k0, len, tid);
        cp_async_commit();
    };
    int kt = next_tile(0);
    if (kt < n_kt) load_stage(kt * 64, 0);
    else cp_async_commit();

    // q rows (FLAT: roped in f32) * 1/sqrt(d), rounded to bf16, into the
    // swizzled q tile (while the first K / V copy is in flight); rows >= n are 0
    if (live_tile) {
        for (int i = tid; i < 64 * 8; i += FW_NT) {
            const int r = i >> 3, c = i & 7;
            const int row = q0 + r;
            float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            if (row < n) {
                unpack8(*reinterpret_cast<const uint4*>(t.q + row * t.qs + c * 8), f);
                if constexpr (LAYOUT == FW_FLAT) {
                    const int hd = a.heads * 64;
                    float cs[8], sn[8];
                    unpack8(*reinterpret_cast<const uint4*>(a.cos_t + (size_t)row * hd + h * 64 + c * 8), cs);
                    unpack8(*reinterpret_cast<const uint4*>(a.sin_t + (size_t)row * hd + h * 64 + c * 8), sn);
                    rope8(f, cs, sn);
                }
#pragma unroll
                for (int e = 0; e < 8; ++e) f[e] *= a.scale;
            }
            *reinterpret_cast<uint4*>(smem + sw128_off(r, c)) = pack8(f);
        }
    }

    // this thread's two accumulator rows are queries row_lo and row_lo + 8
    const int row_lo = q0 + warp * 16 + g;
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m_run[2] = {AT_NEG, AT_NEG}, l_run[2] = {0.f, 0.f};
    for (int it = 0; kt < n_kt; ++it) {
        const int s = it & 1;
        cp_async_wait_all();
        __syncthreads();  // stage s (and the q tile) landed; every thread is done with stage s ^ 1
        const int nxt = next_tile(kt + 1);
        if (nxt < n_kt) load_stage(nxt * 64, s ^ 1);
        const uint32_t sK = sStage + s * FW_STAGE, sV = sK + WG_TILE;
        const uint64_t bits = tile_bits(kt);

        float sc[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // S = Q K^T: 64 queries x 64 keys (q pre-scaled)
            wgmma_ss<0>(sc, sw128_desc(sQ + kk * 32), sw128_desc(sK + kk * 32), kk);
        wg_commit();
        wg_wait0();
        fence_regs(sc);

        // dead keys: -1e30 (the plain version's additive row), selected only
        // in a tile with a dead key; the tile holds a live key, so every
        // row's max is finite and their p is 0. This thread's keys nt * 8 +
        // t4 * 2 + {0, 1} are bits nt * 8 + {0, 1} of bits >> (t4 * 2).
        if (bits != ~0ull) {
            const uint64_t kbits = bits >> (t4 * 2);
#pragma unroll
            for (int i = 0; i < 32; ++i)
                if (!((kbits >> ((i >> 2) * 8 + (i & 1))) & 1)) sc[i] = AT_NEG;
        }
        float mx[2] = {AT_NEG, AT_NEG};
#pragma unroll
        for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float alpha[2], m2[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_run[r], mx[r]);
            alpha[r] = exp2f((m_run[r] - m_new) * FW_LOG2E);
            m_run[r] = m_new;
            m2[r] = m_new * FW_LOG2E;
            l_run[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const float p = exp2f(fmaf(sc[i], FW_LOG2E, -m2[(i >> 1) & 1]));
            sc[i] = p;
            l_run[(i >> 1) & 1] += p;
            o[i] *= alpha[(i >> 1) & 1];
        }
        uint32_t pa[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a(pa[kc], sc, kc);
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)  // O += P V (V N-major: 16 keys a step)
            wgmma_rs<1>(o, pa[kc], sw128_desc(sV + kc * 2048), 1);
        wg_commit();
        wg_wait0();
        fence_regs(o);
        kt = nxt;
    }
    cp_async_wait_all();

    // finish: quad-reduce l, normalise, write the rows (and the lse); LENGTH
    // writes rows >= len as zeros and keeps their lse
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_lo + r * 8;
        if (row >= n) continue;
        const float inv = ((KMASK || row < len) && l_run[r] != 0.f) ? 1.f / l_run[r] : 0.f;
        if (LSE && t4 == 0)
            a.lse[bh * n + row] = l_run[r] > 0.f ? m_run[r] + logf(l_run[r]) : AT_NEG;
        bf16* orow = t.out + row * t.os + t4 * 2;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
            *reinterpret_cast<uint32_t*>(orow + nt * 8) =
                pack_bf16x2(o[4 * nt + 2 * r] * inv, o[4 * nt + 2 * r + 1] * inv);
    }
}

// K3
__global__ void __launch_bounds__(256) fused_qkv_rope_attn_krot_kernel(const FwdArgs a) {
    krot_prologue<FW_LENGTH>(a);
}
__global__ void __launch_bounds__(FW_NT, FW_MINB) fused_qkv_rope_attn_kernel(const FwdArgs a) {
    wg_fwd<FW_FLAT, FW_LENGTH, false>(a);
}
__global__ void __launch_bounds__(FW_NT, FW_MINB) fused_qkv_rope_attn_lse_kernel(const FwdArgs a) {
    wg_fwd<FW_FLAT, FW_LENGTH, true>(a);
}

// K5
__global__ void __launch_bounds__(256) fused_qkv_rope_attn_bias_krot_kernel(const FwdArgs a) {
    krot_prologue<FW_KMASK>(a);
}
__global__ void __launch_bounds__(FW_NT, FW_MINB) fused_qkv_rope_attn_bias_kernel(const FwdArgs a) {
    wg_fwd<FW_FLAT, FW_KMASK, false>(a);
}
__global__ void __launch_bounds__(FW_NT, FW_MINB) fused_qkv_rope_attn_bias_lse_kernel(const FwdArgs a) {
    wg_fwd<FW_FLAT, FW_KMASK, true>(a);
}

// K11
__global__ void __launch_bounds__(FW_NT, FW_MINB) masked_flash_attn_kernel(const FwdArgs a) {
    wg_fwd<FW_HEAD, FW_KMASK, false>(a);
}

// ---------------------------------------------------------------------------
// Launch: (FLAT) prologue, then the main kernel, on the caller's stream
// ---------------------------------------------------------------------------

typedef void (*fwd_kernel_t)(const FwdArgs);

static int launch_fwd(fwd_kernel_t prologue, fwd_kernel_t main_kernel, const FwdArgs& a,
                      void* stream) {
    if (a.bsz <= 0 || a.n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (prologue) {
        const size_t rows = (size_t)a.bsz * a.n * a.heads;
        prologue<<<(unsigned)((rows + 31) / 32), 256, 0, s>>>(a);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const int smem = 1024 + FW_FIXED + (a.kmask ? (a.n + 63) / 64 * 8 : 0);
    if (smem > FW_SMEM_MAX) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.n + 63) / 64, a.heads, a.bsz);
    main_kernel<<<grid, FW_NT, smem, s>>>(a);
    return (int)cudaGetLastError();
}

static FwdArgs flat_args(const void* qkv, const void* cos_t, const void* sin_t, const void* mask,
                         bool kmask, void* out, void* lse, void* k_rot, int b, int n, int heads,
                         float scale) {
    FwdArgs a = {};
    a.qkv = (const bf16*)qkv;
    a.cos_t = (const bf16*)cos_t;
    a.sin_t = (const bf16*)sin_t;
    if (kmask) a.kmask = (const uint8_t*)mask;
    else a.lengths = (const int*)mask;
    a.krot = (bf16*)k_rot;
    a.out = (bf16*)out;
    a.lse = (float*)lse;
    a.bsz = b;
    a.n = n;
    a.heads = heads;
    a.scale = scale;
    return a;
}

extern "C" int f5_fused_qkv_rope_attn_bf16(const void* qkv, const void* cos_t,
                                           const void* sin_t, const void* lengths, void* out,
                                           void* k_rot, int b, int n, int heads, float sm_scale,
                                           void* stream) {
    return launch_fwd(fused_qkv_rope_attn_krot_kernel, fused_qkv_rope_attn_kernel,
                      flat_args(qkv, cos_t, sin_t, lengths, false, out, nullptr, k_rot, b, n,
                                heads, sm_scale),
                      stream);
}

extern "C" int f5_fused_qkv_rope_attn_lse_bf16(const void* qkv, const void* cos_t,
                                               const void* sin_t, const void* lengths,
                                               void* out, void* lse, void* k_rot, int b, int n,
                                               int heads, float sm_scale, void* stream) {
    return launch_fwd(fused_qkv_rope_attn_krot_kernel, fused_qkv_rope_attn_lse_kernel,
                      flat_args(qkv, cos_t, sin_t, lengths, false, out, lse, k_rot, b, n, heads,
                                sm_scale),
                      stream);
}

extern "C" int f5_fused_qkv_rope_attn_bias_bf16(const void* qkv, const void* cos_t,
                                                const void* sin_t, const void* kmask, void* out,
                                                void* k_rot, int b, int n, int heads,
                                                float sm_scale, void* stream) {
    return launch_fwd(fused_qkv_rope_attn_bias_krot_kernel, fused_qkv_rope_attn_bias_kernel,
                      flat_args(qkv, cos_t, sin_t, kmask, true, out, nullptr, k_rot, b, n, heads,
                                sm_scale),
                      stream);
}

extern "C" int f5_fused_qkv_rope_attn_bias_lse_bf16(const void* qkv, const void* cos_t,
                                                    const void* sin_t, const void* kmask,
                                                    void* out, void* lse, void* k_rot, int b,
                                                    int n, int heads, float sm_scale,
                                                    void* stream) {
    return launch_fwd(fused_qkv_rope_attn_bias_krot_kernel, fused_qkv_rope_attn_bias_lse_kernel,
                      flat_args(qkv, cos_t, sin_t, kmask, true, out, lse, k_rot, b, n, heads,
                                sm_scale),
                      stream);
}

extern "C" int f5_masked_flash_attn_bf16(const void* q, const void* k, const void* v,
                                         const void* kmask, void* out, int b, int n, int heads,
                                         float sm_scale, void* stream) {
    FwdArgs a = {};
    a.q = (const bf16*)q;
    a.k = (const bf16*)k;
    a.v = (const bf16*)v;
    a.kmask = (const uint8_t*)kmask;
    a.out = (bf16*)out;
    a.bsz = b;
    a.n = n;
    a.heads = heads;
    a.scale = sm_scale;
    return launch_fwd(nullptr, masked_flash_attn_kernel, a, stream);
}
