// Forward attention kernels: one wgmma core over a cp.async ring, in four
// modes (K3, K5, K7 and K11, with the lse modes of K3, K5 and K7).
//
// The core has three template axes:
//  - the head width D, 64 or 128 (every mode at both; the JAX bodies take d
//    in {64, 128}, attention.py:1189 / :1498 / :1714). K7 reads and writes
//    rows of any width d <= D (d % 8 == 0) in place: D is the tiles' width,
//    d the rows' stride; the tiles' lanes at or past d are zero-filled as
//    they are copied and the output's are not stored, so the scores, the
//    softmax and the kept lanes are those of a zero-padded head (its NARROW
//    instantiations; d = D runs the others, whose strides are constants). K7 takes d
//    in (128, 256] the same way in its native wide kernels at D = 192 / 256,
//    d in (256, 512] in its pair kernels at D = 384 / 512 and d > 512 in its
//    slice mode, below;
//  - layout: FLAT (qkv [b, n, 3*h*D], the fused to_qkv projection output,
//    with flat cos/sin [>=n, h*D] bf16 tables: q and k are roped in the
//    kernel) or HEAD (q, k, v [b, h, n, D] bf16, already normed and roped);
//  - key liveness: LENGTH (keys < lengths[b], int32 [b]) or KMASK (where a
//    [b, n] bool key mask is set).
// Its modes:
// K3 (FLAT + LENGTH) fused_qkv_rope_attn_kernel: fused QKV + interleaved RoPE
//    + length-masked attention. Replaces f5tts_tpu/ops/attention.py:567
//    _fused_qkv_attn_kernel and its streaming twin :659
//    _fused_qkv_attn_kernel_stream with ONE kernel: the online softmax over
//    64-key tiles covers every n, so there is no single-pass/streaming split
//    and no VMEM-driven dispatch threshold.
//    Out: [b, n, h*D] bf16; rows >= lengths[b] are written as zeros.
//    fused_qkv_rope_attn_lse_kernel, its LSE mode under grad for the backward
//    K4 (csrc/attention_bwd.cu): also lse [b, h, n] f32 = m + log(l) over the
//    scaled scores, -1e30 on the q tiles wholly past the length; rows past the
//    length inside a live q tile keep their real lse (K4 reads dO as 0 there).
//    The lse is of the scores of K3's pre-scaled bf16 q. At D = 64 the scale
//    1/8 is a power of two, so that q equals the backward's unscaled roped q
//    times the scale exactly, and the lse is the statistic of the backward's
//    scores; at D = 128 (scale 1/sqrt(128)) the two differ by q's bf16
//    rounding, and K4's p = exp(s * scale - lse) sum to 1 within it.
// K5 (FLAT + KMASK) fused_qkv_rope_attn_bias_kernel: the same attention under
//    an arbitrary key mask. Replaces :1240 _fused_qkv_attn_bias_kernel and
//    :1307 _fused_qkv_attn_bias_kernel_stream (MMDiT joint attention: audio
//    padding leaves dead keys in the MIDDLE of the joint audio+text sequence,
//    so no prefix length can express it; the joint cos/sin rotate audio rows
//    with audio positions, text rows with text positions).
//    fused_qkv_rope_attn_bias_lse_kernel is its LSE mode under grad, for the
//    backward K8. Out: [b, n, h*D] bf16, every row computed (the caller masks
//    dead rows after to_out); the LSE mode also lse [b, h, n] f32, -1e30
//    where l == 0.
// K7 (HEAD + LENGTH) flash_attn_kernel: head-layout prefix-length attention.
//    Replaces :123 _flash_kernel_single and :50 _flash_kernel (the Pallas
//    n <= 2048 / online-softmax split is a VMEM artefact; one loop here).
//    Out: [b, h, n, D] bf16; q tiles wholly past the length are zeros, rows
//    past the length inside a live tile are computed (over the live keys), as
//    in Pallas. flash_attn_lse_kernel, its LSE mode under grad (the Pallas
//    bodies with their lse_ref, :115-120 and :161-164, behind :193
//    _flash_forward(return_lse)): also lse [b, h, n] f32 = m + log(l) over the
//    scaled scores, every row of a live q tile (K9 reads the rows past the
//    length too), -1e30 on the q tiles wholly past the length, for the
//    backward K9 (csrc/attention_bwd.cu).
//    flash_attn_native_kernel and flash_attn_native_lse_kernel: the same
//    function at D = 192 and 256 (rows of any d in (128, 256] in place, TMA
//    reading the columns past d as zeros), one launch: the q tile resident,
//    K and V tiles through TMA stages, the scores of a tile computed once
//    over the whole width (`fwd_native`). flash_attn_pair_kernel and
//    flash_attn_pair_lse_kernel: the same at D = 384 and 512 (d in (256,
//    512]), one launch of clusters of two blocks on the same q rows, each
//    owning half of the width and trading partial scores (`fwd_pair`).
//    flash_attn_wide_kernel and flash_attn_wide_lse_kernel, the slice mode:
//    any head width d > 128 (d % 8 == 0; the Pallas bodies take any d; the
//    wrapper sends it d > 512), one launch. A block computes
//    one slice of at most 128 output columns, its scores over the whole
//    width (m = ceil(d / 64) sub-tile products), every operand streamed
//    through one ring of 16 KB units, so shared memory does not grow with d
//    (`wg_fwd_wide`).
// K11 (HEAD + KMASK) masked_flash_attn_kernel: head-layout attention under a
//    key mask. Replaces :1653 _flash_kernel_bias (behind :1706
//    masked_flash_attention): MMDiT joint attention when the flat K5 cannot
//    take it (qk-norm, whose per-head RMSNorm comes before RoPE, or unfused
//    projections). Out: [b, h, n, D] bf16, every row computed. A batch row
//    with no live key gets zeros (l == 0); the JAX reference gives the
//    uniform mean of v there. No model path makes such a row: the audio's
//    first frame is always live.
// Function (every mode): FLAT: q roped in f32, multiplied by 1/sqrt(d) and
//    rounded to bf16 once (the Pallas bodies' rounding point), k roped in f32
//    and rounded to bf16 once; HEAD: q and k as given, the f32 scores
//    multiplied by the scale (the plain versions' function; at D = 64 the
//    two are the same numbers, the scale a power of two); dead keys add
//    -1e30 (not -inf, which makes dead rows NaN); f32 online softmax; p
//    rounded to bf16 before P V; l == 0 guarded.
// Bound: tensor-core operations, 4*h*d flops a live (query, key) pair: K3
//    0.0068 ms at b = 2, n = 1024, lengths [1024, 777] (6.8 GFLOP at 989
//    TFLOP/s) against ~21 MB of bytes (0.0063 ms); K5 0.133 ms at joint 4352
//    (7,388 live keys, every query row) against ~89 MB (0.027 ms); K7 as K3
//    (0.0764 ms at n = 4224, lengths [4224, 777]); the same at 8 heads of
//    128, since the flops depend on h*d alone.
// Design:
//  - FLAT: a prologue ropes k once into a k_rot [b, h, n, D] scratch (one
//    thread per 8 lanes of a (row, head); LENGTH skips the rows past the
//    length, which no block reads); the main loop never ropes a key tile.
//    HEAD: one launch, K and V read as they are.
//  - the main kernel, one warpgroup a block per (64 q rows, head, batch): the
//    block ropes (FLAT) and scales its 64 q rows once into a 128-byte-swizzled
//    shared tile (D = 128: two 64-column halves); K (k_rot or k) and V (FLAT:
//    2*D contiguous bytes a row of qkv, no transpose) tiles stream through a
//    two-stage ring filled by cp.async, so the next tile's copy overlaps this
//    tile's products; S = Q K^T is wgmma with both operands in shared memory
//    (K K-major, D / 16 k-steps, the descriptor stepping across the halves),
//    O += P V wgmma m64nDk16 with P from registers (the f32 scores repacked
//    as bf16) and V the N-major B (at D = 128 its descriptor's leading offset
//    spans the halves); the online softmax runs in f32 on the accumulator
//    layout with exp2f, log2(e) (HEAD: times the scale) folded into one FMA;
//    no barrier a tile but the ring's.
//  - D = 128: the O accumulator is 64 registers a thread (beside S's 32 and
//    P's 16) and the shared plan 80 KB, so two blocks an SM (255 registers a
//    thread at most); D = 64 keeps three (168).
//  - the keys walked: each 64-key tile's live keys are one 64-bit word.
//    LENGTH walks tiles 0 .. ceil(len / 64) - 1, the word all ones below the
//    last tile; a q tile wholly past the length walks none, so its rows are
//    zeros and its lse -1e30 with no early return (which would put the
//    block's wgmma on a path ptxas thinks divergent: it then serialises every
//    wgmma of the kernel, note C7520). KMASK stages the block's key-mask row
//    once as bits (one ballot a 32-key word) and walks only tiles with a live
//    key. Only a tile with a dead key takes the select.
//  - the epilogue: K3 writes the rows past the length as zeros; K7 writes
//    them as computed (its function, which K9 relies on); both write zeros
//    and lse -1e30 on a q tile wholly past the length (l == 0).
#include "wgmma.cuh"

// ---------------------------------------------------------------------------
// The wgmma core: K3 (FLAT + LENGTH), K5 (FLAT + KMASK), K7 (HEAD + LENGTH),
// K11 (HEAD + KMASK)
// ---------------------------------------------------------------------------

// One warpgroup a block, at most 168 registers (three blocks an SM; the
// kernel takes ~110, so four fit): measured on the H100 (PERF.md,
// `kernel_ab.py`), two warpgroups a block, a 102-register cap, 128-key tiles,
// and issuing the next tile's S beside this tile's P V (a three-stage or a
// split K / V ring, the softmax overlapping P V) were no faster for K5.
#define FW_NT 128
#define FW_MINB(D) ((D) == 64 ? 3 : 2)
#define FW_LOG2E 1.4426950408889634f
#define FW_NEG -1e30f
#define FW_SMEM_MAX 232448  // the opt-in maximum of dynamic shared memory
// Shared-memory plan (every tile 1024-aligned): the q tile, two stages of
// (K tile, V tile), then (KMASK) the key mask, one 64-bit word a 64-key tile;
// a [64][D] tile is FW_TILE(D) bytes.
#define FW_TILE(D) ((D) / 64 * WG_TILE)
#define FW_FIXED(D) (5 * FW_TILE(D))

enum FwdLayout { FW_FLAT = 0, FW_HEAD = 1 };
enum FwdLive { FW_LENGTH = 0, FW_KMASK = 1 };

// The pointers of one forward (null where a mode has none).
struct FwdArgs {
    const bf16 *qkv, *cos_t, *sin_t;  // FLAT: the fused projection and the rope tables
    const bf16 *q, *k, *v;            // HEAD: normed and roped q and k, and v
    const int* lengths;               // LENGTH
    const uint8_t* kmask;             // KMASK
    bf16* krot;                       // FLAT: roped k scratch [b, h, n, D]
    bf16* out;
    float* lse;                       // the LSE modes
    int bsz, n, heads;
    int d;                            // HEAD: the width of q, k, v and out's rows (<= D)
    float scale;
};

// Row 0 of one (batch, head) of q, k, v and the output, their row strides
// (elements) and the lanes a row holds: FLAT reads q and v from qkv, k from
// k_rot, and writes the flat output, D lanes a row; HEAD reads and writes
// the caller's [b, h, n, d] in place: with NARROW d < D lanes a row (the
// tiles' lanes at or past d are zero-filled, the output's not stored),
// else d = D, every stride and limit a constant (the code of a full-width
// head is not slowed by the narrow case: measured 5-10% when it was one
// instantiation with run-time strides, PERF.md §6).
template <int LAYOUT, int D, bool NARROW = false>
struct FwdView {
    const bf16 *q, *k, *v;
    bf16* out;
    size_t qs, ks, vs, os;
    int cols;
    __device__ __forceinline__ FwdView(const FwdArgs& a, int b, int h) {
        const size_t bh = (size_t)b * a.heads + h, n = a.n;
        if constexpr (LAYOUT == FW_HEAD) {
            const int d = NARROW ? a.d : D;
            q = a.q + bh * n * d;
            k = a.k + bh * n * d;
            v = a.v + bh * n * d;
            out = a.out + bh * n * d;
            qs = ks = vs = os = d;
            cols = d;
        } else {
            const size_t hd = (size_t)a.heads * D, row3 = 3 * hd;
            q = a.qkv + b * n * row3 + h * D;
            k = a.krot + bh * n * D;
            v = q + 2 * hd;
            out = a.out + b * n * hd + h * D;
            qs = vs = row3;
            ks = D;
            os = hd;
            cols = D;
        }
    }
};

extern __shared__ __align__(16) uint8_t fw_smem[];

// FLAT prologue: k roped in f32 and rounded to bf16 into krot [b, h, n, D],
// one thread per 8 lanes of a (row, head); LENGTH skips the rows past the
// length, which no block reads.
template <int LIVE, int D>
__device__ __forceinline__ void krot_prologue(const FwdArgs& a) {
    const int n = a.n, heads = a.heads;
    constexpr int SH = D == 64 ? 3 : 4;  // a (row, head) is D / 8 threads of a 256-thread block
    const long long pair = (long long)blockIdx.x * (256 >> SH) + (threadIdx.x >> SH);
    if (pair >= (long long)a.bsz * n * heads) return;
    const int c = (threadIdx.x & (D / 8 - 1)) * 8;
    const int hd = heads * D;
    const long long row = pair / heads;  // b * n + i
    const int hh = (int)(pair - row * heads);
    const int bb = (int)(row / n), i = (int)(row - (long long)bb * n);
    if (LIVE == FW_LENGTH && i >= a.lengths[bb]) return;
    float k[8], cs[8], sn[8];
    unpack8(*reinterpret_cast<const uint4*>(a.qkv + row * 3 * hd + hd + hh * D + c), k);
    unpack8(*reinterpret_cast<const uint4*>(a.cos_t + (size_t)i * hd + hh * D + c), cs);
    unpack8(*reinterpret_cast<const uint4*>(a.sin_t + (size_t)i * hd + hh * D + c), sn);
    rope8(k, cs, sn);
    *reinterpret_cast<uint4*>(a.krot + (((size_t)bb * heads + hh) * n + i) * D + c) = pack8(k);
}

// One key tile of the online softmax over this thread's 64 x 64 scores sc
// (its rows (i >> 1) & 1; its keys nt * 8 + t4 * 2 + {0, 1} are bits nt * 8
// + {0, 1} of bits >> (t4 * 2)). Dead keys get -1e30 (the plain version's
// additive row), selected only in a tile with a dead key; the tile holds a
// live key, so every row's max is finite and their p is 0. The running max
// and sum move on, sc becomes p, and alpha is the factor O is rescaled by.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], uint64_t bits, int t4,
                                             float to_log2, float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2]) {
    if (bits != ~0ull) {
        const uint64_t kbits = bits >> (t4 * 2);
#pragma unroll
        for (int i = 0; i < 32; ++i)
            if (!((kbits >> ((i >> 2) * 8 + (i & 1))) & 1)) sc[i] = FW_NEG;
    }
    float mx[2] = {FW_NEG, FW_NEG};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float m2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = exp2f((m_run[r] - m_new) * to_log2);
        m_run[r] = m_new;
        m2[r] = m_new * to_log2;
        l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        const float p = exp2f(fmaf(sc[i], to_log2, -m2[(i >> 1) & 1]));
        sc[i] = p;
        l_run[(i >> 1) & 1] += p;
    }
}

template <int LAYOUT, int LIVE, bool LSE, int D, bool NARROW = false>
__device__ __forceinline__ void wg_fwd(const FwdArgs& a) {
    constexpr bool KMASK = LIVE == FW_KMASK;
    constexpr int TILE = FW_TILE(D), DC = D / 8, SH = D == 64 ? 3 : 4;
    // FLAT pre-scales q in bf16; HEAD folds the scale into the softmax's FMA
    constexpr bool PRESCALE = LAYOUT == FW_FLAT;
    const float to_log2 = PRESCALE ? FW_LOG2E : a.scale * FW_LOG2E;
    const int n = a.n;
    const int q0 = blockIdx.x * 64;
    const int h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t bh = (size_t)b * a.heads + h;
    const FwdView<LAYOUT, D, NARROW> t(a, b, h);
    // LENGTH: keys < len are live, and a q tile wholly past the length walks
    // no key tile (its rows are written as zeros, its lse as -1e30); KMASK:
    // the mask decides, len = n
    const int len = KMASK ? n : min(max(a.lengths[b], 0), n);
    const bool live_tile = KMASK || q0 < len;
    const int n_kt = live_tile ? (len + 63) / 64 : 0;

    uint8_t* smem = align1024(fw_smem);
    const uint32_t sQ = smem_u32(smem);
    const uint32_t sStage = sQ + TILE;
    uint32_t* sBits = reinterpret_cast<uint32_t*>(smem + FW_FIXED(D));  // KMASK: key j is bit j
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
        const uint32_t st = sStage + s * 2 * TILE;
        tile_async<FW_NT, D>(st, t.k, t.ks, k0, len, tid, t.cols);
        tile_async<FW_NT, D>(st + TILE, t.v, t.vs, k0, len, tid, t.cols);
        cp_async_commit();
    };
    int kt = next_tile(0);
    if (kt < n_kt) load_stage(kt * 64, 0);
    else cp_async_commit();

    // q rows (FLAT: roped in f32 and times 1/sqrt(d), rounded to bf16) into
    // the swizzled q tile (while the first K / V copy is in flight); rows >= n
    // and lanes >= cols are 0
    if (live_tile) {
        for (int i = tid; i < 64 * DC; i += FW_NT) {
            const int r = i >> SH, c = i & (DC - 1);
            const int row = q0 + r;
            uint4 v = make_uint4(0, 0, 0, 0);
            if (row < n && c * 8 < t.cols) {
                v = *reinterpret_cast<const uint4*>(t.q + row * t.qs + c * 8);
                if constexpr (PRESCALE) {
                    const int hd = a.heads * D;
                    float f[8], cs[8], sn[8];
                    unpack8(v, f);
                    unpack8(*reinterpret_cast<const uint4*>(a.cos_t + (size_t)row * hd + h * D + c * 8), cs);
                    unpack8(*reinterpret_cast<const uint4*>(a.sin_t + (size_t)row * hd + h * D + c * 8), sn);
                    rope8(f, cs, sn);
#pragma unroll
                    for (int e = 0; e < 8; ++e) f[e] *= a.scale;
                    v = pack8(f);
                }
            }
            *reinterpret_cast<uint4*>(smem + tile_off(r, c)) = v;
        }
    }

    // this thread's two accumulator rows are queries row_lo and row_lo + 8
    constexpr int NO = D / 2;  // O's accumulator registers
    const int row_lo = q0 + warp * 16 + g;
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m_run[2] = {FW_NEG, FW_NEG}, l_run[2] = {0.f, 0.f};
    for (int it = 0; kt < n_kt; ++it) {
        const int s = it & 1;
        cp_async_wait_all();
        __syncthreads();  // stage s (and the q tile) landed; every thread is done with stage s ^ 1
        const int nxt = next_tile(kt + 1);
        if (nxt < n_kt) load_stage(nxt * 64, s ^ 1);
        const uint32_t sK = sStage + s * 2 * TILE, sV = sK + TILE;
        const uint64_t bits = tile_bits(kt);

        float sc[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // S = Q K^T: 64 queries x 64 keys
            wgmma_ss<0>(sc, sw128_desc(kslice(sQ, kk)), sw128_desc(kslice(sK, kk)), kk);
        wg_commit();
        wg_wait0();
        fence_regs(sc);

        float alpha[2];
        softmax_tile(sc, bits, t4, to_log2, m_run, l_run, alpha);
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
        uint32_t pa[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a(pa[kc], sc, kc);
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)  // O += P V (V N-major: 16 keys a step)
            wgmma_rs<1>(o, pa[kc], mn_desc<D>(sV + kc * 2048), 1);
        wg_commit();
        wg_wait0();
        fence_regs(o);
        kt = nxt;
    }
    cp_async_wait_all();

    // finish: quad-reduce l, normalise, write the rows (and the lse); K3
    // (FLAT + LENGTH) writes rows >= len as zeros and keeps their lse
    constexpr bool ZERO_PAST_LEN = LAYOUT == FW_FLAT && LIVE == FW_LENGTH;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_lo + r * 8;
        if (row >= n) continue;
        const float inv = ((!ZERO_PAST_LEN || row < len) && l_run[r] != 0.f) ? 1.f / l_run[r] : 0.f;
        if (LSE && t4 == 0)  // the lse of the scaled scores (HEAD: m_run is unscaled)
            a.lse[bh * n + row] =
                l_run[r] > 0.f ? m_run[r] * (PRESCALE ? 1.f : a.scale) + logf(l_run[r]) : FW_NEG;
        store_acc_row(t.out + row * t.os + t4 * 2, o, r, inv, t.cols);
    }
}

// K3
template <int D>
__global__ void __launch_bounds__(256) fused_qkv_rope_attn_krot_kernel(const FwdArgs a) {
    krot_prologue<FW_LENGTH, D>(a);
}
template <int D>
__global__ void __launch_bounds__(FW_NT, FW_MINB(D)) fused_qkv_rope_attn_kernel(const FwdArgs a) {
    wg_fwd<FW_FLAT, FW_LENGTH, false, D>(a);
}
template <int D>
__global__ void __launch_bounds__(FW_NT, FW_MINB(D)) fused_qkv_rope_attn_lse_kernel(const FwdArgs a) {
    wg_fwd<FW_FLAT, FW_LENGTH, true, D>(a);
}

// K5
template <int D>
__global__ void __launch_bounds__(256) fused_qkv_rope_attn_bias_krot_kernel(const FwdArgs a) {
    krot_prologue<FW_KMASK, D>(a);
}
template <int D>
__global__ void __launch_bounds__(FW_NT, FW_MINB(D)) fused_qkv_rope_attn_bias_kernel(const FwdArgs a) {
    wg_fwd<FW_FLAT, FW_KMASK, false, D>(a);
}
template <int D>
__global__ void __launch_bounds__(FW_NT, FW_MINB(D)) fused_qkv_rope_attn_bias_lse_kernel(const FwdArgs a) {
    wg_fwd<FW_FLAT, FW_KMASK, true, D>(a);
}

// K7 (NARROW: rows of d < D)
template <int D, bool NARROW>
__global__ void __launch_bounds__(FW_NT, FW_MINB(D)) flash_attn_kernel(const FwdArgs a) {
    wg_fwd<FW_HEAD, FW_LENGTH, false, D, NARROW>(a);
}
template <int D, bool NARROW>
__global__ void __launch_bounds__(FW_NT, FW_MINB(D)) flash_attn_lse_kernel(const FwdArgs a) {
    wg_fwd<FW_HEAD, FW_LENGTH, true, D, NARROW>(a);
}

// K11
template <int D>
__global__ void __launch_bounds__(FW_NT, FW_MINB(D)) masked_flash_attn_kernel(const FwdArgs a) {
    wg_fwd<FW_HEAD, FW_KMASK, false, D>(a);
}

// ---------------------------------------------------------------------------
// K7's slice mode: HEAD + LENGTH at a head width d > 128 (d % 8 == 0)
// ---------------------------------------------------------------------------

// A block computes the output columns [c0, c0 + 128) of its 64 q rows (one
// slice: blockIdx.y = head * slices + slice), so its O accumulator is D =
// 128's. Its scores are the whole width's: S = Q K^T sums m = ceil(d / 64)
// products of 64-column sub-tiles. Every operand streams through one ring
// of FWW_STAGES 16 KB stages, a unit a stage: for each key tile, the m
// (q sub-tile, k sub-tile) pairs, then the tile's 64 keys of v at the
// slice's 128 columns. Columns at or past d are zero-filled as they are
// copied (the padded lanes add exact zeros to every score; those of v give
// output columns that are not stored), so shared memory does not grow
// with d. Every slice recomputes the scores: at d = 256 the block's tensor
// work is 1.5x the function's.
#define FWW_STAGES 4
#define FWW_UNIT (2 * WG_TILE)  // a stage: two [64][64] tiles, or one [64][128]
#define FWW_SLICE 128           // output columns a block
#define FWW_SMEM (1024 + FWW_STAGES * FWW_UNIT)

struct FwdWideArgs {
    const bf16 *q, *k, *v;  // [b, h, n, d], normed and roped q and k
    const int* lengths;
    bf16* out;
    float* lse;             // the LSE mode
    int bsz, n, heads, d;
    float scale;
};

template <bool LSE>
__device__ __forceinline__ void wg_fwd_wide(const FwdWideArgs& a) {
    const int n = a.n, d = a.d;
    const int m = (d + 63) / 64;  // the 64-column sub-tiles of the scores' contraction
    const int slices = (d + FWW_SLICE - 1) / FWW_SLICE;
    const int q0 = blockIdx.x * 64;
    const int h = blockIdx.y / slices, j = blockIdx.y - h * slices, b = blockIdx.z;
    const int c0 = j * FWW_SLICE;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t bh = (size_t)b * a.heads + h;
    const bf16* Q = a.q + bh * n * d;
    const bf16* K = a.k + bh * n * d;
    const bf16* V = a.v + bh * n * d;
    const float to_log2 = a.scale * FW_LOG2E;
    // keys < len are live; a q tile wholly past the length walks no key tile
    const int len = min(max(a.lengths[b], 0), n);
    const int n_kt = q0 < len ? (len + 63) / 64 : 0;
    const int per_kt = m + 1;  // units a key tile

    UnitRing<FWW_STAGES, FWW_UNIT> ring{smem_u32(align1024(fw_smem)), n_kt * per_kt};
    auto load = [&](int unit, uint32_t st) {
        const int kt = unit / per_kt, u = unit - kt * per_kt;
        if (u < m) {
            cols_async<FW_NT, 8>(st, Q, d, q0, n, u * 64, d, tid);
            cols_async<FW_NT, 8>(st + WG_TILE, K, d, kt * 64, len, u * 64, d, tid);
        } else {
            cols_async<FW_NT, 16>(st, V, d, kt * 64, len, c0, d, tid);
        }
    };
    ring.fill(load);

    const int row_lo = q0 + warp * 16 + g;
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m_run[2] = {FW_NEG, FW_NEG}, l_run[2] = {0.f, 0.f};
    for (int kt = 0; kt < n_kt; ++kt) {
        float sc[32];
        ring_scores(sc, ring, load, m);  // S = Q K^T over the whole width
        const int rem = len - kt * 64;  // key kt * 64 + j is bit j
        const uint64_t bits = rem >= 64 ? ~0ull : (1ull << rem) - 1;
        float alpha[2];
        softmax_tile(sc, bits, t4, to_log2, m_run, l_run, alpha);
#pragma unroll
        for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
        uint32_t pa[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a(pa[kc], sc, kc);
        ring_slice_mma(o, pa, ring, load);  // O += P V_slice
    }
    cp_async_wait_all();

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_lo + r * 8;
        if (row >= n) continue;
        const float inv = l_run[r] != 0.f ? 1.f / l_run[r] : 0.f;
        if (LSE && j == 0 && t4 == 0)  // every slice has the same scores: slice 0 writes
            a.lse[bh * n + row] = l_run[r] > 0.f ? m_run[r] * a.scale + logf(l_run[r]) : FW_NEG;
        store_acc_row(a.out + (bh * n + row) * d + c0 + t4 * 2, o, r, inv, d - c0);
    }
}

__global__ void __launch_bounds__(FW_NT, 2) flash_attn_wide_kernel(const FwdWideArgs a) {
    wg_fwd_wide<false>(a);
}
__global__ void __launch_bounds__(FW_NT, 2) flash_attn_wide_lse_kernel(const FwdWideArgs a) {
    wg_fwd_wide<true>(a);
}

// ---------------------------------------------------------------------------
// K7 native wide: HEAD + LENGTH at D = 192 and 256
// ---------------------------------------------------------------------------

// The function of K7 at D = 192 and 256, on rows of any width d in (128,
// 256] (d % 8 == 0) read and written in place: the tensor maps' rows are d
// wide, so TMA fills a box's columns at or past d with zeros as it does its
// rows past n, and the epilogue stores columns < d (d in (256, 512] takes
// the pair kernels below, d > 512 the slice mode above). A block takes 64 q rows of one head, as the D <= 128 core does: its q tile is
// copied once and stays resident, the scores of each (q tile, key tile) are
// computed once over the whole width (S = Q K^T, D / 16 k-steps) and the
// output as P V at the full width (m64nDk16), so the tensor work is the
// function's. Warp-specialised: one consumer warpgroup and a producer warp,
// whose lane 0 copies the q tile, then each key tile's K and V ([64][D]
// each) into one of FWN_STAGES stages, by TMA ([64][64] boxes from the
// tensors' maps, rows past n zero), completing on the stage's "full"
// mbarrier; the consumer waits there once a tile and releases the stage on
// its "empty" barrier after the tile's two products. One block an SM (~225
// KB of shared memory at D = 256): [2, 4, 1024, 256] makes 128 blocks for
// 132 SMs, where 128-row blocks would make 64. Measured (PERF.md §6): this
// design (a) against (b), two consumer warpgroups taking alternate key
// tiles of the same rows, merged at the end (a producer warp beside them
// made a 288-thread block, which ptxas caps at 168 registers a thread, as a
// 384-thread one: O spilled and the wgmma were serialised, note C7512, and
// `setmaxnreg` did not lift the cap; with the consumers refilling their own
// stages it was 3-4% slower at D = 256), and against the consumer refilling
// each stage itself (20-30% slower: the copies' issue stalls its warp 0).
#define FWN_NT 160  // the consumer warpgroup, then the producer warp
#define FWN_STAGES(D) ((D) == 256 ? 3 : 4)
#define FWN_TILE(D) ((D) / 64 * WG_TILE)
// shared plan: the q tile, the stages of (K tile, V tile), the barriers (q,
// then full and empty a stage)
#define FWN_SMEM(D) \
    (1024 + FWN_TILE(D) * (1 + 2 * FWN_STAGES(D)) + 8 * (1 + 2 * FWN_STAGES(D)))

struct FwdNativeArgs {
    CUtensorMap q, k, v;  // [b * h][n][d] bf16, normed and roped q and k (`head_tensor_map`)
    const int* lengths;
    bf16* out;            // [b, h, n, d]
    float* lse;           // the LSE mode
    int n, heads, d;      // d <= D, a multiple of 8: the rows' width in place
    float scale;
};

template <int D, bool LSE>
__device__ __forceinline__ void fwd_native(const FwdNativeArgs& a) {
    constexpr int TILE = FWN_TILE(D), STAGES = FWN_STAGES(D), NO = D / 2;
    const int n = a.n;
    const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
    const int bh = b * a.heads + h;
    // keys < len are live; a q tile wholly past the length walks no key tile
    const int len = min(max(a.lengths[b], 0), n);
    const int n_kt = q0 < len ? (len + 63) / 64 : 0;
    uint8_t* smem = align1024(fw_smem);
    const uint32_t sQ = smem_u32(smem), sStage = sQ + TILE;
    const uint32_t bQ = sStage + 2 * STAGES * TILE, bFull = bQ + 8, bEmpty = bFull + 8 * STAGES;
    init_stage_bars<STAGES>(bQ, 128);
    // warp-uniform to ptxas: wgmma under a role branch it cannot prove
    // uniform would be serialised (note C7520)
    const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
    if (warp == 4) {  // the producer
        if ((threadIdx.x & 31) == 0 && n_kt > 0) {
            mbar_expect_tx(bQ, TILE);
            tma_rows<D>(sQ, &a.q, q0, bh, bQ);
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
    const float to_log2 = a.scale * FW_LOG2E;
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m_run[2] = {FW_NEG, FW_NEG}, l_run[2] = {0.f, 0.f};
    if (n_kt > 0) mbar_wait(bQ, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(bFull + 8 * s, (kt / STAGES) & 1);
        const uint32_t sK = sStage + 2 * s * TILE, sV = sK + TILE;
        float sc[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // S = Q K^T over the whole width
            wgmma_ss<0>(sc, sw128_desc(kslice(sQ, kk)), sw128_desc(kslice(sK, kk)), kk);
        wg_commit();
        wg_wait0();
        fence_regs(sc);
        const int rem = len - kt * 64;  // key kt * 64 + i is bit i
        const uint64_t bits = rem >= 64 ? ~0ull : (1ull << rem) - 1;
        float alpha[2];
        softmax_tile(sc, bits, t4, to_log2, m_run, l_run, alpha);
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
        uint32_t pa[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a(pa[kc], sc, kc);
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)  // O += P V (V N-major: 16 keys a step)
            wgmma_rs<1>(o, pa[kc], mn_desc<D>(sV + kc * 2048), 1);
        wg_commit();
        wg_wait0();
        fence_regs(o);
        mbar_arrive(bEmpty + 8 * s);
    }

    // quad-reduce l, normalise, write the rows (and the lse)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    const int row_lo = q0 + warp * 16 + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_lo + r * 8;
        if (row >= n) continue;
        const float inv = l_run[r] != 0.f ? 1.f / l_run[r] : 0.f;
        if (LSE && t4 == 0)
            a.lse[(size_t)bh * n + row] =
                l_run[r] > 0.f ? m_run[r] * a.scale + logf(l_run[r]) : FW_NEG;
        store_acc_row(a.out + ((size_t)bh * n + row) * a.d + t4 * 2, o, r, inv, a.d);
    }
}

template <int D>
__global__ void __launch_bounds__(FWN_NT, 1)
    flash_attn_native_kernel(const __grid_constant__ FwdNativeArgs a) {
    fwd_native<D, false>(a);
}
template <int D>
__global__ void __launch_bounds__(FWN_NT, 1)
    flash_attn_native_lse_kernel(const __grid_constant__ FwdNativeArgs a) {
    fwd_native<D, true>(a);
}

// ---------------------------------------------------------------------------
// K7 pair: HEAD + LENGTH at D = 384 and 512, the width over a cluster of two
// blocks
// ---------------------------------------------------------------------------

// The function of K7 at D = 384 and 512 as a cluster of two blocks on the
// same 64 q rows: block r owns O's columns [r D / 2, (r + 1) D / 2) and
// half r of the contraction, copying by TMA only its halves (its q half
// once, resident). No producer warp: two consumer warpgroups, warpgroup w
// taking the key tiles w, w + 2, ... through its own stage (the tile's K and
// V halves, copied by its thread 0), with its own O (128 f32 registers a
// thread at D = 512), m and l; the two merge at the end by (O, m, l). Each
// key tile costs one more step than the D = 256 kernel: the partial scores
// Q[:, r] K[:, r]^T go to the same warpgroup of the other block (`st.async`
// into that block's shared memory, counted on its barrier) and the other's
// come back, so both form S = S_0 + S_1 (the same bits: IEEE addition
// commutes), the same softmax, and O_r += P V[:, r]. The tensor work is the
// function's, a block's K / V copies are half a tile's, and the grid has two
// blocks a q tile (DiT d512's 2 heads at the 1024 bucket: 128 blocks for
// 132 SMs, where one block a q tile made 64). The partials go through two
// buffers a warpgroup by the tile's parity: a block writes the other's
// buffer of a parity again only after that block's next partial has reached
// it, which it sends after reading that buffer. Shared memory ~225 KB at D =
// 512 (the q half 32 KB, a 64 KB stage a warpgroup, the partials 4 x 16 KB),
// ~185 KB at 384; 216 registers a thread at 512 (218 the lse mode), 188 at
// 384, no spill. Measured in turns (`kernel_ab.py`, PERF.md §6): 1.11x
// faster at [2, 2, 1024 / 4224, 512] (1.15x at 384) than the same pair with
// one consumer warpgroup and a producer warp through two stages (itself
// 1.71x / 1.02x
// faster than one block a q tile whose two warpgroups split the width (the
// partials traded in its shared memory, one K and one V slot of 64 KB; its
// copies multicast to a cluster of two q tiles 5-12% faster than without);
// 32-key steps through two stages were slower still).
#define FWP_NT 256  // two consumer warpgroups
#define FWP_HTILE(D) ((D) / 128 * WG_TILE)  // a [64][D / 2] half tile
#define FWP_X_BYTES (128 * 32 * 4)          // a partial S: 32 f32 a thread
#define FWP_MERGE 1                         // the named barrier of the final merge
// shared plan: the q half, a stage of (K half, V half) a warpgroup, the
// partials' buffers ([warpgroup][parity]), the barriers (q, then full and
// empty a stage, then a partial's a (warpgroup, parity))
#define FWP_SMEM(D) (1024 + 5 * FWP_HTILE(D) + 4 * FWP_X_BYTES + 8 * (1 + 4 + 4))

struct FwdPairArgs {
    CUtensorMap q, k, v;  // [b * h][n][d] bf16, normed and roped q and k (`head_tensor_map`)
    const int* lengths;
    bf16* out;            // [b, h, n, d]
    float* lse;           // the LSE mode
    int n, heads, d;      // d <= D, a multiple of 8: the rows' width in place
    float scale;
};

template <int D, bool LSE>
__device__ __forceinline__ void fwd_pair(const FwdPairArgs& a) {
    constexpr int HALF = D / 2, HT = HALF / 64, HTILE = FWP_HTILE(D), NO = HALF / 2;
    const int n = a.n;
    const int r = cluster_rank();  // this block's column half
    const int q0 = (blockIdx.x >> 1) * 64, h = blockIdx.y, b = blockIdx.z;
    const int bh = b * a.heads + h;
    // keys < len are live; a q tile wholly past the length walks no key tile
    const int len = min(max(a.lengths[b], 0), n);
    const int n_kt = q0 < len ? (len + 63) / 64 : 0;
    const int hbox = min(max((a.d - r * HALF + 63) / 64, 0), HT);  // this half's boxes < d
    uint8_t* smem = align1024(fw_smem);
    const uint32_t sQ = smem_u32(smem), sStage = sQ + HTILE;
    float* sX = reinterpret_cast<float*>(smem + 5 * HTILE);  // [warpgroup][parity]
    const uint32_t bQ = smem_u32(sX) + 4 * FWP_X_BYTES, bFull = bQ + 8, bEmpty = bFull + 16,
                   bX = bEmpty + 16;
    zero_subtiles<FWP_NT>(smem, 5, HTILE, hbox, HT, WG_TILE);
    if (threadIdx.x == 0) {
        mbar_init(bQ, 1);
        for (int i = 0; i < 2; ++i) {
            mbar_init(bFull + 8 * i, 1);
            mbar_init(bEmpty + 8 * i, 128);
        }
        for (int i = 0; i < 4; ++i) mbar_init(bX + 8 * i, 1);
        mbar_init_fence();
    }
    cluster_sync();  // both blocks' barriers ready before any hand-over
    // warpgroup w takes the key tiles w, w + 2, ... through its own stage,
    // keeps its own O, m and l over them, and trades its partials with the
    // other block's warpgroup w; the two merge at the end. Warp-uniform to
    // ptxas: no wgmma below sits under a branch on it (note C7520)
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
    const int tid = threadIdx.x & 127, g = (tid & 31) >> 2, t4 = tid & 3;
    const uint32_t sK = sStage + 2 * wg * HTILE, sV = sK + HTILE;
    const uint32_t full = bFull + 8 * wg, empty = bEmpty + 8 * wg;
    // K and V halves of key tile kt into this warpgroup's stage (its thread 0)
    auto load_kv = [&](int kt) {
        mbar_expect_tx(full, 2 * hbox * WG_TILE);
        tma_boxes(sK, &a.k, kt * 64, bh, full, hbox, WG_TILE, r * HALF);
        tma_boxes(sV, &a.v, kt * 64, bh, full, hbox, WG_TILE, r * HALF);
    };
    if (tid == 0 && wg < n_kt) {
        if (wg == 0) {
            mbar_expect_tx(bQ, hbox * WG_TILE);
            tma_boxes(sQ, &a.q, q0, bh, bQ, hbox, WG_TILE, r * HALF);
        }
        load_kv(wg);
    }
    const float to_log2 = a.scale * FW_LOG2E;
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m_run[2] = {FW_NEG, FW_NEG}, l_run[2] = {0.f, 0.f};
    if (n_kt > 0) mbar_wait(bQ, 0);
    for (int kt = wg, i = 0; kt < n_kt; kt += 2, ++i) {
        const int xi = wg * 2 + (i & 1);  // this warpgroup's partial buffer of the tile
        mbar_wait(full, i & 1);
        float sc[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < HALF / 16; ++kk)  // this half's partial of S = Q K^T
            wgmma_ss<0>(sc, sw128_desc(kslice(sQ, kk)), sw128_desc(kslice(sK, kk)), kk);
        wg_commit();
        wg_wait0();
        fence_regs(sc);
        if (tid == 0) mbar_expect_tx(bX + 8 * xi, FWP_X_BYTES);  // the other's partial
        send_partial(sc, smem_u32(sX) + xi * FWP_X_BYTES, bX + 8 * xi, r ^ 1, tid);
        recv_partial(sc, sX + xi * (FWP_X_BYTES / 4), bX + 8 * xi, (i >> 1) & 1, tid);
        const int rem = len - kt * 64;  // key kt * 64 + j is bit j
        const uint64_t bits = rem >= 64 ? ~0ull : (1ull << rem) - 1;
        float alpha[2];
        softmax_tile(sc, bits, t4, to_log2, m_run, l_run, alpha);
#pragma unroll
        for (int j = 0; j < NO; ++j) o[j] *= alpha[(j >> 1) & 1];
        uint32_t pa[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a(pa[kc], sc, kc);
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)  // O_r += P V[:, r] (V N-major: 16 keys a step)
            wgmma_rs<1>(o, pa[kc], mn_desc<D>(sV + kc * 2048), 1);
        wg_commit();
        wg_wait0();
        fence_regs(o);
        mbar_arrive(empty);
        if (tid == 0 && kt + 2 < n_kt) {
            mbar_wait(empty, i & 1);
            load_kv(kt + 2);
        }
    }

    // merge: warpgroup 1 leaves its O (in its stage, free now), m and l (in
    // its partials' buffers); warpgroup 0 rescales both to the common max,
    // sums, quad-reduces l, normalises and writes this half's columns (and
    // the lse)
    float* spill = reinterpret_cast<float*>(smem + 3 * HTILE);  // warpgroup 1's stage
    float* sml = sX + 2 * (FWP_X_BYTES / 4);                    // its partials' buffers
    if (wg == 1) {
        // the async proxy's last reads of the stage before these stores
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
        for (int j = 0; j < NO; ++j) spill[j * 128 + tid] = o[j];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            sml[j * 128 + tid] = m_run[j];
            sml[(2 + j) * 128 + tid] = l_run[j];
        }
    }
    bar_sync(FWP_MERGE, FWP_NT);
    if (wg == 0) {
        float a0[2], a1[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const float m1 = sml[j * 128 + tid], m = fmaxf(m_run[j], m1);
            a0[j] = exp2f((m_run[j] - m) * to_log2);
            a1[j] = exp2f((m1 - m) * to_log2);
            m_run[j] = m;
            l_run[j] = l_run[j] * a0[j] + sml[(2 + j) * 128 + tid] * a1[j];
            l_run[j] += __shfl_xor_sync(0xffffffffu, l_run[j], 1);
            l_run[j] += __shfl_xor_sync(0xffffffffu, l_run[j], 2);
        }
#pragma unroll
        for (int j = 0; j < NO; ++j)
            o[j] = o[j] * a0[(j >> 1) & 1] + spill[j * 128 + tid] * a1[(j >> 1) & 1];
        const int row_lo = q0 + (tid >> 5) * 16 + g;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int row = row_lo + j * 8;
            if (row >= n) continue;
            const float inv = l_run[j] != 0.f ? 1.f / l_run[j] : 0.f;
            if (LSE && r == 0 && t4 == 0)
                a.lse[(size_t)bh * n + row] =
                    l_run[j] > 0.f ? m_run[j] * a.scale + logf(l_run[j]) : FW_NEG;
            store_acc_row(a.out + ((size_t)bh * n + row) * a.d + r * HALF + t4 * 2, o, j, inv,
                          a.d - r * HALF);
        }
    }
    cluster_sync();  // no block leaves while the other may still hand it a partial
}

template <int D>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(FWP_NT, 1)
    flash_attn_pair_kernel(const __grid_constant__ FwdPairArgs a) {
    fwd_pair<D, false>(a);
}
template <int D>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(FWP_NT, 1)
    flash_attn_pair_lse_kernel(const __grid_constant__ FwdPairArgs a) {
    fwd_pair<D, true>(a);
}

// ---------------------------------------------------------------------------
// Launch: (FLAT) prologue, then the main kernel, on the caller's stream
// ---------------------------------------------------------------------------

typedef void (*fwd_kernel_t)(const FwdArgs);
typedef void (*fwd_wide_kernel_t)(const FwdWideArgs);

// The prologue (null for HEAD) and main kernel of a mode at the head width d.
struct FwdKernels {
    fwd_kernel_t prologue, main;
};
#define FW_PICK(d, pro, main)                                                           \
    ((d) == 64    ? FwdKernels{pro<64>, main<64>}                                      \
     : (d) == 128 ? FwdKernels{pro<128>, main<128>}                                    \
                  : FwdKernels{nullptr, nullptr})
#define FW_PICK_HEAD(d, main)                                                           \
    ((d) == 64 ? FwdKernels{nullptr, main<64>}                                          \
     : (d) == 128 ? FwdKernels{nullptr, main<128>} : FwdKernels{nullptr, nullptr})

static int launch_fwd(FwdKernels k, const FwdArgs& a, int d, void* stream) {
    if (!k.main) return (int)cudaErrorInvalidValue;  // a head width of neither instantiation
    if (a.bsz <= 0 || a.n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (k.prologue) {
        const size_t threads = (size_t)a.bsz * a.n * a.heads * (d / 8);
        k.prologue<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(a);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const int smem = 1024 + FW_FIXED(d) + (a.kmask ? (a.n + 63) / 64 * 8 : 0);
    if (smem > FW_SMEM_MAX) return (int)cudaErrorInvalidValue;
    err = smem_limit_once((const void*)k.main, FW_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.n + 63) / 64, a.heads, a.bsz);
    k.main<<<grid, FW_NT, smem, s>>>(a);
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

// Every entry takes the head width (64 or 128; any other returns
// cudaErrorInvalidValue) after the head count.
extern "C" int f5_fused_qkv_rope_attn_bf16(const void* qkv, const void* cos_t,
                                           const void* sin_t, const void* lengths, void* out,
                                           void* k_rot, int b, int n, int heads, int head_dim,
                                           float sm_scale, void* stream) {
    return launch_fwd(FW_PICK(head_dim, fused_qkv_rope_attn_krot_kernel, fused_qkv_rope_attn_kernel),
                      flat_args(qkv, cos_t, sin_t, lengths, false, out, nullptr, k_rot, b, n,
                                heads, sm_scale),
                      head_dim, stream);
}

extern "C" int f5_fused_qkv_rope_attn_lse_bf16(const void* qkv, const void* cos_t,
                                               const void* sin_t, const void* lengths,
                                               void* out, void* lse, void* k_rot, int b, int n,
                                               int heads, int head_dim, float sm_scale,
                                               void* stream) {
    return launch_fwd(
        FW_PICK(head_dim, fused_qkv_rope_attn_krot_kernel, fused_qkv_rope_attn_lse_kernel),
        flat_args(qkv, cos_t, sin_t, lengths, false, out, lse, k_rot, b, n, heads, sm_scale),
        head_dim, stream);
}

extern "C" int f5_fused_qkv_rope_attn_bias_bf16(const void* qkv, const void* cos_t,
                                                const void* sin_t, const void* kmask, void* out,
                                                void* k_rot, int b, int n, int heads,
                                                int head_dim, float sm_scale, void* stream) {
    return launch_fwd(
        FW_PICK(head_dim, fused_qkv_rope_attn_bias_krot_kernel, fused_qkv_rope_attn_bias_kernel),
        flat_args(qkv, cos_t, sin_t, kmask, true, out, nullptr, k_rot, b, n, heads, sm_scale),
        head_dim, stream);
}

extern "C" int f5_fused_qkv_rope_attn_bias_lse_bf16(const void* qkv, const void* cos_t,
                                                    const void* sin_t, const void* kmask,
                                                    void* out, void* lse, void* k_rot, int b,
                                                    int n, int heads, int head_dim,
                                                    float sm_scale, void* stream) {
    return launch_fwd(FW_PICK(head_dim, fused_qkv_rope_attn_bias_krot_kernel,
                              fused_qkv_rope_attn_bias_lse_kernel),
                      flat_args(qkv, cos_t, sin_t, kmask, true, out, lse, k_rot, b, n, heads,
                                sm_scale),
                      head_dim, stream);
}

static FwdArgs head_args(const void* q, const void* k, const void* v, const void* mask,
                         bool kmask, void* out, void* lse, int b, int n, int heads, int d,
                         float scale) {
    FwdArgs a = {};
    a.q = (const bf16*)q;
    a.k = (const bf16*)k;
    a.v = (const bf16*)v;
    if (kmask) a.kmask = (const uint8_t*)mask;
    else a.lengths = (const int*)mask;
    a.out = (bf16*)out;
    a.lse = (float*)lse;
    a.bsz = b;
    a.n = n;
    a.heads = heads;
    a.d = d;
    a.scale = scale;
    return a;
}

// K7's slice mode: one launch, a block a (64 q rows, head x slice, batch).
static int launch_fwd_wide(fwd_wide_kernel_t kernel, const void* q, const void* k,
                           const void* v, const void* lengths, void* out, void* lse, int b,
                           int n, int heads, int d, float scale, void* stream) {
    if (d <= 128 || d % 8) return (int)cudaErrorInvalidValue;
    if (b <= 0 || n <= 0) return (int)cudaGetLastError();
    const FwdWideArgs a = {(const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths,
                           (bf16*)out, (float*)lse, b, n, heads, d, scale};
    cudaError_t err = smem_limit_once((const void*)kernel, FW_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n + 63) / 64, heads * ((d + FWW_SLICE - 1) / FWW_SLICE), b);
    kernel<<<grid, FW_NT, FWW_SMEM, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// K7's native wide kernels at D = 192 / 256 on rows of width d <= D: one
// launch, a block a (64 q rows, head, batch), the tensor maps made here.
template <int D>
static int launch_fwd_native(bool lse_mode, const void* q, const void* k, const void* v,
                             const void* lengths, void* out, void* lse, int b, int n, int heads,
                             int d, float scale, void* stream) {
    if (b <= 0 || n <= 0) return (int)cudaGetLastError();
    FwdNativeArgs a;
    cudaError_t err;
    if ((err = head_tensor_map(&a.q, q, b * heads, n, d)) != cudaSuccess ||
        (err = head_tensor_map(&a.k, k, b * heads, n, d)) != cudaSuccess ||
        (err = head_tensor_map(&a.v, v, b * heads, n, d)) != cudaSuccess)
        return (int)err;
    a.lengths = (const int*)lengths;
    a.out = (bf16*)out;
    a.lse = (float*)lse;
    a.n = n;
    a.heads = heads;
    a.d = d;
    a.scale = scale;
    void (*kernel)(FwdNativeArgs) =
        lse_mode ? flash_attn_native_lse_kernel<D> : flash_attn_native_kernel<D>;
    err = smem_limit_once((const void*)kernel, FW_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n + 63) / 64, heads, b);
    kernel<<<grid, FWN_NT, FWN_SMEM(D), (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// K7's pair kernels at D = 384 / 512 on rows of width d <= D: one launch,
// a cluster of two blocks a (64 q rows, head, batch).
template <int D>
static int launch_fwd_pair(bool lse_mode, const void* q, const void* k, const void* v,
                           const void* lengths, void* out, void* lse, int b, int n, int heads,
                           int d, float scale, void* stream) {
    if (b <= 0 || n <= 0) return (int)cudaGetLastError();
    FwdPairArgs a;
    cudaError_t err;
    if ((err = head_tensor_map(&a.q, q, b * heads, n, d)) != cudaSuccess ||
        (err = head_tensor_map(&a.k, k, b * heads, n, d)) != cudaSuccess ||
        (err = head_tensor_map(&a.v, v, b * heads, n, d)) != cudaSuccess)
        return (int)err;
    a.lengths = (const int*)lengths;
    a.out = (bf16*)out;
    a.lse = (float*)lse;
    a.n = n;
    a.heads = heads;
    a.d = d;
    a.scale = scale;
    void (*kernel)(FwdPairArgs) =
        lse_mode ? flash_attn_pair_lse_kernel<D> : flash_attn_pair_kernel<D>;
    err = smem_limit_once((const void*)kernel, FW_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(2 * ((n + 63) / 64), heads, b);
    kernel<<<grid, FWP_NT, FWP_SMEM(D), (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// K7 and its lse mode take any head width d % 8 == 0 and read and write the
// rows of [b, h, n, d] in place: d <= 128 the core at D = 64 / 128, d in
// (128, 256] the native wide kernels at D = 192 / 256, d in (256, 512] the
// pair kernels at D = 384 / 512, d > 512 the slice mode; any other d
// returns cudaErrorInvalidValue.
static int flash_fwd(bool lse_mode, const void* q, const void* k, const void* v,
                     const void* lengths, void* out, void* lse, int b, int n, int heads, int d,
                     float scale, void* stream) {
    const int D = head_tile_width(d);
    if (D == 512 || D == 384)
        return (D == 512 ? launch_fwd_pair<512> : launch_fwd_pair<384>)(
            lse_mode, q, k, v, lengths, out, lse, b, n, heads, d, scale, stream);
    if (D == 256 || D == 192)
        return (D == 256 ? launch_fwd_native<256> : launch_fwd_native<192>)(
            lse_mode, q, k, v, lengths, out, lse, b, n, heads, d, scale, stream);
    if (D == 0)
        return launch_fwd_wide(lse_mode ? flash_attn_wide_lse_kernel : flash_attn_wide_kernel, q,
                               k, v, lengths, out, lse, b, n, heads, d, scale, stream);
#define K7_PICK(main, narrow)                                                  \
    (D == 64 ? (narrow ? main<64, true> : main<64, false>)                     \
             : (narrow ? main<128, true> : main<128, false>))
    const FwdKernels kern = {nullptr, lse_mode ? K7_PICK(flash_attn_lse_kernel, d != D)
                                               : K7_PICK(flash_attn_kernel, d != D)};
#undef K7_PICK
    return launch_fwd(kern, head_args(q, k, v, lengths, false, out, lse, b, n, heads, d, scale),
                      D, stream);
}

extern "C" int f5_flash_attn_bf16(const void* q, const void* k, const void* v,
                                  const void* lengths, void* out, int b, int n, int heads,
                                  int head_dim, float sm_scale, void* stream) {
    return flash_fwd(false, q, k, v, lengths, out, nullptr, b, n, heads, head_dim, sm_scale,
                     stream);
}

extern "C" int f5_flash_attn_lse_bf16(const void* q, const void* k, const void* v,
                                      const void* lengths, void* out, void* lse, int b, int n,
                                      int heads, int head_dim, float sm_scale, void* stream) {
    return flash_fwd(true, q, k, v, lengths, out, lse, b, n, heads, head_dim, sm_scale, stream);
}

extern "C" int f5_masked_flash_attn_bf16(const void* q, const void* k, const void* v,
                                         const void* kmask, void* out, int b, int n, int heads,
                                         int head_dim, float sm_scale, void* stream) {
    return launch_fwd(FW_PICK_HEAD(head_dim, masked_flash_attn_kernel),
                      head_args(q, k, v, kmask, true, out, nullptr, b, n, heads, head_dim,
                                sm_scale),
                      head_dim, stream);
}
