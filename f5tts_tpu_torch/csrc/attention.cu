// Forward attention kernels: one wgmma core over a cp.async ring, in four
// modes (K3, K5, K7 and K11, with the lse modes of K3, K5 and K7).
//
// The core has two template axes:
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
// K7 (HEAD + LENGTH) flash_attn_kernel: head-layout prefix-length attention.
//    Replaces :123 _flash_kernel_single and :50 _flash_kernel (the Pallas
//    n <= 2048 / online-softmax split is a VMEM artefact; one loop here).
//    Out: [b, h, n, 64] bf16; q tiles wholly past the length are zeros, rows
//    past the length inside a live tile are computed (over the live keys), as
//    in Pallas. flash_attn_lse_kernel, its LSE mode under grad (the Pallas
//    bodies with their lse_ref, :115-120 and :161-164, behind :193
//    _flash_forward(return_lse)): also lse [b, h, n] f32 = m + log(l) over the
//    scaled scores, every row of a live q tile (K9 reads the rows past the
//    length too), -1e30 on the q tiles wholly past the length, for the
//    backward K9 (csrc/attention_bwd.cu).
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
//    (7,388 live keys, every query row) against ~89 MB (0.027 ms); K7 as K3
//    (0.0764 ms at n = 4224, lengths [4224, 777]).
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
#define FW_MINB 3
#define FW_LOG2E 1.4426950408889634f
#define FW_NEG -1e30f
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
    float m_run[2] = {FW_NEG, FW_NEG}, l_run[2] = {0.f, 0.f};
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
                if (!((kbits >> ((i >> 2) * 8 + (i & 1))) & 1)) sc[i] = FW_NEG;
        }
        float mx[2] = {FW_NEG, FW_NEG};
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
        if (LSE && t4 == 0)
            a.lse[bh * n + row] = l_run[r] > 0.f ? m_run[r] + logf(l_run[r]) : FW_NEG;
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

// K7
__global__ void __launch_bounds__(FW_NT, FW_MINB) flash_attn_kernel(const FwdArgs a) {
    wg_fwd<FW_HEAD, FW_LENGTH, false>(a);
}
__global__ void __launch_bounds__(FW_NT, FW_MINB) flash_attn_lse_kernel(const FwdArgs a) {
    wg_fwd<FW_HEAD, FW_LENGTH, true>(a);
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
    err = smem_limit_once((const void*)main_kernel, FW_SMEM_MAX);
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

static FwdArgs head_args(const void* q, const void* k, const void* v, const void* mask,
                         bool kmask, void* out, void* lse, int b, int n, int heads, float scale) {
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
    a.scale = scale;
    return a;
}

extern "C" int f5_flash_attn_bf16(const void* q, const void* k, const void* v,
                                  const void* lengths, void* out, int b, int n, int heads,
                                  float sm_scale, void* stream) {
    return launch_fwd(nullptr, flash_attn_kernel,
                      head_args(q, k, v, lengths, false, out, nullptr, b, n, heads, sm_scale),
                      stream);
}

extern "C" int f5_flash_attn_lse_bf16(const void* q, const void* k, const void* v,
                                      const void* lengths, void* out, void* lse, int b, int n,
                                      int heads, float sm_scale, void* stream) {
    return launch_fwd(nullptr, flash_attn_lse_kernel,
                      head_args(q, k, v, lengths, false, out, lse, b, n, heads, sm_scale),
                      stream);
}

extern "C" int f5_masked_flash_attn_bf16(const void* q, const void* k, const void* v,
                                         const void* kmask, void* out, int b, int n, int heads,
                                         float sm_scale, void* stream) {
    return launch_fwd(nullptr, masked_flash_attn_kernel,
                      head_args(q, k, v, kmask, true, out, nullptr, b, n, heads, sm_scale),
                      stream);
}
