// Attention backward kernels: K4 and its bias-row mode K8 (flat dQKV), and K9
// (head-layout dq/dk/dv from a saved row lse).
//
// K4: dQKV of K3 (fused QKV + interleaved RoPE + length-masked attention), flat layout.
// Replaces f5tts_tpu/ops/attention.py:886 _fused_qkv_bwd_kernel (n <= 1024) and
// :970 _fused_qkv_bwd_kernel_long (1024 < n <= 4096, launched from :1077) with one pair
// of kernels for every n (the tail tile included).
//
// In:  qkv [b, n, 3*h*64] bf16 (the forward's input), cos/sin [>=n, h*64] bf16,
//      lengths [b] int32, dO [b, n, h*64] bf16 (the incoming gradient).
// Out: dQKV [b, n, 3*h*64] bf16; scratch lse/delta [b, h, n] f32.
//
// What it computes, as the Pallas kernels do (attention.py:876-959): q and k are
// re-roped in f32 and rounded to bf16 (q NOT pre-scaled); s = q_rot k_rot^T *
// scale + key bias (-1e30 past the length); p = softmax(s) in f32; dp = dO v^T;
// delta = rowsum(p * dp); ds = p * (dp - delta); ds and p are rounded to bf16
// before dv = p^T dO, dk = ds^T q_rot and dq = ds k_rot (f32 accumulators);
// dq and dk are multiplied by the scale and un-roped (rope with -sin).
// Dead query rows (>= length) are K3's zero rows, so their exact gradient is 0
// for any dO: dO is read as 0 there (the Pallas kernels rely on the caller's
// mask instead). Dead keys get p = 0, so their dk and dv are exactly 0.
//
// K8: dQKV of K5 (the same attention under a [b, n] key mask, MMDiT's joint
// audio + text sequence). Replaces :1503 _fused_bias_bwd_kernel (joint n <= 1536,
// dispatch :1622-1641) and the bias-row branch of :970 _fused_qkv_bwd_kernel_long
// (1536 < n <= 4096), and covers every joint n past 4096 too, where the JAX
// package takes the XLA VJP of _bias_decomposed_ref: one function, one pair.
// It is K4's pair in its BIAS mode, with kmask [b, n] bool in place of lengths:
// - the key mask is a 0 / -1e30 row per 64-key tile in shared memory, and a
//   tile whose 64 keys are all dead is skipped (the barrier that ends the
//   previous tile is __syncthreads_or of the tile's flags, as in K5);
// - every query row is live (K5 computes every row; the caller masks dead rows
//   after to_out), so dO is read as it is, and the dk/dv kernel loops over all
//   q tiles.
//
// Bound: tensor-core operations, 10*h*64*sum(live query x key pairs) flops (5
// products) against ~(3 + 1 + 3)*b*n*h*64*2 bytes. Design (simple first;
// wgmma/TMA later):
//  - dq kernel, one 128-thread block per (64-row q tile, head, batch), each warp
//    16 rows with Q and dO as mma.sync A fragments in registers. Pass 1 over the
//    live 64-key tiles: the row max/sum and sum(exp(s - m) * dp) online, giving
//    lse and delta (written f32 [b, h, n] for the dk/dv kernel). Pass 2:
//    p = exp(s - lse), ds, dq += ds K (K's B fragments by ldmatrix.trans).
//  - dk/dv kernel, one block per (64-key tile, head, batch), each warp 16 keys
//    with K and V as A fragments: loops over the live q tiles computing s^T and
//    dp^T directly, dv += p^T dO and dk += ds^T Q in f32 registers.
// No atomics and no [n, n] tensor in device memory. Loads are synchronous.
// K4 and K8 are template instantiations with their own __global__ entries, so
// the profiler names them apart; K4's instantiation is the loop it always was.
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
// Bound and design as K4's, without RoPE and without pass 1 (the lse is saved):
//  - dq kernel per (64-row q tile, head, batch): skips a tile with no live row,
//    computes delta for its rows (written for the dk/dv kernel), then dq over
//    the key tiles up to the length;
//  - dk/dv kernel per (64-key tile, head, batch): over the q tiles that hold a
//    live row (a vote on their lse), s^T and dp^T computed transposed.
#include "common.cuh"

#define BW_T 64     // rows of a q tile and of a key tile
#define BW_LDS 72   // padded shared row (bf16): conflict-free fragment loads
#define BW_NEG -1e30f

// 64 rows x 64 lanes of q (sect 0) or k (sect 1) of head h, roped in f32, as bf16.
__device__ __forceinline__ void load_roped(bf16* dst, const bf16* qkvb, const bf16* cos_t,
                                           const bf16* sin_t, int r0, int n, int sect,
                                           int h, int hd, int tid) {
    const size_t row3 = (size_t)3 * hd;
    for (int i = tid; i < BW_T * 8; i += 128) {
        const int r = i >> 3, c = (i & 7) * 8;
        const int row = r0 + r;
        float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (row < n) {
            float cs[8], sn[8];
            unpack8(*reinterpret_cast<const uint4*>(qkvb + row * row3 + sect * hd + h * 64 + c), f);
            unpack8(*reinterpret_cast<const uint4*>(cos_t + (size_t)row * hd + h * 64 + c), cs);
            unpack8(*reinterpret_cast<const uint4*>(sin_t + (size_t)row * hd + h * 64 + c), sn);
            rope8(f, cs, sn);
        }
        *reinterpret_cast<uint4*>(dst + r * BW_LDS + c) = pack8(f);
    }
}

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

// Row and key liveness of the flat kernels: K4 a prefix length, K8 a key mask.
// K4 (BIAS false): rows and keys < len live. K8: every row < n live (len = n),
// keys where kmask is set.
template <bool BIAS>
__device__ __forceinline__ void attn_bwd_dq(
    const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
    const int* __restrict__ lengths, const uint8_t* __restrict__ kmask,
    const bf16* __restrict__ dout, bf16* __restrict__ dqkv, float* __restrict__ lse_out,
    float* __restrict__ delta_out, int n, int heads, float scale) {
    const int q0 = blockIdx.x * BW_T;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hd = heads * 64;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int len = BIAS ? n : min(max(lengths[b], 0), n);
    const uint8_t* km = BIAS ? kmask + (size_t)b * n : nullptr;
    const size_t row3 = (size_t)3 * hd;
    const bf16* qkvb = qkv + (size_t)b * n * row3;
    bf16* dqb = dqkv + (size_t)b * n * row3 + h * 64;

    if (!BIAS && q0 >= len) {  // dead q tile: dq = 0
        zero_rows(dqb, row3, q0, n, tid);
        return;
    }

    __shared__ __align__(16) bf16 sQ[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sO[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sK[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sV[BW_T * BW_LDS];
    __shared__ float sBias[BW_T];  // BIAS: this key tile's 0 / -1e30 row

    load_roped(sQ, qkvb, cos_t, sin_t, q0, n, 0, h, hd, tid);
    load_rows(sO, dout + (size_t)b * n * hd + h * 64, hd, q0, len, tid);
    __syncthreads();
    uint32_t qa[4][4], oa[4][4];
    load_a(qa, sQ, warp, g, t4);
    load_a(oa, sO, warp, g, t4);

    const int row_lo = q0 + warp * 16 + g;
    const int n_kt = (len + BW_T - 1) / BW_T;
    float s[8][4], dp[8][4];

    // Start a key tile: end the previous tile's shared reads, (BIAS: vote on
    // the tile's flags; false = all dead, skip it), load K and V.
    auto load_kv = [&](int k0) -> bool {
        if constexpr (BIAS) {
            const int key = k0 + tid;
            const bool live = tid < BW_T && key < n && km[key];
            if (!__syncthreads_or(live)) return false;
            if (tid < BW_T) sBias[tid] = live ? 0.f : BW_NEG;
        } else {
            __syncthreads();
        }
        load_roped(sK, qkvb, cos_t, sin_t, k0, n, 1, h, hd, tid);
        load_rows(sV, qkvb + 2 * hd + h * 64, row3, k0, n, tid);
        __syncthreads();
        return true;
    };
    auto key_live = [&](int k0, int nt, int e) -> bool {
        if constexpr (BIAS) return sBias[nt * 8 + t4 * 2 + (e & 1)] == 0.f;
        return k0 + nt * 8 + t4 * 2 + (e & 1) < len;
    };
    auto key_bias = [&](int k0, int nt, int e) -> float {
        if constexpr (BIAS) return sBias[nt * 8 + t4 * 2 + (e & 1)];
        return k0 + nt * 8 + t4 * 2 + (e & 1) < len ? 0.f : BW_NEG;
    };

    // pass 1: m, l and sum(exp(s - m) * dp) per row, online over the key tiles
    float m_run[2] = {BW_NEG, BW_NEG}, l_run[2] = {0.f, 0.f}, d_run[2] = {0.f, 0.f};
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BW_T;
        if (!load_kv(k0)) continue;
        mma_abt(s, qa, sK, g, t4);
        mma_abt(dp, oa, sV, g, t4);
        float mx[2] = {BW_NEG, BW_NEG};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[nt][e] = s[nt][e] * scale + key_bias(k0, nt, e);
                mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_run[r], mx[r]);
            const float alpha = __expf(m_run[r] - m_new);
            m_run[r] = m_new;
            l_run[r] *= alpha;
            d_run[r] *= alpha;
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float pe = __expf(s[nt][e] - m_run[e >> 1]);
                l_run[e >> 1] += pe;
                d_run[e >> 1] += pe * dp[nt][e];
            }
    }
    float lse[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        d_run[r] += __shfl_xor_sync(0xffffffffu, d_run[r], 1);
        d_run[r] += __shfl_xor_sync(0xffffffffu, d_run[r], 2);
        const int row = row_lo + r * 8;
        // l == 0 guard (as the Pallas kernel's): p = 0 for such a row
        lse[r] = l_run[r] > 0.f ? m_run[r] + logf(l_run[r]) : INFINITY;
        dlt[r] = (row < len && l_run[r] > 0.f) ? d_run[r] / l_run[r] : 0.f;
        if (t4 == 0 && row < n) {
            const size_t at = ((size_t)b * heads + h) * n + row;
            lse_out[at] = lse[r];
            delta_out[at] = dlt[r];
        }
    }

    // pass 2: ds = p * (dp - delta), dq += ds K
    float dq[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BW_T;
        if (!load_kv(k0)) continue;
        mma_abt(s, qa, sK, g, t4);
        mma_abt(dp, oa, sV, g, t4);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                const bool live = key_live(k0, nt, e) && row_lo + r * 8 < len;
                const float p = live ? __expf(s[nt][e] * scale - lse[r]) : 0.f;
                s[nt][e] = p * (dp[nt][e] - dlt[r]);
            }
        }
        mma_pt(dq, s, sK, lane);
    }
    store_rows(dqb, row3, dq, row_lo, n, h, hd, scale, true, cos_t, sin_t, t4);
}

template <bool BIAS>
__device__ __forceinline__ void attn_bwd_dkdv(
    const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
    const int* __restrict__ lengths, const uint8_t* __restrict__ kmask,
    const bf16* __restrict__ dout, const float* __restrict__ lse_in,
    const float* __restrict__ delta_in, bf16* __restrict__ dqkv, int n, int heads, float scale) {
    const int k0 = blockIdx.x * BW_T;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hd = heads * 64;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int len = BIAS ? n : min(max(lengths[b], 0), n);
    const uint8_t* km = BIAS ? kmask + (size_t)b * n : nullptr;
    const size_t row3 = (size_t)3 * hd;
    const bf16* qkvb = qkv + (size_t)b * n * row3;
    bf16* dkb = dqkv + (size_t)b * n * row3 + hd + h * 64;
    bf16* dvb = dkb + hd;

    bool dead_tile;
    if constexpr (BIAS)
        dead_tile = !__syncthreads_or(tid < BW_T && k0 + tid < n && km[k0 + tid]);
    else
        dead_tile = k0 >= len;
    if (dead_tile) {  // dead key tile: dk = dv = 0
        zero_rows(dkb, row3, k0, n, tid);
        zero_rows(dvb, row3, k0, n, tid);
        return;
    }

    __shared__ __align__(16) bf16 sQ[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sO[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sK[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sV[BW_T * BW_LDS];
    __shared__ float sL[BW_T], sD[BW_T];

    load_roped(sK, qkvb, cos_t, sin_t, k0, n, 1, h, hd, tid);
    load_rows(sV, qkvb + 2 * hd + h * 64, row3, k0, n, tid);
    __syncthreads();
    uint32_t ka[4][4], va[4][4];
    load_a(ka, sK, warp, g, t4);
    load_a(va, sV, warp, g, t4);

    const int key_lo = k0 + warp * 16 + g;
    bool key_live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int key = key_lo + r * 8;
        key_live[r] = BIAS ? (key < n && km[key]) : key < len;
    }
    const float* lseb = lse_in + ((size_t)b * heads + h) * n;
    const float* deltab = delta_in + ((size_t)b * heads + h) * n;
    float dk[8][4], dv[8][4], st[8][4], dpt[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
        dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
    }
    const int n_qt = (len + BW_T - 1) / BW_T;  // only live q tiles (K8: all)
    for (int qt = 0; qt < n_qt; ++qt) {
        const int q0 = qt * BW_T;
        __syncthreads();
        load_roped(sQ, qkvb, cos_t, sin_t, q0, n, 0, h, hd, tid);
        load_rows(sO, dout + (size_t)b * n * hd + h * 64, hd, q0, len, tid);
        if (tid < BW_T) {
            const int row = q0 + tid;
            sL[tid] = row < len ? lseb[row] : 0.f;
            sD[tid] = row < len ? deltab[row] : 0.f;
        }
        __syncthreads();
        mma_abt(st, ka, sQ, g, t4);   // s^T: this warp's 16 keys x 64 queries
        mma_abt(dpt, va, sO, g, t4);  // dp^T
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int ql = nt * 8 + t4 * 2;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qi = ql + (e & 1);
                const bool live = key_live[e >> 1] && q0 + qi < len;
                const float p = live ? __expf(st[nt][e] * scale - sL[qi]) : 0.f;
                st[nt][e] = p;
                dpt[nt][e] = p * (dpt[nt][e] - sD[qi]);
            }
        }
        mma_pt(dv, st, sO, lane);   // dv += p^T dO
        mma_pt(dk, dpt, sQ, lane);  // dk += ds^T q_rot
    }
    store_rows(dkb, row3, dk, key_lo, n, h, hd, scale, true, cos_t, sin_t, t4);
    store_rows(dvb, row3, dv, key_lo, n, h, hd, 1.f, false, cos_t, sin_t, t4);
}

// K4
__global__ void __launch_bounds__(128) attn_bwd_dq_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
    const int* __restrict__ lengths, const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
    float* __restrict__ lse_out, float* __restrict__ delta_out, int n, int heads, float scale) {
    attn_bwd_dq<false>(qkv, cos_t, sin_t, lengths, nullptr, dout, dqkv, lse_out, delta_out, n,
                       heads, scale);
}

__global__ void __launch_bounds__(128) attn_bwd_dkdv_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
    const int* __restrict__ lengths, const bf16* __restrict__ dout,
    const float* __restrict__ lse_in, const float* __restrict__ delta_in,
    bf16* __restrict__ dqkv, int n, int heads, float scale) {
    attn_bwd_dkdv<false>(qkv, cos_t, sin_t, lengths, nullptr, dout, lse_in, delta_in, dqkv, n,
                         heads, scale);
}

// K8
__global__ void __launch_bounds__(128) attn_bias_bwd_dq_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
    const uint8_t* __restrict__ kmask, const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
    float* __restrict__ lse_out, float* __restrict__ delta_out, int n, int heads, float scale) {
    attn_bwd_dq<true>(qkv, cos_t, sin_t, nullptr, kmask, dout, dqkv, lse_out, delta_out, n,
                      heads, scale);
}

__global__ void __launch_bounds__(128) attn_bias_bwd_dkdv_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
    const uint8_t* __restrict__ kmask, const bf16* __restrict__ dout,
    const float* __restrict__ lse_in, const float* __restrict__ delta_in,
    bf16* __restrict__ dqkv, int n, int heads, float scale) {
    attn_bwd_dkdv<true>(qkv, cos_t, sin_t, nullptr, kmask, dout, lse_in, delta_in, dqkv, n,
                        heads, scale);
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

// ---------------------------------------------------------------------------
// C entry points: each launches its pair on the caller's stream
// ---------------------------------------------------------------------------

extern "C" int f5_fused_qkv_rope_attn_bwd_bf16(const void* qkv, const void* cos_t,
                                               const void* sin_t, const void* lengths,
                                               const void* dout, void* dqkv, void* lse,
                                               void* delta, int b, int n, int heads,
                                               float scale, void* stream) {
    if (b > 0 && n > 0) {
        dim3 grid((n + BW_T - 1) / BW_T, heads, b);
        cudaStream_t s = (cudaStream_t)stream;
        attn_bwd_dq_kernel<<<grid, 128, 0, s>>>(
            (const bf16*)qkv, (const bf16*)cos_t, (const bf16*)sin_t, (const int*)lengths,
            (const bf16*)dout, (bf16*)dqkv, (float*)lse, (float*)delta, n, heads, scale);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        attn_bwd_dkdv_kernel<<<grid, 128, 0, s>>>(
            (const bf16*)qkv, (const bf16*)cos_t, (const bf16*)sin_t, (const int*)lengths,
            (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dqkv, n, heads,
            scale);
    }
    return (int)cudaGetLastError();
}

extern "C" int f5_fused_qkv_rope_attn_bias_bwd_bf16(const void* qkv, const void* cos_t,
                                                    const void* sin_t, const void* kmask,
                                                    const void* dout, void* dqkv, void* lse,
                                                    void* delta, int b, int n, int heads,
                                                    float scale, void* stream) {
    if (b > 0 && n > 0) {
        dim3 grid((n + BW_T - 1) / BW_T, heads, b);
        cudaStream_t s = (cudaStream_t)stream;
        attn_bias_bwd_dq_kernel<<<grid, 128, 0, s>>>(
            (const bf16*)qkv, (const bf16*)cos_t, (const bf16*)sin_t, (const uint8_t*)kmask,
            (const bf16*)dout, (bf16*)dqkv, (float*)lse, (float*)delta, n, heads, scale);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        attn_bias_bwd_dkdv_kernel<<<grid, 128, 0, s>>>(
            (const bf16*)qkv, (const bf16*)cos_t, (const bf16*)sin_t, (const uint8_t*)kmask,
            (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dqkv, n, heads,
            scale);
    }
    return (int)cudaGetLastError();
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
