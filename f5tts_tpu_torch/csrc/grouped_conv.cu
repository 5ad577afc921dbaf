// K10: the generic same-padded grouped conv1d + bias, and K2, the
// ConvPositionEmbedding conv, as two modes of one persistent wgmma pipeline.
//
// K10: the generic same-padded grouped conv1d + bias, any W = c / groups
// channels a group with W % 8 == 0, any k >= 1 (lead padding (k - 1) / 2, the
// rest trailing, even k too), any n: the Pallas body's whole range
// (supports_pallas_grouped_conv, grouped_conv.py:114-121).
// Replaces f5tts_tpu/ops/grouped_conv.py:27 _grouped_conv_kernel (+ its bias
// add, :80): the conv-position module of the dim-768 presets (48 channels a
// group) and of every width off K2's gate, whose mask and Mish stay PyTorch
// elementwise ops between two launches, as the JAX package leaves them to
// XLA. The epilogue adds the bias
// in f32 and rounds once to bf16 (the Pallas path rounds the conv, then adds
// a bf16 bias: at most one bf16 ulp apart). No length mask, no activation.
// Bound: tensor-core operations, 2 * k * W flops an output value (18.7 GFLOP,
// 0.0189 ms at [2, 4096, 768], 16 groups of 48, k = 31) against 12.6 MB of x
// and y (0.0038 ms).
// Design: a persistent block of GC_NWG warpgroups per (group, tile of NP
// output channels, part of the rows): it walks tiles of GC_NWG * 64 output
// rows (of every batch row), each warpgroup 64 of them, and is one wgmma
// product per (tap, 16 input channels): D[64 x NP] += X[rows + tap, 16]
// W[tap][16 x NP].
//  - W <= 128: one input chunk of WP channels (the width rounded up to 16,
//    zero lanes in x and the weights) and NP = WP. W > 128: input chunks of
//    WP = 64 channels, and the group's outputs in ceil(W / 128) tiles of NP
//    (at most 128, a multiple of 16) channels, a block each: the reduction
//    walks (input chunk, tap chunk) slices of the WIO weights.
//  - the weights reach shared memory by cp.async once a block when every
//    tap fits in one input chunk (142,848 bytes at W = 48, k = 31), else
//    through a two-slot ring of (input chunk, tap chunk) slices (W = 64 or
//    128 at k = 31, every W > 128), the next slice's copy overlapping this
//    one's products; the x rows of the next (tile, input chunk), with their
//    k - 1 halo rows, zero outside [0, n), are copied during this one's
//    products; one barrier a slice. Where that halo does not fit (k in the
//    hundreds), x takes the ring too: each slice copies the 64 * warpgroups
//    + tc - 1 rows its tc taps read (`x_step`), so the shared footprint is
//    bounded for any k.
//  - B is one tap's [W_in x W_out] slice of the WIO weights as it lies in
//    memory, N-major (no transpose), in wgmma's interleaved (unswizzled)
//    canonical layout: 128-byte core matrices of 8 input x 8 output channels,
//    one 16-byte copy a core-matrix row (96-byte weight rows do not fit a
//    128-byte swizzle).
//  - A is the x tile shifted down by the tap. The x tile lies as W / 8
//    planes of 8 channels, row after row (16 bytes a row), so rows tap ..
//    tap + 63 of a plane are whole 128-byte core matrices at any tap: the
//    tap's A is a K-major interleaved descriptor 16 * tap bytes into the tile
//    (in a row-major tile a one-row shift breaks the 8-row core matrices).
//    With both operands in shared memory a tile's k * WP / 16 products issue
//    as one wgmma group, and no register is written while it is in flight
//    (taking A from registers, ldmatrix at the shifted row, would write a
//    wgmma's input registers while a group is in flight: ptxas then
//    serialises every wgmma of the kernel, note C7513).
//
// K2: one same-padded grouped conv1d (64 channels a group, odd k <= 31) +
// bias + length mask + Mish per launch: the LENGTH + MISH mode of K10's
// pipeline below. Replaces f5tts_tpu/ops/grouped_conv.py:168 _cpe_kernel.
// The module is two launches with the intermediate activation rounded to
// bf16 in device memory between them, as the Pallas kernel rounds it
// (grouped_conv.py:180-184). The mode adds to K10's walk:
//  - the x-tile copy zero-fills rows at or past length[b] (the input mask),
//    as it zero-fills rows outside [0, n);
//  - the block walks only live tiles (first output row < length[b]),
//    counted from the lengths; it stores zeros over its share of the dead
//    tiles and issues no copy or product for them;
//  - the epilogue takes the accumulator + bias in f32, gives 0 at rows at or
//    past the length, applies Mish in f32 (softplus as jax.nn.softplus
//    computes it) and rounds once to bf16: the Pallas body's arithmetic.
// Bound: tensor-core operations. 2 convs * 2 * length * 64 * k * c flops
// (8.3 GFLOP at length 1024, c = 1024, k = 31: 0.0084 ms at 989 TFLOP/s)
// against ~6 MB of bytes. A group's 31 taps of 64 x 64 weights (253,952
// bytes) do not fit beside two x buffers, so each block computes
// GC_CPE_NP of the group's 64 output channels: 32 (m64n32k16 products, the
// group split over two blocks that read the same x tiles) keeps its taps
// resident (126,976 bytes); 64 streams them through K10's two-slot ring of
// tap chunks (11 taps a chunk, 3 chunks a tile). The split measured 7-22%
// faster than the ring (`scripts/kernel_ab.py --define GC_CPE_NP=64`), and
// copying the resident taps in four groups, the first tile's products
// starting as each lands, 1-3% slower than one group.
#include "wgmma.cuh"

__device__ __forceinline__ float mish_f32(float v) {
    // softplus as jax.nn.softplus computes it: max(v, 0) + log1p(exp(-|v|))
    const float sp = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
    return v * tanhf(sp);
}

// ---------------------------------------------------------------------------
// The pipeline: K10's mode, and K2's LENGTH + MISH mode
// ---------------------------------------------------------------------------

#ifndef GC_NWG
#define GC_NWG 2  // warpgroups a block (4 measured 0-4% faster at W = 48, for twice the x tiles)
#endif
#define GC_SMEM_MAX 232448  // the opt-in maximum of dynamic shared memory

// The tiling of one call, planned on the host.
struct GcPlan {
    int n, c, width, ksize;
    int row_tiles;  // tiles of a batch row: ceil(n / (64 * warpgroups))
    int tiles;      // b * row_tiles
    int ntiles;     // output-channel tiles of a group: blocks along y a group
    int n_ic;       // input chunks of WP channels: ceil(W / WP)
    int tc;         // taps a chunk of weights
    int chunks;     // tap chunks an input chunk: ceil(k / tc); 1 with n_ic 1: resident
    int x_step;     // 1: each slice copies its own x rows; 0: once a (tile, input chunk)
    int x_rows;     // rows of an x buffer: 64 * warpgroups + (x_step ? tc : k) - 1, rounded to 8
    int x_bytes;    // bytes of one x buffer: x_rows * WP * 2
    int b;          // batch rows (K2 counts its live tiles from their lengths)
};

// d[64 x N] += A[64 x 16] B[16 x N], A K-major and B N-major in shared
// memory; the accumulator layout of wgmma_ss, N / 8 column groups.
template <int N>
__device__ __forceinline__ void gc_wgmma(float (&d)[N / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void gc_wgmma<16>(float (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void gc_wgmma<32>(float (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void gc_wgmma<48>(float (&d)[24], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void gc_wgmma<64>(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void gc_wgmma<80>(float (&d)[40], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, %40, %41, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void gc_wgmma<96>(float (&d)[48], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void gc_wgmma<112>(float (&d)[56], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, %56, %57, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void gc_wgmma<128>(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
}

// An interleaved (unswizzled) operand descriptor: 128-byte core matrices of
// 8 rows of 16 bytes, `lbo` bytes apart along K, 128 along M or N. A K-major
// core matrix is 8 rows (M) of 8 K values, an N-major one 8 K rows of 8 N.
__device__ __forceinline__ uint64_t gc_desc(uint32_t addr, uint32_t lbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(128 >> 4) << 32);
}

// WP: the input channels of a chunk (W <= 128: the group's width rounded up
// to 16; else 64); NP: the output channels a block computes (WP, half of it
// where K2 splits a group over two blocks, or a tile of a group wider than
// 128); CPE: K2's LENGTH + MISH mode (lengths, dead tiles, Mish).
template <int WP, int NP, bool CPE>
__global__ void __launch_bounds__(GC_NWG * 128) grouped_conv1d_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ bias,
    const int* __restrict__ lengths, bf16* __restrict__ y, const GcPlan p) {
    constexpr int NT = GC_NWG * 128, BM = GC_NWG * 64;
    constexpr int KC = WP / 16;       // 16-deep slices of a tap
    constexpr int CM = WP / 8;        // 8-input-channel groups (core matrices along K)
    constexpr int CN = NP / 8;        // 8-output-channel groups (core matrices along N)
    constexpr int TAP = WP * NP * 2;  // bytes of one tap's weights
    constexpr int LBO = CN * 128;     // weights: bytes between 8-input-channel groups
    extern __shared__ __align__(16) uint8_t gc_smem[];
    uint8_t* smem = align1024(gc_smem);
    const uint32_t sX = smem_u32(smem);  // two x buffers, then the weight slots
    const uint32_t sW = sX + 2 * p.x_bytes;
    const uint32_t x_lbo = p.x_rows * 16;  // x: bytes between 8-channel planes

    const int gi = blockIdx.y / p.ntiles;
    const int co = (blockIdx.y % p.ntiles) * NP;  // this block's first output channel
    const int tid = threadIdx.x;
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int lead = (p.ksize - 1) / 2;
    const size_t cg = (size_t)gi * p.width;
    const bool resident = p.chunks == 1 && p.n_ic == 1;

    // K2: rows [0, seq_len(b)) of batch row b are live
    auto seq_len = [&](int bb) { return CPE ? min(max(lengths[bb], 0), p.n) : p.n; };
    // tile t of the walk -> its batch row and first output row: K10 walks
    // every tile, K2 only the live ones (those of batch row 0, then row 1, ...)
    auto locate = [&](int t, int& bb, int& r0) {
        if constexpr (CPE) {
            bb = 0;
            for (int lt; t >= (lt = (seq_len(bb) + BM - 1) / BM); ++bb) t -= lt;
            r0 = t * BM;
        } else {
            bb = t / p.row_tiles;
            r0 = (t - bb * p.row_tiles) * BM;
        }
    };
    // x rows [r0 - lead + roff, + x_rows) and input channels [ci * WP, + WP)
    // of a tile as CM planes of 8 channels, row after row (16 bytes a row):
    // rows tap .. tap + 63 of a plane are whole core matrices at any tap, so
    // a K-major descriptor starting 16 * tap bytes in is the tap's shifted A;
    // thread i copies row i % 8 of an 8-row group, 8 rows of 64 contiguous
    // bytes a warp. Rows outside [0, n) (K2: outside [0, length)) and
    // channels past the width are zero-filled.
    auto load_x = [&](int tile, int ci, int roff, int buf) {
        int bb, r0;
        locate(tile, bb, r0);
        r0 += roff - lead;
        const int lim = seq_len(bb);
        const bf16* xb = x + (size_t)bb * p.n * p.c + cg + ci * WP;
        const uint32_t dst = sX + buf * p.x_bytes;
        for (int i = tid; i < p.x_rows * CM; i += NT) {
            const int ch = (i >> 3) % CM, r = ((i >> 3) / CM) * 8 + (i & 7);
            const int row = r0 + r;
            const bool ok = row >= 0 && row < lim && ci * WP + ch * 8 < p.width;
            cp_async16(dst + ch * x_lbo + r * 16, xb + (ok ? (size_t)row * p.c + ch * 8 : 0), ok);
        }
    };
    // the taps of one slice: byte 16 * i of a slot is input channel i % 8 of
    // core matrix (i / 8) % (CM * CN) of tap i / (8 * CM * CN), that is 8
    // output channels of w[tap, ci * WP + in, cg + co + ...]; zero lanes past
    // the width
    auto load_w = [&](int ci, int chunk, int slot) {
        const int t0 = chunk * p.tc, taps = min(p.tc, p.ksize - t0);
        const uint32_t dst = sW + slot * p.tc * TAP;
        for (int i = tid; i < taps * CM * CN * 8; i += NT) {
            const int r8 = i & 7, cm = (i >> 3) % (CM * CN), tap = (i >> 3) / (CM * CN);
            const int in = ci * WP + (cm / CN) * 8 + r8, out = co + (cm % CN) * 8;
            const bool ok = in < p.width && out < p.width;
            cp_async16(dst + i * 16,
                       w + (ok ? ((size_t)(t0 + tap) * p.width + in) * p.c + cg + out : 0), ok);
        }
    };

    // this block's tiles of the walk: blockIdx.x, + gridDim.x, ... (K10: the
    // host launches no more blocks than tiles, so every block has one; a K2
    // block past the live tiles has none). The first weights do not depend
    // on the lengths, so K2 starts their copy before it reads them.
    if constexpr (CPE) load_w(0, 0, 0);
    int walk = p.tiles;
    if constexpr (CPE) {
        walk = 0;
        for (int bb = 0; bb < p.b; ++bb) walk += (seq_len(bb) + BM - 1) / BM;
    }
    const int my_tiles = blockIdx.x < walk ? (walk - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
    const int steps = my_tiles * p.n_ic * p.chunks;  // slices
    if (steps > 0) {
        if constexpr (!CPE) load_w(0, 0, 0);
        load_x(blockIdx.x, 0, 0, 0);
    }
    cp_async_commit();
    if constexpr (CPE) {
        // zeros over this block's share of the dead tiles (mish(0) = 0), while
        // the first copies are in flight
        for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
            const int bb = t / p.row_tiles, r0 = (t - bb * p.row_tiles) * BM;
            if (r0 < seq_len(bb)) continue;
            bf16* yb = y + (size_t)bb * p.n * p.c + cg + co;
            for (int i = tid; i < BM * CN; i += NT) {
                const int row = r0 + i / CN;
                if (row < p.n)
                    *reinterpret_cast<uint4*>(yb + (size_t)row * p.c + (i % CN) * 8) =
                        make_uint4(0, 0, 0, 0);
            }
        }
    }

    // the walk's slices in order: tile jt of this block, input chunk ci, tap
    // chunk `chunk`; x buffer xb (one a (tile, input chunk), or one a slice)
    float acc[NP / 2];
    int jt = 0, ci = 0, chunk = 0, xb = 0;
    for (int s = 0; s < steps; ++s) {
        int jn = jt, cn = ci, hn = chunk + 1;  // the next slice
        if (hn == p.chunks) {
            hn = 0;
            if (++cn == p.n_ic) cn = 0, ++jn;
        }
        const bool x_next = p.x_step || hn == 0;  // the next slice starts its own x
        const int tile = blockIdx.x + jt * gridDim.x;
        cp_async_wait_all();
        __syncthreads();  // this slice's x and weights landed; the other buffers are free
        if (s + 1 < steps) {
            if (x_next)
                load_x(blockIdx.x + jn * gridDim.x, cn, p.x_step ? hn * p.tc : 0, xb ^ 1);
            if (!resident) load_w(cn, hn, (s + 1) & 1);
        }
        cp_async_commit();
        if (ci == 0 && chunk == 0) {
#pragma unroll
            for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
        }
        // this warpgroup's 64 rows: A of tap t starts at row 64 * wg + t (of
        // the buffer's first tap when each slice copies its own rows)
        const int t0 = chunk * p.tc, t1 = min(p.ksize, t0 + p.tc);
        const uint32_t xa = sX + xb * p.x_bytes + wg * 64 * 16 - (p.x_step ? t0 * 16 : 0);
        const uint32_t ws = sW + (resident ? 0 : (s & 1) * p.tc * TAP) - t0 * TAP;
        // the slice's taps * KC products as one wgmma group
        wg_fence();
        for (int tap = t0; tap < t1; ++tap) {
#pragma unroll
            for (int kc = 0; kc < KC; ++kc)
                gc_wgmma<NP>(acc, gc_desc(xa + tap * 16 + kc * 2 * x_lbo, x_lbo),
                             gc_desc(ws + tap * TAP + kc * 2 * LBO, LBO));
        }
        wg_commit();
        wg_wait0();
        fence_regs(acc);
        const bool last = ci + 1 == p.n_ic && chunk + 1 == p.chunks;
        jt = jn, ci = cn, chunk = hn, xb ^= x_next;
        if (!last) continue;

        // epilogue: + bias in f32 (K2: 0 past the length, else Mish), rounded
        // once; rows < n, lanes < width
        int bb, row0;
        locate(tile, bb, row0);
        row0 += wg * 64 + warp * 16 + g;
        const int len = seq_len(bb);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = row0 + r * 8;
            if (row >= p.n) continue;
            bf16* yr = y + ((size_t)bb * p.n + row) * p.c + cg + co + t4 * 2;
#pragma unroll
            for (int i = 0; i < CN; ++i) {
                const int col = co + i * 8 + t4 * 2;
                if (co + i * 8 >= p.width) break;
                float v0 = acc[4 * i + 2 * r] + __bfloat162float(bias[cg + col]);
                float v1 = acc[4 * i + 2 * r + 1] + __bfloat162float(bias[cg + col + 1]);
                if constexpr (CPE) {
                    v0 = row < len ? mish_f32(v0) : 0.f;
                    v1 = row < len ? mish_f32(v1) : 0.f;
                }
                *reinterpret_cast<uint32_t*>(yr + i * 8) = pack_bf16x2(v0, v1);
            }
        }
    }
    if constexpr (CPE) cp_async_wait_all();  // a block without live tiles drains its weight copy
}

// Plan the call (resident weights where they fit, else the ring of slices,
// x in the ring too where its whole halo does not fit), size the grid to the
// blocks the card holds at once, and launch.
template <int WP, int NP, bool CPE>
static int launch_grouped_conv1d(const bf16* x, const bf16* w, const bf16* bias,
                                 const int* lengths, bf16* y, int b, int n, int c, int width,
                                 int ksize, int ntiles, cudaStream_t stream) {
    constexpr int BM = GC_NWG * 64, TAP = WP * NP * 2;
    auto x_bytes = [](int taps) { return (BM + taps - 1 + 7) / 8 * 8 * WP * 2; };
    GcPlan p;
    p.n = n;
    p.c = c;
    p.width = width;
    p.ksize = ksize;
    p.b = b;
    p.row_tiles = (n + BM - 1) / BM;
    p.tiles = b * p.row_tiles;
    p.ntiles = ntiles;
    p.n_ic = (width + WP - 1) / WP;
    p.x_step = 0;
    const int fixed = 1024 + 2 * x_bytes(ksize);
    if (p.n_ic == 1 && fixed + ksize * TAP <= GC_SMEM_MAX) {
        p.tc = ksize;
        p.chunks = 1;
    } else if (fixed + 2 * TAP <= GC_SMEM_MAX) {
        p.tc = std::min(ksize, (GC_SMEM_MAX - fixed) / (2 * TAP));
        p.chunks = (ksize + p.tc - 1) / p.tc;
    } else {  // x in the ring: each slice's x buffer holds 64 * warpgroups + tc - 1 rows
        p.x_step = 1;
        p.tc = std::min(ksize, (GC_SMEM_MAX - 1024 - 2 * x_bytes(8)) / (2 * TAP + 4 * WP));
        while (p.tc > 1 && 1024 + 2 * x_bytes(p.tc) + 2 * p.tc * TAP > GC_SMEM_MAX) --p.tc;
        p.chunks = (ksize + p.tc - 1) / p.tc;
    }
    p.x_rows = (BM + (p.x_step ? p.tc : ksize) - 1 + 7) / 8 * 8;
    p.x_bytes = p.x_rows * WP * 2;
    const bool weights_resident = p.chunks == 1 && p.n_ic == 1;
    const int smem = 1024 + 2 * p.x_bytes + (weights_resident ? 1 : 2) * p.tc * TAP;
    if (smem > GC_SMEM_MAX) return (int)cudaErrorInvalidValue;
    const void* kernel = (const void*)grouped_conv1d_kernel<WP, NP, CPE>;
    cudaError_t err = smem_limit_once(kernel, GC_SMEM_MAX);
    int resident = 0;
    if (err == cudaSuccess) err = resident_blocks(kernel, GC_NWG * 128, smem, &resident);
    if (err != cudaSuccess) return (int)err;
    const int blocks_y = c / width * ntiles;
    const int parts = max(1, min(p.tiles, resident / blocks_y));
    grouped_conv1d_kernel<WP, NP, CPE>
        <<<dim3(parts, blocks_y), GC_NWG * 128, smem, stream>>>(x, w, bias, lengths, y, p);
    return (int)cudaGetLastError();
}

extern "C" int f5_grouped_conv1d_bf16(const void* x, const void* w, const void* bias, void* y,
                                      int b, int n, int c, int width, int ksize, void* stream) {
    if (width <= 0 || width % 8 || c % width || ksize < 1) return (int)cudaErrorInvalidValue;
    if (b <= 0 || n <= 0) return (int)cudaGetLastError();
    const bf16 *xp = (const bf16*)x, *wp = (const bf16*)w, *bp = (const bf16*)bias;
    bf16* yp = (bf16*)y;
    cudaStream_t s = (cudaStream_t)stream;
    if (width <= 128) {  // one input chunk, one output tile: the width rounded up to 16
#define GC_CASE(WP) \
    case WP: return launch_grouped_conv1d<WP, WP, false>(xp, wp, bp, nullptr, yp, b, n, c, width, ksize, 1, s)
        switch ((width + 15) / 16 * 16) {
            GC_CASE(16);
            GC_CASE(32);
            GC_CASE(48);
            GC_CASE(64);
            GC_CASE(80);
            GC_CASE(96);
            GC_CASE(112);
            default: return launch_grouped_conv1d<128, 128, false>(xp, wp, bp, nullptr, yp, b, n, c, width, ksize, 1, s);
        }
#undef GC_CASE
    }
    // wider groups: input chunks of 64 channels, the outputs in ceil(W / 128)
    // tiles of np channels (a multiple of 16, at most 128)
    const int parts = (width + 127) / 128;
    const int np = ((width + parts - 1) / parts + 15) / 16 * 16;
    const int ntiles = (width + np - 1) / np;
#define GC_WIDE(NP) \
    case NP: return launch_grouped_conv1d<64, NP, false>(xp, wp, bp, nullptr, yp, b, n, c, width, ksize, ntiles, s)
    switch (np) {
        GC_WIDE(80);
        GC_WIDE(96);
        GC_WIDE(112);
        default: return launch_grouped_conv1d<64, 128, false>(xp, wp, bp, nullptr, yp, b, n, c, width, ksize, ntiles, s);
    }
#undef GC_WIDE
}

// ---------------------------------------------------------------------------
// K2: the LENGTH + MISH mode, 64 channels a group
// ---------------------------------------------------------------------------

#ifndef GC_CPE_NP
#define GC_CPE_NP 32  // output channels a block: 32 keeps the taps resident, 64 takes the ring
#endif

// y = mish(mask(conv(mask(x)) + bias)), rows >= lengths[b] of y zero.
extern "C" int f5_conv_mish_bf16(const void* x, const void* w, const void* bias,
                                 const void* lengths, void* y, int b, int n, int c, int ksize,
                                 void* stream) {
    if (c % 64 || ksize < 1 || ksize > 31 || ksize % 2 == 0) return (int)cudaErrorInvalidValue;
    if (b <= 0 || n <= 0) return (int)cudaGetLastError();
    return launch_grouped_conv1d<64, GC_CPE_NP, true>(
        (const bf16*)x, (const bf16*)w, (const bf16*)bias, (const int*)lengths, (bf16*)y, b, n, c,
        64, ksize, 64 / GC_CPE_NP, (cudaStream_t)stream);
}
