// The bf16 route of the flash-attention forward: wgmma tensor cores, bf16
// tiles in shared memory filled by TMA, one producer warp and two consumer
// warpgroups (sm_90a). Included by flash_attention.cu, which holds the
// float32 route and the C entry.
//
//     o = softmax(scale · q kᵀ + mask) v      (per batch b and q head h,
//                                              kv head h / G for GQA)
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, body _flash_kernel) for bf16 operands.
//
// Design:
//   * one block of 384 threads per (128-row q tile, q head, batch); grid
//     (H, B, q tiles) with the q tiles last-first, so every head's longest
//     causal rows are issued before any short ones; the TPU's sequential kv
//     grid axis is a loop over the kv tiles of BKV rows that the tile's mask
//     can reach (a tile holding a row that no key reaches visits them all);
//     BKV is 128 up to hd 128 and 64 at hd 192 and 256, where the q tile
//     and two stages of 128-row K and V tiles (240 and 320 KB) would not fit
//     the 227 KB a block may use (Tile::SMEM: 144 and 192 KB with 64 rows);
//   * warpgroup 0 is the producer: after `setmaxnreg` drops it to 24
//     registers, one thread issues TMA copies (cp.async.bulk.tensor.4d) of
//     the q tile once and of each K and V tile into a ring of 2 stages, each
//     completing on an mbarrier; the consumers release a stage on an empty
//     mbarrier once their P·V product has read it;
//   * every tensor map is 4-D (hd, L, heads, batch) over the operand's own
//     strides, so the transposed (B, L, H, hd) views that ops.attention
//     passes go in without a copy; TMA zero-fills rows past L; shared tiles
//     carry TMA's 128/64/32-byte swizzle (one row of hd, at most 64 columns
//     per swizzled sub-tile: 3 and 4 sub-tiles for the 384- and 512-byte
//     rows of hd 192 and 256) that the wgmma descriptors name;
//   * warpgroups 1 and 2 (240 registers each) own 64 q rows each:
//     S = Q·Kᵀ is wgmma m64n{BKV}k16 with both operands K-major in shared
//     memory; P stays in registers in the S accumulator's fragment layout,
//     which is the register layout of wgmma's A operand, and O += P·V is
//     wgmma m64n{hd}k16 with V MN-major (the descriptor's transpose bit);
//     at hd 256 a consumer thread holds o (128 floats), S (32) and the
//     split P (32 registers), within its 240 (the build prints ptxas's
//     spills);
//   * numerics of the plain version: the online softmax in float32 in the
//     log2 domain (scale · log2 e folded into exp2), row max and sum reduced
//     over the quad of lanes that shares a row; the finite NEG_INF = −1e30,
//     so a row fully masked within a tile gets p = 1 there and recovers
//     (corr = 0) at its first real key; keys past Lkv get p = 0; output
//     acc / max(l, 1e-30) rounded once. P·V uses P split into two bf16
//     terms, P_hi = bf16(P) and P_lo = bf16(P − P_hi): one rounding of P to
//     bf16 puts 0.4–3.6% of the outputs more than one bf16 ulp off the
//     plain value, the split none (tests/test_torch_flash_attention.py
//     emulates this loop);
//   * only tiles that cross the causal diagonal, a window edge or Lkv pay
//     for the mask; the others take a path without index arithmetic.
//
// What bounds it: at the serving prefill (q (4, 3072, 32, 64), k/v (4, 3072,
// 8, 64), causal) the attention needs 1.55e11 FLOP, 0.156 ms at 989
// TFLOP/s; this kernel issues 1.5× that on the tensor cores (Q·Kᵀ once, P·V
// twice for the split P), and computes whole 128-key diagonal tiles. Its
// softmax (exp2, max, sums, bf16 conversions) runs on the CUDA cores
// between the two products of a warpgroup; the two consumer warpgroups
// overlap one's softmax with the other's products. (Issuing tile i's Q·Kᵀ
// ahead of tile i − 1's P·V inside a warpgroup, as FA3 does, measured
// slower at this shape; PERF.md, Findings.)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash_bf16 {

constexpr int BQ = 128;      // q rows per block: 64 per consumer warpgroup
constexpr int STAGES = 2;    // K/V ring
constexpr int THREADS = 384; // warpgroup 0 producer, 1 and 2 consumers
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory layout of a (rows, HD) bf16 tile: SUB column sub-tiles of
// SW bytes per row, each (rows, SW) with TMA's SW-byte swizzle; BKV kv rows
// per tile.
template <int HD> struct Tile {
    static constexpr int BKV = HD > 128 ? 64 : 128;
    static constexpr int SW = HD * 2 < 128 ? HD * 2 : 128;
    static constexpr int SUB = HD * 2 / SW;
    static constexpr int BOX = SW / 2;  // TMA box width in elements
    static constexpr uint32_t MODE = SW == 128 ? 1 : SW == 64 ? 2 : 3;  // descriptor swizzle
    static constexpr int Q_BYTES = BQ * HD * 2;
    static constexpr int KV_BYTES = BKV * HD * 2;
    static constexpr int BAR_OFFSET = Q_BYTES + 2 * STAGES * KV_BYTES;
    static constexpr size_t SMEM = BAR_OFFSET + (1 + 3 * STAGES) * 8 + 1024;  // + alignment
};

struct Params {
    void* o;
    long long so_b, so_h, so_l;  // output strides (elements)
    int G, Lq, Lkv;
    int causal;
    int window;  // <= 0: no sliding window
    float scale_log2;
};

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {  // a in the low half
    __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t desc_v) {
    if constexpr (HD == 16) hopper::wgmma_rs_n16(o, a, desc_v);
    else if constexpr (HD == 32) hopper::wgmma_rs_n32(o, a, desc_v);
    else if constexpr (HD == 64) hopper::wgmma_rs_n64(o, a, desc_v);
    else if constexpr (HD == 128) hopper::wgmma_rs_n128(o, a, desc_v);
    else if constexpr (HD == 192) hopper::wgmma_rs_n192(o, a, desc_v);
    else hopper::wgmma_rs_n256(o, a, desc_v);
}

// S (+)= Q·Kᵀ for one 16-wide slice of hd: m64n{BKV}k16, both from shared memory.
template <int BKV>
__device__ __forceinline__ void wgmma_qk(float* s, uint64_t desc_q, uint64_t desc_k, int acc) {
    if constexpr (BKV == 64) hopper::wgmma_ss_n64(s, desc_q, desc_k, acc);
    else hopper::wgmma_ss_n128(s, desc_q, desc_k, acc);
}

// Online softmax of one S tile held in the m64n{BKV} accumulator layout:
// element i of a thread is row r[(i >> 1) & 1], key k0 + 8 (i / 4) +
// 2 (lane % 4) + (i & 1). Turns s into P split into packed bf16 pairs
// (p_hi, p_lo: pair j holds elements 2j, 2j + 1), and updates m, l and the
// per-row corrections. MASK: apply the causal/window masks and Lkv.
template <int BKV, bool MASK>
__device__ __forceinline__ void softmax_tile(float* s, uint32_t* p_hi, uint32_t* p_lo, float* m,
                                             float* l, float* corr, const Params& p,
                                             const int* row, int k0, int lane) {
    float t[2];
    if (MASK) {
        t[0] = t[1] = -INFINITY;
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
            const int r = row[(i >> 1) & 1];
            const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
            bool ok = true;
            if (p.causal) ok = ok && kpos <= r;
            if (p.window > 0) ok = ok && kpos > r - p.window;
            float x = ok ? s[i] * p.scale_log2 : NEG_INF;
            if (kpos >= p.Lkv) x = -INFINITY;  // p = 0, and out of the max
            s[i] = x;
            t[(i >> 1) & 1] = fmaxf(t[(i >> 1) & 1], x);
        }
    } else {
        t[0] = t[1] = -INFINITY;
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) t[(i >> 1) & 1] = fmaxf(t[(i >> 1) & 1], s[i]);
        t[0] *= p.scale_log2;
        t[1] *= p.scale_log2;
    }
    float m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m[r], quad_max(t[r]));
        corr[r] = ex2(m[r] - m_new[r]);
        m[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < BKV / 4; ++j) {
        const int r = j & 1;
        float a, b;
        if (MASK) {
            a = ex2(s[2 * j] - m_new[r]);
            b = ex2(s[2 * j + 1] - m_new[r]);
        } else {
            a = ex2(fmaf(s[2 * j], p.scale_log2, -m_new[r]));
            b = ex2(fmaf(s[2 * j + 1], p.scale_log2, -m_new[r]));
        }
        rs[r] += a + b;
        const uint32_t hi = p_hi[j] = pack_bf16(a, b);
        p_lo[j] = pack_bf16(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xffff0000u));
    }
    l[0] = l[0] * corr[0] + rs[0];  // this thread's keys; the quad is summed at the end
    l[1] = l[1] * corr[1] + rs[1];
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                                     __grid_constant__ const CUtensorMap tk,
                                     __grid_constant__ const CUtensorMap tv, const Params p) {
    using T = Tile<HD>;
    constexpr int SW = T::SW;
    constexpr int BKV = T::BKV;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
    uint8_t* Qs = smem;
    uint8_t* Ks = Qs + T::Q_BYTES;
    uint8_t* Vs = Ks + STAGES * T::KV_BYTES;
    uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFFSET);
    uint64_t* k_full = q_full + 1;
    uint64_t* v_full = k_full + STAGES;
    uint64_t* kv_empty = v_full + STAGES;

    const int h = blockIdx.x, b = blockIdx.y, hk = h / p.G;
    const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // last tile first

    // the kv tiles this q tile's mask can reach; a tile holding a row that
    // no key reaches (a window with Lq >= Lkv + window) visits them all
    const int n_kv = (p.Lkv + BKV - 1) / BKV;
    const int q_last = min(q0 + BQ, p.Lq) - 1;
    const bool keyless_row = p.window > 0 && q_last >= p.Lkv + p.window - 1;
    const int hi = p.causal && !keyless_row ? min(q_last / BKV + 1, n_kv) : n_kv;
    const int lo = p.window > 0 && !keyless_row ? max(q0 - p.window + 1, 0) / BKV : 0;

    if (threadIdx.x == 0) {
        hopper::mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            hopper::mbar_init(k_full + s, 1);
            hopper::mbar_init(v_full + s, 1);
            hopper::mbar_init(kv_empty + s, 2 * 128);  // every consumer thread
        }
        hopper::fence_mbar_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
        // ---- producer: one thread issues every copy ----
        hopper::reg_dealloc<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            hopper::prefetch_tensor_map(&tq);
            hopper::prefetch_tensor_map(&tk);
            hopper::prefetch_tensor_map(&tv);
            hopper::mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
            for (int c = 0; c < T::SUB; ++c)
                hopper::tma_load_4d(Qs + c * BQ * SW, &tq, q_full, c * T::BOX, q0, h, b);
            for (int kt = lo, i = 0; kt < hi; ++kt, ++i) {
                const int s = i % STAGES;
                hopper::mbar_wait(kv_empty + s, ((i / STAGES) & 1) ^ 1);
                uint8_t* kd = Ks + s * T::KV_BYTES;
                uint8_t* vd = Vs + s * T::KV_BYTES;
                hopper::mbar_expect_tx(k_full + s, T::KV_BYTES);
#pragma unroll
                for (int c = 0; c < T::SUB; ++c)
                    hopper::tma_load_4d(kd + c * BKV * SW, &tk, k_full + s, c * T::BOX, kt * BKV,
                                        hk, b);
                hopper::mbar_expect_tx(v_full + s, T::KV_BYTES);
#pragma unroll
                for (int c = 0; c < T::SUB; ++c)
                    hopper::tma_load_4d(vd + c * BKV * SW, &tv, v_full + s, c * T::BOX, kt * BKV,
                                        hk, b);
            }
        }
    } else {
        // ---- consumers: 64 q rows per warpgroup ----
        hopper::reg_alloc<CONSUMER_REGS>();
        const int w = wg - 1;
        const int tid = threadIdx.x - 128 * wg;
        const int warp = tid / 32, lane = tid % 32;
        const int qa = q0 + 64 * w;  // the warpgroup's first row
        const int row[2] = {qa + 16 * warp + lane / 4, qa + 16 * warp + lane / 4 + 8};
        const uint32_t q_base = hopper::smem_addr(Qs) + 64 * w * SW;
        constexpr uint32_t SBO = 8 * SW / 16;  // 8-row groups, 16-byte units

        float o[HD / 2];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
        float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

        hopper::mbar_wait(q_full, 0);
        for (int kt = lo, i = 0; kt < hi; ++kt, ++i) {
            const int s = i % STAGES;
            const uint32_t phase = (i / STAGES) & 1;
            const int k0 = kt * BKV;

            // S = Q·Kᵀ: (64, hd) x (hd, BKV), both K-major
            float sc[BKV / 2];
            const uint32_t k_base = hopper::smem_addr(Ks + s * T::KV_BYTES);
            hopper::mbar_wait(k_full + s, phase);
            hopper::fence_regs<BKV / 2>(sc);
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t off_q = (kk * 32 / SW) * BQ * SW + (kk * 32) % SW;
                const uint32_t off_k = (kk * 32 / SW) * BKV * SW + (kk * 32) % SW;
                wgmma_qk<BKV>(sc, hopper::make_desc(q_base + off_q, 1, SBO, T::MODE),
                              hopper::make_desc(k_base + off_k, 1, SBO, T::MODE), kk > 0);
            }
            hopper::wgmma_commit();
            hopper::wgmma_wait_all();
            hopper::fence_regs<BKV / 2>(sc);

            uint32_t p_hi[BKV / 4], p_lo[BKV / 4];
            float corr[2];
            const bool mask = k0 + BKV > p.Lkv || (p.causal && k0 + BKV - 1 > qa) ||
                              (p.window > 0 && k0 <= qa + 63 - p.window);
            if (mask)
                softmax_tile<BKV, true>(sc, p_hi, p_lo, m, l, corr, p, row, k0, lane);
            else
                softmax_tile<BKV, false>(sc, p_hi, p_lo, m, l, corr, p, row, k0, lane);
#pragma unroll
            for (int e = 0; e < HD / 2; ++e) o[e] *= corr[(e >> 1) & 1];

            // O += P_hi·V + P_lo·V: (64, BKV) x (BKV, hd), V MN-major
            const uint32_t v_base = hopper::smem_addr(Vs + s * T::KV_BYTES);
            constexpr uint32_t LBO = BKV * SW / 16;  // next 64 columns of hd
            hopper::mbar_wait(v_full + s, phase);
            hopper::fence_regs<HD / 2>(o);
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BKV / 16; ++kk)
                wgmma_pv<HD>(o, p_hi + 4 * kk,
                             hopper::make_desc(v_base + kk * 16 * SW, LBO, SBO, T::MODE));
#pragma unroll
            for (int kk = 0; kk < BKV / 16; ++kk)
                wgmma_pv<HD>(o, p_lo + 4 * kk,
                             hopper::make_desc(v_base + kk * 16 * SW, LBO, SBO, T::MODE));
            hopper::wgmma_commit();
            hopper::wgmma_wait_all();
            hopper::fence_regs<HD / 2>(o);
            hopper::mbar_arrive(kv_empty + s);
        }

        const float denom[2] = {fmaxf(quad_sum(l[0]), 1e-30f), fmaxf(quad_sum(l[1]), 1e-30f)};
        __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + b * p.so_b + h * p.so_h;
#pragma unroll
        for (int j = 0; j < HD / 4; ++j) {
            const int r = j & 1;
            if (row[r] < p.Lq) {
                const int col = 8 * (j / 2) + 2 * (lane % 4);
                *reinterpret_cast<uint32_t*>(op + (long long)row[r] * p.so_l + col) =
                    pack_bf16(o[2 * j] / denom[r], o[2 * j + 1] / denom[r]);
            }
        }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver API call: reached through the runtime's
// entry-point query, so the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &status);
#else
        cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
        if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(ptr);
    }
    return fn;
}

// A 4-D map (hd, L, heads, batch) over a bf16 operand with element strides
// (row, head, batch), boxes of (SW / 2 columns, rows, 1, 1).
template <int HD>
bool make_map(CUtensorMap* map, const void* base, int L, int heads, int B, long long s_l,
              long long s_h, long long s_b, int rows) {
    using T = Tile<HD>;
    EncodeTiled encode = encode_tiled();
    if (!encode) return false;
    const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)L, (cuuint64_t)heads, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)s_l * 2, (cuuint64_t)s_h * 2, (cuuint64_t)s_b * 2};
    const cuuint32_t box[4] = {(cuuint32_t)T::BOX, (cuuint32_t)rows, 1, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle swz = T::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : T::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// strides: (batch, head, row) element strides of q, k, v, o in that order.
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
                   int Lq, int Lkv, const long long* st, float scale, int causal, int window,
                   cudaStream_t stream) {
    using T = Tile<HD>;
    const int n_q = (Lq + BQ - 1) / BQ;
    if (B > 65535 || n_q > 65535) return cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv;
    if (!make_map<HD>(&tq, q, Lq, H, B, st[2], st[1], st[0], BQ) ||
        !make_map<HD>(&tk, k, Lkv, Hkv, B, st[5], st[4], st[3], T::BKV) ||
        !make_map<HD>(&tv, v, Lkv, Hkv, B, st[8], st[7], st[6], T::BKV))
        return cudaErrorInvalidValue;
    Params p;
    p.o = o;
    p.so_b = st[9];
    p.so_h = st[10];
    p.so_l = st[11];
    p.G = H / Hkv;
    p.Lq = Lq;
    p.Lkv = Lkv;
    p.causal = causal;
    p.window = window;
    p.scale_log2 = scale * LOG2E;
    cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd_wgmma_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)T::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)H, (unsigned)B, (unsigned)n_q);
    flash_attention_fwd_wgmma_kernel<HD><<<grid, THREADS, T::SMEM, stream>>>(tq, tk, tv, p);
    return cudaGetLastError();
}

inline cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                               int H, int Hkv, int Lq, int Lkv, int hd, const long long* st,
                               float scale, int causal, int window, cudaStream_t s) {
    switch (hd) {
        case 16: return launch<16>(q, k, v, o, B, H, Hkv, Lq, Lkv, st, scale, causal, window, s);
        case 32: return launch<32>(q, k, v, o, B, H, Hkv, Lq, Lkv, st, scale, causal, window, s);
        case 64: return launch<64>(q, k, v, o, B, H, Hkv, Lq, Lkv, st, scale, causal, window, s);
        case 128: return launch<128>(q, k, v, o, B, H, Hkv, Lq, Lkv, st, scale, causal, window, s);
        case 192: return launch<192>(q, k, v, o, B, H, Hkv, Lq, Lkv, st, scale, causal, window, s);
        case 256: return launch<256>(q, k, v, o, B, H, Hkv, Lq, Lkv, st, scale, causal, window, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace flash_bf16
