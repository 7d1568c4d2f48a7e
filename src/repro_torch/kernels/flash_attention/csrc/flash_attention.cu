// Flash-attention forward for Hopper (sm_90a), two routes by dtype:
//
//     o = softmax(scale · q kᵀ + mask) v      (per batch b and q head h,
//                                              kv head h / G for GQA)
//
//   * bf16: flash_attention_bf16.cuh, wgmma tensor cores on bf16 tiles that
//     TMA copies into shared memory (the serving prefill's route);
//   * float32: this file's kernel, CUDA-core float32 FMAs. The reference
//     holds float32 to 2e-5, which TF32 tensor cores cannot meet, and no
//     path of the port runs attention in float32 on this kernel's hot loop.
//
// Both replace the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py (flash_attention, body _flash_kernel). They compute the same
// blockwise online softmax: per kv tile the running max m, the running sum l
// and the accumulator acc are rescaled by exp(m_old − m_new), all in
// float32; the causal and sliding-window masks are applied per tile with the
// finite NEG_INF = −1e30, so a row that is fully masked within one tile gets
// p = exp(0) = 1 there and recovers (corr = exp(−1e30 − m) = 0) at its first
// real key, as the TPU kernel does, where −inf would give NaN; the output is
// acc / max(l, 1e-30), rounded once to q's dtype. A row that no key reaches
// at all (a sliding window with Lq >= Lkv + window) gets the plain version's
// softmax of an all-NEG_INF row, the mean of v over all Lkv keys: its q tile
// visits every kv tile. (The TPU kernel's value there depends on its block
// sizes, as it averages only the tiles it does not skip.)
//
// The float32 kernel (simple first):
//   * one block of 256 threads per (q tile of 64 rows, q head, batch); a
//     loop inside the block over only the kv tiles the tile's mask can
//     reach (causal: up to the diagonal; window: from the first tile inside
//     it), which replaces the pl.when skip; q tiles are issued last-first so
//     the long causal rows start early;
//   * the q tile and each 64-row k and v tile are staged in shared memory
//     (16-byte global loads, the ragged edge zero-filled); keys past Lkv get
//     p = 0, so the kernel has no block-multiple contract;
//   * the 16 × 16 threads own a 4 × 4 block of scores (rows ty + 16i,
//     columns tx + 16j) and the same 4 rows of acc (columns tx + 16c); row
//     max and sum are reduced over the 16 lanes of a half-warp with
//     shuffles; p goes through shared memory into the p·v product;
//   * GQA reads kv head h / G straight from k and v; no repeated heads;
//   * every operand is addressed through (batch, head, row) strides with a
//     contiguous head dim, so the (B, L, H, hd) model layout needs no
//     transposed copy; hd is a template parameter (16, 32, 64, 128, 192,
//     256). The three staged tiles and p take 3·64·(hd + 4)·4 + 64·68·4
//     bytes of shared memory: 164 KB at hd 192 and 212 KB at hd 256, inside
//     the 227 KB a block may use, so the tile stays 64 by 64 at every hd.
// It is bound by the CUDA cores' float32 rate (67 TFLOP/s), not by bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_bf16.cuh"

#define FLASH_NEG_INF (-1e30f)

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BKV = 64;       // kv rows per tile
constexpr int THREADS = 256;  // 16 (ty: rows) x 16 (tx: columns)
constexpr int RPT = 4;        // q rows per thread: ty + 16 i
constexpr int CPT = 4;        // score columns per thread: tx + 16 j
constexpr int LDP = BKV + 4;  // padded row of the p tile (floats)

struct Strides {
    long long b, h, l;  // elements; the head dim is contiguous
};

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    Strides sq, sk, sv, so;
    int G, Lq, Lkv;
    float scale;
    int causal;
    int window;  // <= 0: no sliding window
};

// Rows [row0, row0 + 64) of a (rows, HD) operand into a float32 tile with
// row pitch HD + 4; rows at or past n_rows are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          long long row_stride, int row0, int n_rows) {
    constexpr int CH = HD / 4;  // 16-byte chunks per row
    constexpr int LD = HD + 4;
    for (int c = threadIdx.x; c < 64 * CH; c += THREADS) {
        const int r = c / CH, ch = c % CH;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + r < n_rows)
            val = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * row_stride + ch * 4);
        *reinterpret_cast<float4*>(dst + r * LD + ch * 4) = val;
    }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

template <int HD>
constexpr size_t smem_bytes() {
    return (size_t)(3 * 64 * (HD + 4) + BQ * LDP) * sizeof(float);
}
static_assert(smem_bytes<256>() <= 232448, "the float32 tiles exceed a block's shared memory");

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_attention_fwd_f32_kernel(const Params p) {
    constexpr int LD = HD + 4;
    constexpr int CPO = HD / 16;  // output columns per thread: tx + 16 c
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);  // BQ x LD
    float* Ks = Qs + BQ * LD;                     // BKV x LD
    float* Vs = Ks + BKV * LD;                    // BKV x LD
    float* Ps = Vs + BKV * LD;                    // BQ x LDP

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // last tile first
    const int h = blockIdx.y, b = blockIdx.z, hk = h / p.G;
    const float* qp = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
    const float* kp = static_cast<const float*>(p.k) + b * p.sk.b + hk * p.sk.h;
    const float* vp = static_cast<const float*>(p.v) + b * p.sv.b + hk * p.sv.h;
    float* op = static_cast<float*>(p.o) + b * p.so.b + h * p.so.h;

    // the kv tiles this q tile's mask can reach; a tile holding a row that
    // no key reaches (a window with Lq >= Lkv + window) visits them all
    const int n_kv = (p.Lkv + BKV - 1) / BKV;
    const int q_last = min(q0 + BQ, p.Lq) - 1;
    const bool keyless_row = p.window > 0 && q_last >= p.Lkv + p.window - 1;
    const int hi = p.causal && !keyless_row ? min(q_last / BKV + 1, n_kv) : n_kv;
    const int lo = p.window > 0 && !keyless_row ? max(q0 - p.window + 1, 0) / BKV : 0;

    load_tile<HD>(Qs, qp, p.sq.l, q0, p.Lq);

    float m[RPT], l[RPT], acc[RPT][CPO];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        m[i] = FLASH_NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < CPO; ++c) acc[i][c] = 0.f;
    }

    for (int kt = lo; kt < hi; ++kt) {
        const int k0 = kt * BKV;
        __syncthreads();  // the previous tile's readers are done
        load_tile<HD>(Ks, kp, p.sk.l, k0, p.Lkv);
        load_tile<HD>(Vs, vp, p.sv.l, k0, p.Lkv);
        __syncthreads();

        // scores: s[i][j] = q[ty + 16i] · k[tx + 16j]
        float s[RPT][CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; d += 4) {
            float4 qv[RPT], kv[CPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i)
                qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
            for (int j = 0; j < CPT; ++j)
                kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
            for (int i = 0; i < RPT; ++i)
#pragma unroll
                for (int j = 0; j < CPT; ++j) {
                    s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
                    s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
                    s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
                    s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
                }
        }

        // mask, online softmax, p into shared memory
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int qpos = q0 + ty + 16 * i;
            float mt = FLASH_NEG_INF;
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                const int kpos = k0 + tx + 16 * j;
                bool ok = true;
                if (p.causal) ok = ok && kpos <= qpos;
                if (p.window > 0) ok = ok && kpos > qpos - p.window;
                s[i][j] = ok ? s[i][j] * p.scale : FLASH_NEG_INF;
                if (kpos < p.Lkv) mt = fmaxf(mt, s[i][j]);
            }
            const float m_new = fmaxf(m[i], half_warp_max(mt));
            const float corr = expf(m[i] - m_new);
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                const int kpos = k0 + tx + 16 * j;
                const float pij = kpos < p.Lkv ? expf(s[i][j] - m_new) : 0.f;
                rs += pij;
                Ps[(ty + 16 * i) * LDP + tx + 16 * j] = pij;
            }
            l[i] = l[i] * corr + rs;  // this thread's columns; summed at the end
#pragma unroll
            for (int c = 0; c < CPO; ++c) acc[i][c] *= corr;
            m[i] = m_new;
        }
        __syncthreads();

        // acc[i][c] += Σ_j p[ty + 16i][j] · v[j][tx + 16c]
#pragma unroll 2
        for (int j = 0; j < BKV; j += 4) {
            float4 pv[RPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i)
                pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * LDP + j);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                float vv[CPO];
#pragma unroll
                for (int c = 0; c < CPO; ++c) vv[c] = Vs[(j + jj) * LD + tx + 16 * c];
#pragma unroll
                for (int i = 0; i < RPT; ++i) {
                    const float pij = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
                    for (int c = 0; c < CPO; ++c) acc[i][c] = fmaf(pij, vv[c], acc[i][c]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const float denom = fmaxf(half_warp_sum(l[i]), 1e-30f);
        const int qpos = q0 + ty + 16 * i;
        if (qpos < p.Lq) {
#pragma unroll
            for (int c = 0; c < CPO; ++c)
                op[(long long)qpos * p.so.l + tx + 16 * c] = acc[i][c] / denom;
        }
    }
}

template <int HD>
cudaError_t launch(const Params& p, int B, int H, cudaStream_t stream) {
    const size_t smem = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd_f32_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((p.Lq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
    flash_attention_fwd_f32_kernel<HD><<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

cudaError_t dispatch_hd(const Params& p, int B, int H, int hd, cudaStream_t s) {
    switch (hd) {
        case 16: return launch<16>(p, B, H, s);
        case 32: return launch<32>(p, B, H, s);
        case 64: return launch<64>(p, B, H, s);
        case 128: return launch<128>(p, B, H, s);
        case 192: return launch<192>(p, B, H, s);
        case 256: return launch<256>(p, B, H, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q: (B, H, Lq, hd), k/v: (B, Hkv, Lkv, hd), o: (B, H, Lq, hd), addressed
// through `strides`: 12 element strides, (batch, head, row) of q, k, v, o in
// that order; the head dim must be contiguous and every row 16-byte aligned
// (the wrapper checks). dtype: 0 = float32 (the CUDA-core kernel), 1 =
// bfloat16 (the wgmma kernel), all four operands. window <= 0: no sliding
// window. Returns a cudaError_t; nothing falls back from one route to the
// other.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int H, int Hkv, int Lq, int Lkv, int hd,
                                   const long long* strides, float scale, int causal,
                                   int window, int dtype, void* stream) {
    if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Lq < 1 || Lkv < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
        return (int)flash_bf16::dispatch_hd(q, k, v, o, B, H, Hkv, Lq, Lkv, hd, strides, scale,
                                            causal, window, s);
    if (dtype != 0) return (int)cudaErrorInvalidValue;
    Params p;
    p.q = q; p.k = k; p.v = v; p.o = o;
    p.sq = {strides[0], strides[1], strides[2]};
    p.sk = {strides[3], strides[4], strides[5]};
    p.sv = {strides[6], strides[7], strides[8]};
    p.so = {strides[9], strides[10], strides[11]};
    p.G = H / Hkv;
    p.Lq = Lq;
    p.Lkv = Lkv;
    p.scale = scale;
    p.causal = causal;
    p.window = window;
    return (int)dispatch_hd(p, B, H, hd, s);
}
