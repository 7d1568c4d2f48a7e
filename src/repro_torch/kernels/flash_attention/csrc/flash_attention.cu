// Flash-attention forward for Hopper (sm_90a):
//
//     o = softmax(scale · q kᵀ + mask) v      (per batch b and q head h,
//                                              kv head h / G for GQA)
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, body _flash_kernel). It computes the same blockwise
// online softmax: per kv tile the running max m, the running sum l and the
// accumulator acc are rescaled by exp(m_old − m_new), all in float32; the
// causal and sliding-window masks are applied per tile with the finite
// NEG_INF = −1e30, so a row that is fully masked within one tile gets
// p = exp(0) = 1 there and recovers (corr = exp(−1e30 − m) = 0) at its first
// real key, as the TPU kernel does, where −inf would give NaN; the output
// is acc / max(l, 1e-30), rounded once to q's dtype. A row that no key
// reaches at all (a sliding window with Lq >= Lkv + window) gets the plain
// version's softmax of an all-NEG_INF row, the mean of v over all Lkv keys:
// its q tile visits every kv tile. (The TPU kernel's value there depends on
// its block sizes, as it averages only the tiles it does not skip.)
//
// Design (simple first):
//   * one block of 256 threads per (q tile of 64 rows, q head, batch); the
//     TPU's sequential "arbitrary" kv grid axis becomes a loop inside the
//     block over only the kv tiles the tile's mask can reach (causal: up to
//     the diagonal; window: from the first tile inside it), which replaces
//     the pl.when skip; q tiles are issued last-first so the long causal
//     rows start early;
//   * the q tile and each 64-row k and v tile are staged in shared memory
//     as float32 (16-byte global loads, the ragged edge zero-filled); keys
//     past Lkv get p = 0, so the kernel has no block-multiple contract;
//   * the 16 × 16 threads own a 4 × 4 block of scores (rows ty + 16i,
//     columns tx + 16j) and the same 4 rows of acc (columns tx + 16c); row
//     max and sum are reduced over the 16 lanes of a half-warp with
//     shuffles; p goes through shared memory into the p·v product;
//   * GQA reads kv head h / G straight from k and v; no repeated heads;
//   * every operand is addressed through (batch, head, row) strides with a
//     contiguous head dim, so the (B, L, H, hd) model layout needs no
//     transposed copy;
//   * hd is a template parameter (16, 32, 64, 128); float32 and bf16 (bf16
//     carried as its 16 bits).
//
// What bounds it: at the serving slice's prefill (granite-3-2b: q (4, 3072,
// 32, 64), k/v (4, 3072, 8, 64), bf16, causal) the work is 1.55e11 FLOP
// (the causal half of 4·B·H·L²·hd), 0.156 ms at the H100's 989 TFLOP/s of
// bf16 tensor cores; the 126 MB of q, k, v and o take 0.038 ms at 3.35
// TB/s. So it is bound by operations. This first version does every
// product as float32 FMAs on the CUDA cores (67 TFLOP/s: at least 2.3 ms
// even at peak), waits on each tile's loads (no cp.async/TMA pipeline),
// keeps float32 tiles (twice the shared memory of bf16, fewer blocks per
// SM) and computes the diagonal tiles whole under the mask. Tensor cores
// (mma.sync/wgmma), TMA and warp specialisation are the redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FLASH_NEG_INF (-1e30f)

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BKV = 64;       // kv rows per tile
constexpr int THREADS = 256;  // 16 (ty: rows) x 16 (tx: columns)
constexpr int RPT = 4;        // q rows per thread: ty + 16 i
constexpr int CPT = 4;        // score columns per thread: tx + 16 j
constexpr int LDP = BKV + 4;  // padded row of the p tile (floats)

typedef uint16_t bf16_bits;

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

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16_bits from_f32<bf16_bits>(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// 16 bytes of T at p → VEC floats (exact for both types).
template <typename T> struct Vec;
template <> struct Vec<float> {
    static constexpr int N = 4;
    static __device__ __forceinline__ void load(const float* p, float* out) {
        const float4 r = *reinterpret_cast<const float4*>(p);
        out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
    }
};
template <> struct Vec<bf16_bits> {
    static constexpr int N = 8;
    static __device__ __forceinline__ void load(const bf16_bits* p, float* out) {
        const uint4 r = *reinterpret_cast<const uint4*>(p);
        const unsigned int w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // little endian: low half first
            out[2 * e] = __uint_as_float(w[e] << 16);
            out[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
        }
    }
};

// Rows [row0, row0 + 64) of a (rows, HD) operand into a float32 tile with
// row pitch HD + 4; rows at or past n_rows are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long row_stride, int row0, int n_rows) {
    constexpr int N = Vec<T>::N;
    constexpr int CH = HD / N;  // 16-byte chunks per row
    constexpr int LD = HD + 4;
    for (int c = threadIdx.x; c < 64 * CH; c += THREADS) {
        const int r = c / CH, ch = c % CH;
        float vals[N];
        if (row0 + r < n_rows) {
            Vec<T>::load(src + (long long)(row0 + r) * row_stride + ch * N, vals);
        } else {
#pragma unroll
            for (int e = 0; e < N; ++e) vals[e] = 0.f;
        }
        float4* d = reinterpret_cast<float4*>(dst + r * LD + ch * N);
#pragma unroll
        for (int e = 0; e < N / 4; ++e)
            d[e] = make_float4(vals[4 * e], vals[4 * e + 1], vals[4 * e + 2], vals[4 * e + 3]);
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

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_attention_fwd_kernel(const Params p) {
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
    const T* qp = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
    const T* kp = static_cast<const T*>(p.k) + b * p.sk.b + hk * p.sk.h;
    const T* vp = static_cast<const T*>(p.v) + b * p.sv.b + hk * p.sv.h;
    T* op = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;

    // the kv tiles this q tile's mask can reach; a tile holding a row that
    // no key reaches (a window with Lq >= Lkv + window) visits them all
    const int n_kv = (p.Lkv + BKV - 1) / BKV;
    const int q_last = min(q0 + BQ, p.Lq) - 1;
    const bool keyless_row = p.window > 0 && q_last >= p.Lkv + p.window - 1;
    const int hi = p.causal && !keyless_row ? min(q_last / BKV + 1, n_kv) : n_kv;
    const int lo = p.window > 0 && !keyless_row ? max(q0 - p.window + 1, 0) / BKV : 0;

    load_tile<T, HD>(Qs, qp, p.sq.l, q0, p.Lq);

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
        load_tile<T, HD>(Ks, kp, p.sk.l, k0, p.Lkv);
        load_tile<T, HD>(Vs, vp, p.sv.l, k0, p.Lkv);
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
                op[(long long)qpos * p.so.l + tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
        }
    }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, int B, int H, cudaStream_t stream) {
    const size_t smem = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((p.Lq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
    flash_attention_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int B, int H, int hd, cudaStream_t s) {
    switch (hd) {
        case 16: return launch<T, 16>(p, B, H, s);
        case 32: return launch<T, 32>(p, B, H, s);
        case 64: return launch<T, 64>(p, B, H, s);
        case 128: return launch<T, 128>(p, B, H, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q: (B, H, Lq, hd), k/v: (B, Hkv, Lkv, hd), o: (B, H, Lq, hd), addressed
// through `strides`: 12 element strides, (batch, head, row) of q, k, v, o in
// that order; the head dim must be contiguous and every row 16-byte aligned
// (the wrapper checks). dtype: 0 = float32, 1 = bfloat16 (all four
// operands). window <= 0: no sliding window. Returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int H, int Hkv, int Lq, int Lkv, int hd,
                                   const long long* strides, float scale, int causal,
                                   int window, int dtype, void* stream) {
    if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Lq < 1 || Lkv < 1)
        return (int)cudaErrorInvalidValue;
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
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)dispatch_hd<float>(p, B, H, hd, s);
    if (dtype == 1) return (int)dispatch_hd<bf16_bits>(p, B, H, hd, s);
    return (int)cudaErrorInvalidValue;
}
