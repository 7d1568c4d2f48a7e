// The consensus statistics of one decentralized train step, for Hopper
// (sm_90a): over every leaf of the gradient tree and of the new-param tree,
// each with a leading worker dim of M,
//
//     E     = Σ_j ||g_j||²                 (gradient leaves)
//     E_sp  = Σ_j ||g_j − ḡ||²             (gradient leaves)
//     ||ḡ||²                               (gradient leaves)
//     spread = Σ_j ||w_j − w̄||²            (param leaves)
//
// each split into the leaves a model axis shards and the others.
//
// It replaces no kernel of the TPU package: the reference leaves these sums
// to XLA's fused reductions. It replaces the port's plain passes
// (kernels/consensus_stats/ref.py, core/decentralized.py step_metrics),
// which walk the trees a leaf at a time and write a float32 temporary at
// every step of every leaf, so that each element moves some 60 bytes.
//
// Arithmetic, as the plain version's: x̄ of a column is the float32 sum of
// its M values in worker order, divided by M and rounded to the leaf's
// dtype (round to nearest even); a deviation is float(x_j) − float(x̄) in
// float32, rounded to the leaf's dtype, as PyTorch's x − mean in that dtype
// is, then squared in float32. The deviation is written with the _rn
// intrinsics, so nothing is contracted there. The sums are taken in another
// order than PyTorch's: float32 over one column tile of every worker, then
// float64 in each thread, in each block in a fixed tree, and over the
// blocks in a fixed order in a second pass. No atomics: the same inputs
// give the same bits.
//
// What bounds it: bytes. Each element of each worker is read once and the
// work per element is a few flops, so a step's statistics cost one read of
// the gradients and the new params: 2·M·P·2 bytes in bf16, 9.4 GB at
// granite-3-2b's 8 layers on a ring of 4, about 2.8 ms at 3.35 TB/s. The
// design does what a read-once pass needs. A table in device memory lists
// the step's pieces of leaves (data pointer, worker stride, elements per
// worker, slot), so one launch covers every leaf of a dtype; each thread
// takes a column tile (16 bytes) of every worker at once, neighbouring
// threads on neighbouring addresses, and keeps the M tiles in registers
// (M a template parameter up to 8) while it forms the sum, the mean and
// the deviations. Above 8 workers the tile is read twice, once for the sum
// and once for the deviations. Each piece's first column goes to the
// thread its offset in the table gives (`rot`), so the many small leaves
// spread over the grid.
//
// Forms: HELD, the meshless step (the sums in registers); SUMS, a worker
// mesh, where the column sums are all-reduced over the ranks first and the
// kernel reads them from a float32 buffer (per piece, `sums`). The
// allreduce mode's gradient norm is HELD with one worker: x̄ = x, no
// deviation, E = Σ x².
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define HELD_MAX_WORKERS 8
#define STATS 8   // (E, E_sp, ||ḡ||², spread) × (sharded, whole), row-major

enum { FORM_HELD = 0, FORM_SUMS = 1 };
enum { FLAG_PARAM = 1, FLAG_SHARDED = 2, FLAG_VECTOR = 4 };

// One row of the table, ten 64-bit words, as kernel.py builds it. A piece
// is `rows` runs of `count` adjacent elements, `rstride` elements apart (a
// leaf's worker copy with gaps, such as a model axis's shard of a wider
// dim; 1 row for a copy that fills a block of its own size).
struct Entry {
    long long ptr;      // worker 0's first element of the piece
    long long wstride;  // elements from one worker's copy to the next
    long long count;    // elements of a run
    long long units;    // columns of all rows: rows × count / VEC (FLAG_VECTOR), else rows × count
    long long rot;      // the thread that takes the first column
    long long sums;     // float32 column sums of the piece, laid out as a worker's copy (FORM_SUMS), or 0
    long long flags;    // FLAG_*
    long long first;    // columns of the pieces before this one (host only)
    long long rows;     // runs
    long long rstride;  // elements from one run to the next
};

// 16-bit floats carried as their bits, so that every element type is
// plain old data.
struct BF16 { uint16_t b; };
struct F16 { uint16_t b; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(BF16 x) {
    return __uint_as_float(((unsigned int)x.b) << 16);  // exact
}
__device__ __forceinline__ float to_f32(F16 x) { return __half2float(__ushort_as_half(x.b)); }

// x rounded to T (nearest even) and widened back: what PyTorch's cast to T
// and its arithmetic in T give.
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<BF16>(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}
template <> __device__ __forceinline__ float round_to<F16>(float x) {
    return __half2float(__float2half_rn(x));
}

// V consecutive elements at p as floats: one 16-byte load when the piece is
// vectorized (p aligned), else V element loads.
template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float* out) {
    if constexpr (V * sizeof(T) == 16) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i) out[i] = to_f32(v[i]);
    } else {
#pragma unroll
        for (int i = 0; i < V; ++i) out[i] = to_f32(p[i]);
    }
}

// The column sums of one tile (V columns of every worker) in float32.
struct Tile {
    float e = 0.f, sp = 0.f, msq = 0.f;
};

// HELD: the MT workers' tiles in registers, read once.
template <typename T, int MT, bool GRAD, int V>
__device__ __forceinline__ Tile held_tile(const T* __restrict__ p, long long ws) {
    float x[MT][V];
#pragma unroll
    for (int j = 0; j < MT; ++j) load<T, V>(p + j * ws, x[j]);
    Tile t;
#pragma unroll
    for (int i = 0; i < V; ++i) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < MT; ++j) s = __fadd_rn(s, x[j][i]);
        const float mean = round_to<T>(__fdiv_rn(s, (float)MT));
#pragma unroll
        for (int j = 0; j < MT; ++j) {
            const float d = round_to<T>(__fsub_rn(x[j][i], mean));
            t.sp = fmaf(d, d, t.sp);
            if (GRAD) t.e = fmaf(x[j][i], x[j][i], t.e);
        }
        if (GRAD) t.msq = fmaf(mean, mean, t.msq);
    }
    return t;
}

// Any number of workers: FORM_SUMS reads the sums, FORM_HELD (above
// HELD_MAX_WORKERS) forms them in a first read of the tile.
template <typename T, bool GRAD, int V>
__device__ __forceinline__ Tile stream_tile(const T* __restrict__ p, long long ws,
                                            const float* __restrict__ sums, int workers,
                                            int M, int form) {
    Tile t;
    float mean[V], x[V];
    if (form == FORM_SUMS) {
#pragma unroll
        for (int i = 0; i < V; ++i) mean[i] = round_to<T>(__fdiv_rn(sums[i], (float)M));
    } else {
        float s[V];
#pragma unroll
        for (int i = 0; i < V; ++i) s[i] = 0.f;
        for (int j = 0; j < workers; ++j) {
            load<T, V>(p + j * ws, x);
#pragma unroll
            for (int i = 0; i < V; ++i) {
                s[i] = __fadd_rn(s[i], x[i]);
                if (GRAD) t.e = fmaf(x[i], x[i], t.e);
            }
        }
#pragma unroll
        for (int i = 0; i < V; ++i) mean[i] = round_to<T>(__fdiv_rn(s[i], (float)M));
    }
    for (int j = 0; j < workers; ++j) {
        load<T, V>(p + j * ws, x);
#pragma unroll
        for (int i = 0; i < V; ++i) {
            if (GRAD && form == FORM_SUMS) t.e = fmaf(x[i], x[i], t.e);
            const float d = round_to<T>(__fsub_rn(x[i], mean[i]));
            t.sp = fmaf(d, d, t.sp);
        }
    }
    if (GRAD) {
#pragma unroll
        for (int i = 0; i < V; ++i) t.msq = fmaf(mean[i], mean[i], t.msq);
    }
    return t;
}

// acc[k] += v, with k known only at run time and acc kept in registers.
__device__ __forceinline__ void add_at(double* acc, int k, double v) {
#pragma unroll
    for (int i = 0; i < STATS; ++i)
        if (i == k) acc[i] += v;
}

// One piece's columns that this thread takes, summed in float64, into the
// slots the piece's flags name.
template <typename T, int MT, bool GRAD, int V>
__device__ __forceinline__ void piece(const Entry& en, long long u0, long long stride,
                                      int workers, int M, int form, double* acc) {
    const T* base = reinterpret_cast<const T*>(en.ptr);
    const float* sums = reinterpret_cast<const float*>(en.sums);
    const long long per_row = en.units / en.rows;
    double e = 0.0, sp = 0.0, msq = 0.0;
    for (long long u = u0; u < en.units; u += stride) {
        const long long off =
            en.rows == 1 ? u * V : (u / per_row) * en.rstride + (u % per_row) * V;
        Tile t;
        if constexpr (MT > 0)
            t = held_tile<T, MT, GRAD, V>(base + off, en.wstride);
        else
            t = stream_tile<T, GRAD, V>(base + off, en.wstride, sums + off, workers, M, form);
        e += t.e;
        sp += t.sp;
        msq += t.msq;
    }
    const int col = (en.flags & FLAG_SHARDED) ? 0 : 1;
    if (GRAD) {
        add_at(acc, 0 + col, e);
        add_at(acc, 2 + col, sp);
        add_at(acc, 4 + col, msq);
    } else {
        add_at(acc, 6 + col, sp);
    }
}

// The block's sums of acc, in a fixed order, into partials[blockIdx.x].
__device__ __forceinline__ void block_sum(double* acc, double* __restrict__ dst) {
    __shared__ double part[WARPS][STATS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < STATS; ++k)
        for (int off = 16; off > 0; off >>= 1)
            acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < STATS; ++k) part[warp][k] = acc[k];
    }
    __syncthreads();
    if (threadIdx.x < STATS) {
        double v = 0.0;
        for (int w = 0; w < WARPS; ++w) v += part[w][threadIdx.x];
        dst[threadIdx.x] = v;
    }
}

// MT > 0: FORM_HELD with MT workers in registers; MT == 0: any form and
// number of workers (stream_tile).
template <typename T, int MT>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const Entry* __restrict__ table, int n, int workers, int M, int form,
             double* __restrict__ partials) {
    constexpr int VEC = 16 / (int)sizeof(T);
    double acc[STATS];
#pragma unroll
    for (int k = 0; k < STATS; ++k) acc[k] = 0.0;
    const long long stride = (long long)gridDim.x * THREADS;
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    for (int k = 0; k < n; ++k) {
        const Entry en = table[k];
        const long long u0 = t >= en.rot ? t - en.rot : t - en.rot + stride;
        if (u0 >= en.units) continue;
        const bool vec = en.flags & FLAG_VECTOR;
        if (en.flags & FLAG_PARAM) {
            if (vec) piece<T, MT, false, VEC>(en, u0, stride, workers, M, form, acc);
            else piece<T, MT, false, 1>(en, u0, stride, workers, M, form, acc);
        } else {
            if (vec) piece<T, MT, true, VEC>(en, u0, stride, workers, M, form, acc);
            else piece<T, MT, true, 1>(en, u0, stride, workers, M, form, acc);
        }
    }
    block_sum(acc, partials + (long long)blockIdx.x * STATS);
}

// The second pass: the blocks' partials in a fixed order, into out (float32,
// STATS values), added to what out holds when `accumulate`.
__global__ void __launch_bounds__(THREADS)
finish_kernel(const double* __restrict__ partials, int blocks, float* __restrict__ out,
              int accumulate) {
    __shared__ double total[STATS];
    double acc[STATS];
#pragma unroll
    for (int k = 0; k < STATS; ++k) acc[k] = 0.0;
    for (int b = threadIdx.x; b < blocks; b += THREADS)
#pragma unroll
        for (int k = 0; k < STATS; ++k) acc[k] += partials[(long long)b * STATS + k];
    block_sum(acc, total);
    __syncthreads();
    if (threadIdx.x < STATS) {
        const float v = (float)total[threadIdx.x];
        out[threadIdx.x] = accumulate ? out[threadIdx.x] + v : v;
    }
}

typedef void (*StatsKernel)(const Entry*, int, int, int, int, double*);

template <typename T>
static StatsKernel pick_t(int workers, int form) {
    if (form == FORM_HELD) {
        switch (workers) {
            case 1: return stats_kernel<T, 1>;
            case 2: return stats_kernel<T, 2>;
            case 3: return stats_kernel<T, 3>;
            case 4: return stats_kernel<T, 4>;
            case 5: return stats_kernel<T, 5>;
            case 6: return stats_kernel<T, 6>;
            case 7: return stats_kernel<T, 7>;
            case 8: return stats_kernel<T, 8>;
            default: break;
        }
    }
    return stats_kernel<T, 0>;
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.
static StatsKernel pick(int dtype, int workers, int form) {
    if (form < FORM_HELD || form > FORM_SUMS || workers < 1) return nullptr;
    if (dtype == 0) return pick_t<float>(workers, form);
    if (dtype == 1) return pick_t<BF16>(workers, form);
    if (dtype == 2) return pick_t<F16>(workers, form);
    return nullptr;
}

// Blocks of the kernel that `dtype`, `workers` and `form` pick that the
// device holds at once (SMs × blocks per SM), or a negative cudaError_t.
extern "C" int consensus_stats_blocks(int dtype, int workers, int form) {
    const StatsKernel kern = pick(dtype, workers, form);
    if (kern == nullptr) return -(int)cudaErrorInvalidValue;
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)kern,
                                                            THREADS, 0);
    if (err != cudaSuccess) return -(int)err;
    return sms * (per_sm > 0 ? per_sm : 1);
}

// One launch over a table of `n` entries in device memory on `blocks`
// blocks (the `rot` of each entry counts threads of that grid), then the
// second pass into `out` (8 float32: the four statistics × (sharded,
// whole)). `partials` holds blocks × 8 float64. Returns a cudaError_t.
extern "C" int consensus_stats(const void* table, int n, int blocks, int dtype, int workers,
                               int M, int form, void* partials, void* out, int accumulate,
                               void* stream) {
    const StatsKernel kern = pick(dtype, workers, form);
    if (kern == nullptr || n <= 0 || blocks <= 0 || M < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Entry* tab = static_cast<const Entry*>(table);
    double* part = static_cast<double*>(partials);
    void* args[] = {(void*)&tab, (void*)&n, (void*)&workers, (void*)&M, (void*)&form,
                    (void*)&part};
    cudaError_t err = cudaLaunchKernel((const void*)kern, dim3(blocks), dim3(THREADS), args, 0, s);
    if (err != cudaSuccess) return (int)err;
    finish_kernel<<<1, THREADS, 0, s>>>(part, blocks, static_cast<float*>(out), accumulate);
    return (int)cudaGetLastError();
}

extern "C" int consensus_stats_held_max_workers() { return HELD_MAX_WORKERS; }
