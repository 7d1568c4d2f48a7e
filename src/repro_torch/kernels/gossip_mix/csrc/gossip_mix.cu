// Fused gossip mix + update for Hopper (sm_90a):
//
//     out = a0·w + Σ_d a_{d+1}·nbr_d − eta·u
//
// Replaces the Pallas TPU kernel src/repro/kernels/gossip_mix/kernel.py
// (gossip_mix_2d, body _kernel). It computes the same function in the same
// order: the self term, then the neighbours in d order, then −eta·u, all in
// float32, with one rounding to w's dtype at the end (round to nearest
// even). Every multiply and add is written with the _rn intrinsics, so nvcc
// contracts nothing into an FMA and each step rounds as the plain PyTorch
// version's separate multiply and add do.
//
// What bounds it: bytes. Each element is read k+2 times (w, k neighbours,
// u) and written once, for 2k+3 flops per k+3 accesses. For the
// decentralized step at granite-3-2b width (M=4 workers on a ring, k=2,
// bf16, 4 × 687,915,008 bytes per buffer) that is 5 passes × 2.75 GB =
// 13.8 GB, about 4.1 ms at the H100 SXM's 3.35 TB/s. The design does the
// one thing that matters for a pass like this: every thread moves 16 bytes
// per load and store (8 bf16 or 4 float32 elements), neighbouring threads
// on neighbouring addresses, in a grid-stride loop over the flat buffer.
// k, the k+1 weights and eta travel by value in the launch parameters; the
// kernel allocates nothing and launches on the caller's stream.
//
// Outside the kernel: the (k, R, C) neighbour stack the bus builds with
// x_c[perm] costs k more buffer copies per step. Reading neighbour rows
// through the permutation index instead is the first redesign for a later
// change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define GOSSIP_MIX_MAX_NEIGHBORS 32

struct MixArgs {
    float a[GOSSIP_MIX_MAX_NEIGHBORS + 1];  // [a_self, a_1, ..., a_k]
    float eta;
    int k;
};

// bf16 values are carried as their 16 bits (uint16_t) so that every
// element type in the kernel is plain old data.
typedef uint16_t bf16_bits;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16_bits x) {
    return __uint_as_float(((unsigned int)x) << 16);  // exact
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16_bits from_f32<bf16_bits>(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// VEC consecutive elements at p (aligned to VEC * sizeof(T) bytes, at most
// 16) as floats, in 16- or 8-byte loads.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
    constexpr int BYTES = VEC * (int)sizeof(T);
    alignas(16) T v[VEC];
    if constexpr (BYTES % 16 == 0) {
#pragma unroll
        for (int c = 0; c < BYTES / 16; ++c)
            reinterpret_cast<uint4*>(v)[c] = reinterpret_cast<const uint4*>(p)[c];
    } else if constexpr (BYTES == 8) {
        *reinterpret_cast<uint2*>(v) = *reinterpret_cast<const uint2*>(p);
    } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[j] = p[j];
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = to_f32(v[j]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* in) {
    constexpr int BYTES = VEC * (int)sizeof(T);
    alignas(16) T v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = from_f32<T>(in[j]);
    if constexpr (BYTES % 16 == 0) {
#pragma unroll
        for (int c = 0; c < BYTES / 16; ++c)
            reinterpret_cast<uint4*>(p)[c] = reinterpret_cast<const uint4*>(v)[c];
    } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) p[j] = v[j];
    }
}

// One thread handles VEC consecutive elements per trip of a grid-stride
// loop over n / VEC groups. VEC == 1 is the path for buffers whose pointers
// or length do not allow 16-byte accesses.
template <typename TW, typename TU, int VEC>
__global__ void __launch_bounds__(256)
gossip_mix_kernel(const TW* __restrict__ w, const TW* __restrict__ nbr,
                  const TU* __restrict__ u, TW* __restrict__ out,
                  long long n, MixArgs args) {
    const long long groups = n / VEC;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < groups;
         i += stride) {
        const long long base = i * VEC;
        float acc[VEC];
        float tmp[VEC];
        load_vec<TW, VEC>(w + base, acc);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = __fmul_rn(acc[j], args.a[0]);
        for (int d = 0; d < args.k; ++d) {
            load_vec<TW, VEC>(nbr + (long long)d * n + base, tmp);
            const float a = args.a[d + 1];
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(tmp[j], a));
        }
        if (u != nullptr) {
            load_vec<TU, VEC>(u + base, tmp);
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[j] = __fsub_rn(acc[j], __fmul_rn(args.eta, tmp[j]));
        }
        store_vec<TW, VEC>(out + base, acc);
    }
}

template <typename TW, typename TU>
static cudaError_t launch(const void* w, const void* nbr, const void* u, void* out,
                          long long n, const MixArgs& args, bool vectorized,
                          cudaStream_t stream) {
    constexpr int VEC = 16 / (int)sizeof(TW);
    const int threads = 256;
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const long long work = vectorized ? n / VEC : n;
    long long blocks = (work + threads - 1) / threads;
    const long long cap = (long long)sms * 8;  // 8 × 256 threads fill an SM
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    const TW* wp = static_cast<const TW*>(w);
    const TW* np_ = static_cast<const TW*>(nbr);
    const TU* up = static_cast<const TU*>(u);
    TW* op = static_cast<TW*>(out);
    if (vectorized) {
        gossip_mix_kernel<TW, TU, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
            wp, np_, up, op, n, args);
    } else {
        gossip_mix_kernel<TW, TU, 1><<<(unsigned)blocks, threads, 0, stream>>>(
            wp, np_, up, op, n, args);
    }
    return cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16. `u` may be null (pure mix; then
// u_dtype and eta are ignored). `weights` is a host array of k+1 floats.
// `vectorized` asserts that every pointer is 16-byte aligned and that n is
// a multiple of 16 / sizeof(w element). Returns a cudaError_t.
extern "C" int gossip_mix(const void* w, const void* nbr, const void* u, void* out,
                          long long n, int k, const float* weights, float eta,
                          int w_dtype, int u_dtype, int vectorized, void* stream) {
    if (k < 0 || k > GOSSIP_MIX_MAX_NEIGHBORS || n <= 0) return (int)cudaErrorInvalidValue;
    MixArgs args;
    for (int d = 0; d <= k; ++d) args.a[d] = weights[d];
    args.eta = eta;
    args.k = k;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = vectorized != 0;
    if (w_dtype == 0 && u_dtype == 0) return (int)launch<float, float>(w, nbr, u, out, n, args, vec, s);
    if (w_dtype == 0 && u_dtype == 1) return (int)launch<float, bf16_bits>(w, nbr, u, out, n, args, vec, s);
    if (w_dtype == 1 && u_dtype == 0) return (int)launch<bf16_bits, float>(w, nbr, u, out, n, args, vec, s);
    if (w_dtype == 1 && u_dtype == 1) return (int)launch<bf16_bits, bf16_bits>(w, nbr, u, out, n, args, vec, s);
    return (int)cudaErrorInvalidValue;
}

// Largest k the launch parameters hold.
extern "C" int gossip_mix_max_neighbors() { return GOSSIP_MIX_MAX_NEIGHBORS; }
