// Fused int8 quantize-pack for Hopper (sm_90a): per row of an (R, C) float
// buffer
//
//     amax   = max |x|
//     scale  = amax · fl32(1/127)  if amax > 0, else 1
//     values = rint(x / scale)     as int8 (round half to even)
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_pack/kernel.py
// (quantize_pack_2d, body _kernel). It matches the plain PyTorch version
// (../ref.py) bit for bit: x / scale is an IEEE division (__fdiv_rn, never a
// multiply by the reciprocal), rintf rounds half to even as jnp.round does,
// and the build uses no fast-math flag. The scale multiplies amax by the
// float32 reciprocal of 127, because that is what the reference computes:
// XLA compiles its `amax / 127.0` into that multiply.
//
// What bounds it: bytes. Each element is read once (4 bytes float32, 2 bf16)
// and written once as 1 byte, plus one 4-byte scale per row; a handful of
// operations per element. On the compressed gossip lane at granite-3-2b
// width (M=4 replicas, 10,748,672 float32 rows of 128) that is 5.503 GB
// read and 1.419 GB written, about 2.07 ms at the H100 SXM's 3.35 TB/s.
// The design: one warp per 128-element row (the bus's row), each lane one
// 16-byte (float32) or 8-byte (bf16) load of 4 consecutive elements, a
// warp-shuffle max, and one 4-byte store of the 4 packed int8 values; warps
// walk the rows in a grid-stride loop. Other widths and unaligned buffers
// take a generic path: one warp per row, the lanes strided over the row.
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

// 1/127 rounded to float32
#define RECIP_127 0x1.020408p-7f

typedef uint16_t bf16_bits;   // bf16 carried as its 16 bits

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16_bits x) {
    return __uint_as_float(((unsigned int)x) << 16);   // exact
}

// Four consecutive elements at p (aligned to 4 elements) as floats.
__device__ __forceinline__ void load4(const float* __restrict__ p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const bf16_bits* __restrict__ p, float* v) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);   // little endian
    v[0] = __uint_as_float(a.x << 16);
    v[1] = __uint_as_float(a.x & 0xffff0000u);
    v[2] = __uint_as_float(a.y << 16);
    v[3] = __uint_as_float(a.y & 0xffff0000u);
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    return m;   // every lane holds the row's max (max is exact in any order)
}

__device__ __forceinline__ float row_scale(float amax) {
    return amax > 0.0f ? __fmul_rn(amax, RECIP_127) : 1.0f;
}

__device__ __forceinline__ signed char quantize(float x, float scale) {
    return (signed char)(int)rintf(__fdiv_rn(x, scale));
}

// C == 128, x aligned to 4 elements: one warp per row, 4 elements per lane.
template <typename T>
__global__ void __launch_bounds__(256)
quant_pack_row128(const T* __restrict__ x, signed char* __restrict__ values,
                  float* __restrict__ scales, long long rows) {
    const int lane = threadIdx.x & 31;
    const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
    for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; r < rows;
         r += nwarps) {
        const long long base = r * 128 + lane * 4;
        float v[4];
        load4(x + base, v);
        const float m = warp_max(fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                                       fmaxf(fabsf(v[2]), fabsf(v[3]))));
        const float s = row_scale(m);
        *reinterpret_cast<char4*>(values + base) =
            make_char4(quantize(v[0], s), quantize(v[1], s), quantize(v[2], s),
                       quantize(v[3], s));
        if (lane == 0) scales[r] = s;
    }
}

// Any C and any alignment: one warp per row, lanes strided over the row;
// the second pass re-reads the row (from L1/L2).
template <typename T>
__global__ void __launch_bounds__(256)
quant_pack_rows(const T* __restrict__ x, signed char* __restrict__ values,
                float* __restrict__ scales, long long rows, int cols) {
    const int lane = threadIdx.x & 31;
    const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
    for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; r < rows;
         r += nwarps) {
        const T* xr = x + r * cols;
        float m = 0.0f;
        for (int c = lane; c < cols; c += 32) m = fmaxf(m, fabsf(to_f32(xr[c])));
        const float s = row_scale(warp_max(m));
        for (int c = lane; c < cols; c += 32) values[r * cols + c] = quantize(to_f32(xr[c]), s);
        if (lane == 0) scales[r] = s;
    }
}

template <typename T>
static cudaError_t launch(const void* x, void* values, void* scales, long long rows,
                          int cols, bool vectorized, cudaStream_t stream) {
    const int threads = 256;   // 8 warps, 8 rows in flight per block
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    long long blocks = (rows + 7) / 8;
    const long long cap = (long long)sms * 8;   // 8 × 256 threads fill an SM
    if (blocks > cap) blocks = cap;
    const T* xp = static_cast<const T*>(x);
    signed char* vp = static_cast<signed char*>(values);
    float* sp = static_cast<float*>(scales);
    if (vectorized) {
        quant_pack_row128<T><<<(unsigned)blocks, threads, 0, stream>>>(xp, vp, sp, rows);
    } else {
        quant_pack_rows<T><<<(unsigned)blocks, threads, 0, stream>>>(xp, vp, sp, rows, cols);
    }
    return cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16. `values` is (rows, cols) int8,
// `scales` (rows,) float32. `vectorized` asserts cols == 128 and x aligned
// to 4 elements (values comes fresh from the allocator, so it is aligned).
// Returns a cudaError_t.
extern "C" int quant_pack(const void* x, void* values, void* scales, long long rows,
                          int cols, int dtype, int vectorized, void* stream) {
    if (rows <= 0 || cols <= 0 || (vectorized && cols != 128)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = vectorized != 0;
    if (dtype == 0) return (int)launch<float>(x, values, scales, rows, cols, vec, s);
    if (dtype == 1) return (int)launch<bf16_bits>(x, values, scales, rows, cols, vec, s);
    return (int)cudaErrorInvalidValue;
}
