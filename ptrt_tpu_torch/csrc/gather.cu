// row_gather: out[r, :] = table[idx[r], :] (row-major) or
// out[:, r] = table[idx[r], :] (field-major).
//
// Replaces: the Pallas row-gather probes of tools/probe_pallas_gather_r5.py
// (mk, :39), tools/probe_pallas_gather2_r5.py (mk :35, oh_kernel :127,
// taa_kernel :153) and tools/prof_pallas_gather.py (make_take :66,
// make_taa :94, make_onehot :122, make_scalar_loop :153): every one of them
// computes out[r, :] = table[idx[r], :] (the one-hot variants on a bf16
// table).  On the engine's path it is ptrt_tpu/scene/materials.py
// MaterialTable.gather, the per-bounce fetch of each lane's 32-float
// material row.
//
// What bounds it on the card: memory traffic.  Each output element is one
// load and one store; the index is read once per row.  A 2,073,600-lane
// material gather writes 265 MB, ~80 us at 3.35 TB/s.
//
// What this design does about it: rows are copied in the widest unit the
// row length and alignment allow (16, 4 or 2 bytes), neighbouring threads on
// neighbouring units, so loads of a row and stores of the output coalesce.
// A table of at most 48 KB (the material table is 16 x 32 x 4 B = 2 KB) is
// staged in shared memory by every block of a grid-stride launch; larger
// tables (the probes' 256 KB - 1 MB) are read through L1/L2.  The
// field-major form writes one contiguous plane per field, so the shading
// code reads each field without strides; one thread per index walks the
// row's fields, and the threads of a warp store 32 neighbouring lanes of
// one plane at a time.  An index outside [0, n_rows) is clamped into it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStagedBytes = 48 * 1024;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ int clamp_index(int i, int n) {
    return min(max(i, 0), n - 1);
}

template <typename V>
__device__ __forceinline__ const V* stage(const V* table, int n, bool staged,
                                          V* smem) {
    if (!staged) return table;
    for (int k = threadIdx.x; k < n; k += blockDim.x) smem[k] = table[k];
    __syncthreads();
    return smem;
}

// row-major: one thread per V-unit of the output
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ table, int n_rows, int row_units,
                   const int* __restrict__ idx, long long n_idx,
                   V* __restrict__ out, bool staged) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const V* src = stage(table, n_rows * row_units, staged,
                         reinterpret_cast<V*>(smem_raw));
    const long long total = n_idx * row_units;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         e < total; e += stride) {
        const long long r = e / row_units;
        const int c = static_cast<int>(e - r * row_units);
        const int i = clamp_index(__ldg(idx + r), n_rows);
        out[e] = src[static_cast<long long>(i) * row_units + c];
    }
}

// field-major: one thread per index, out[f * n_idx + r]
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_fields_kernel(const T* __restrict__ table, int n_rows, int width,
                     const int* __restrict__ idx, long long n_idx,
                     T* __restrict__ out, bool staged) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const T* src = stage(table, n_rows * width, staged,
                         reinterpret_cast<T*>(smem_raw));
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         r < n_idx; r += stride) {
        const T* row = src + static_cast<long long>(
                                 clamp_index(__ldg(idx + r), n_rows)) * width;
        for (int f = 0; f < width; ++f) out[f * n_idx + r] = row[f];
    }
}

int blocks_for(long long work) {
    const long long b = (work + kThreads - 1) / kThreads;
    return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

template <typename V>
void launch_rows(const void* table, int n_rows, int row_bytes, const int* idx,
                 long long n_idx, void* out, cudaStream_t s) {
    const int units = row_bytes / static_cast<int>(sizeof(V));
    const long long bytes = static_cast<long long>(n_rows) * row_bytes;
    const bool staged = bytes <= kMaxStagedBytes;
    gather_rows_kernel<V><<<blocks_for(n_idx * units), kThreads,
                            staged ? bytes : 0, s>>>(
        static_cast<const V*>(table), n_rows, units, idx, n_idx,
        static_cast<V*>(out), staged);
}

template <typename T>
void launch_fields(const void* table, int n_rows, int width, const int* idx,
                   long long n_idx, void* out, cudaStream_t s) {
    const long long bytes = static_cast<long long>(n_rows) * width *
                            static_cast<long long>(sizeof(T));
    const bool staged = bytes <= kMaxStagedBytes;
    gather_fields_kernel<T><<<blocks_for(n_idx), kThreads,
                              staged ? bytes : 0, s>>>(
        static_cast<const T*>(table), n_rows, width, idx, n_idx,
        static_cast<T*>(out), staged);
}

}  // namespace

// elem_bytes: 4 (float32) or 2 (bfloat16); the copy is bit-exact.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a layout the
// kernels do not take.
extern "C" int ptrt_row_gather(const void* table, int n_rows, int width,
                               int elem_bytes, const int* idx,
                               long long n_idx, void* out, int field_major,
                               void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_rows <= 0 || width <= 0 || (elem_bytes != 4 && elem_bytes != 2))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_idx > 0) {
        if (field_major) {
            if (elem_bytes == 4)
                launch_fields<uint32_t>(table, n_rows, width, idx, n_idx, out,
                                        s);
            else
                launch_fields<uint16_t>(table, n_rows, width, idx, n_idx, out,
                                        s);
        } else {
            const int row_bytes = width * elem_bytes;
            const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                                    reinterpret_cast<uintptr_t>(out);
            if (row_bytes % 16 == 0 && align % 16 == 0)
                launch_rows<uint4>(table, n_rows, row_bytes, idx, n_idx, out,
                                   s);
            else if (row_bytes % 4 == 0 && align % 4 == 0)
                launch_rows<uint32_t>(table, n_rows, row_bytes, idx, n_idx,
                                      out, s);
            else
                launch_rows<uint16_t>(table, n_rows, row_bytes, idx, n_idx,
                                      out, s);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
