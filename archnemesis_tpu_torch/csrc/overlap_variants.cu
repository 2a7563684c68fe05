// A/B variants of the random-overlap combine, for Hopper (sm_90a): the
// combine kernel (overlap_combine.cu, combine_primal_kernel) taken apart
// stage by stage, in its own layout and on its own row code
// (overlap_row.cuh).
//
// Replaces the TPU kernel combine_lean (tools/bench_overlap_variants.py:131,
// body make_lean_kernel :38, pallas_call :151) and computes what each of
// its modes returns, on (R, NG) float32 inputs a, b with the static pair
// weights w2[i*NG + j] = del_g[i] del_g[j] and the g-bin edges (the plain
// PyTorch versions are in ops/overlap_variants.py):
//   full     the combine: the NG*NG pair sums a[r,i] + b[r,j] sorted with
//            their weights, the inclusive prefix sum of the sorted weights,
//            each output bin the overlap-weighted mean of the keys over
//            [edge_j, edge_j+1), numerator over max(denominator, 1e-37);
//   edges    the same sort and prefix sum, rebinned through the cumulative
//            edge sums S(x) = sum_e key_e clip(x - glo_e, 0, w_e) and W(x)
//            likewise: bin j = (S(x_j+1) - S(x_j)) / max(W(x_j+1) - W(x_j),
//            1e-37);
//   sortonly the NG smallest pair sums in ascending order;
//   rollonly the pair-sum row padded with the float32 maximum to e_ref, the
//            next power of two of NG*NG, rotated by S = roll_shift(NG) (the
//            sum of the TPU network's stage strides: jnp.roll by each in
//            turn), its first NG columns.
//
// Design, mode by mode (NG 1 .. 32, as kernel 1):
//   full     combine_row of kernel 1 (steps 1-6 of overlap_combine.cu: a
//            merge of the NG presorted runs in shared memory, the lane scan
//            of the weights, lane j's walk of bin j), with the tool's
//            1e-37 floor. On rows whose bins' overlaps sum to their widths
//            (the floor never binds) it is kernel 1's result bit for bit;
//   edges    steps 1-3 of combine_row (the merge), then edge_search_rebin:
//            in one scan pass the prefix sums of the weights (kernel 1's
//            scan, the same bits) and of key*weight. Lane j < NG then finds
//            edge j+1 in the weight prefix sums, by kernel 1's binary search
//            (128-eps slack below the edge) and a short walk to the element
//            that straddles it, and reads S and W there from the prefix sums
//            and that element alone; lane 0 also takes edge 0; one shuffle
//            gives bin j. NG + 1 searches of equal cost, where kernel 1's
//            step 5 walks bins of unequal length: the A/B test of that step;
//   sortonly steps 1-3 of combine_row on the keys alone (Key, 4-byte
//            elements, no packed index pair), writing the first NG: the
//            merge's cost in kernel 1's layout, and beside kernel 1 what its
//            8-byte element costs;
//   rollonly one coalesced pass: the block's slabs of a and b staged in
//            shared memory by 16-byte loads (where both start on 16 bytes),
//            then out[r, c] = padded[(c - S) mod e_ref] with padded[e] =
//            a[r, e / NG] + b[r, e % NG] for e < NG*NG, written coalesced:
//            the device-memory floor of any combine at these shapes.
// Rows per block: the TPU tool's row tile t becomes t rows per block, taken
// in turn by the block's warps (full, edges, sortonly), with the warp count
// of kernel 1's launch (resident_warps, at most t); rollonly stages t rows
// a block with 256 threads.
//
// What bounds each mode on the card (chip_smoke.py:variant_bound_ms, which
// counts what the mode's function needs): full and edges, the combine's
// operations (nembench/harness/bounds.py:combine_ops_per_row); sortonly,
// the merge of NG presorted runs of NG pair sums (operations) or the bytes,
// the larger; rollonly, the bytes in and out. The row modes pay what kernel
// 1 pays beyond that, the shared-memory pipe (overlap_combine.cu); rollonly
// moves each byte once.

#include "overlap_row.cuh"

namespace {

enum Mode {
  kModeFull = 0,
  kModeEdges = 1,
  kModeSortOnly = 2,
  kModeRollOnly = 3
};

// the rebins' denominator floor (the TPU tool's)
struct ToolFloor {
  __device__ static float tiny() { return 1e-37f; }
};

constexpr int kRollThreads = 256;

// Shared memory of the row modes: the weight table and edges per block
// (none for sortonly), and each warp's row buffers.
template <int MODE>
__host__ __device__ size_t mode_block_bytes() {
  return MODE == kModeSortOnly ? 0 : primal_block_bytes<float>();
}
template <int MODE>
__host__ __device__ size_t mode_warp_bytes(int n) {
  return MODE == kModeSortOnly ? row_warp_bytes<float, Key<float>>(n)
                               : primal_warp_bytes<float>(n);
}

// The row modes: `tile` rows per block, warp w taking rows w, w + W, ..
// of the block's tile in turn.
template <int MODE>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
variant_row_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ w2,
                   const float* __restrict__ edges, float* __restrict__ out,
                   int rows, int ng, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w2s = reinterpret_cast<float*>(smem_raw);
  float* edge_s = w2s + kPairSlots;
  if constexpr (MODE != kModeSortOnly) {
    load_tables(w2s, edge_s, w2, edges, ng);
  }
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  unsigned char* smem = smem_raw + mode_block_bytes<MODE>() +
                        warp * mode_warp_bytes<MODE>(ng * ng);
  const int r0 = blockIdx.x * tile;
  const int r_end = min(r0 + tile, rows);
  for (int row = r0 + warp; row < r_end; row += warps) {
    if constexpr (MODE == kModeFull) {
      combine_row<float, false, ToolFloor>(a, b, w2s, edge_s, smem, out, row,
                                           ng, nullptr);
    } else if constexpr (MODE == kModeEdges) {
      combine_row<float, false, ToolFloor, kEdgeSearch>(
          a, b, w2s, edge_s, smem, out, row, ng, nullptr);
    } else {
      combine_row<float, false, ToolFloor, kMergeOnly, Key<float>>(
          a, b, w2s, edge_s, smem, out, row, ng, nullptr);
    }
    __syncwarp();  // the row's buffers are free for the warp's next row
  }
}

// rollonly: the block's `tile` rows in one pass.
__global__ void __launch_bounds__(kRollThreads)
roll_kernel(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ out, int rows, int ng, int e_ref, int shift,
            int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xa = reinterpret_cast<float*>(smem_raw);
  float* xb = xa + round_up4(tile * ng);
  const int n = ng * ng;
  const int r0 = blockIdx.x * tile;
  const size_t off = static_cast<size_t>(r0) * ng;
  const int len = min(tile, rows - r0) * ng;
  const float* sa = a + off;
  const float* sb = b + off;
  int head = 0;
  if (((reinterpret_cast<uintptr_t>(sa) | reinterpret_cast<uintptr_t>(sb)) &
       15) == 0) {
    const int words = len / 4;
    for (int k = threadIdx.x; k < words; k += blockDim.x) {
      reinterpret_cast<float4*>(xa)[k] = reinterpret_cast<const float4*>(sa)[k];
      reinterpret_cast<float4*>(xb)[k] = reinterpret_cast<const float4*>(sb)[k];
    }
    head = words * 4;
  }
  for (int k = head + threadIdx.x; k < len; k += blockDim.x) {
    xa[k] = sa[k];
    xb[k] = sb[k];
  }
  __syncthreads();
  float* o = out + off;
  for (int k = threadIdx.x; k < len; k += blockDim.x) {
    const int r = k / ng;
    const int c = k - r * ng;
    const int e = (c - shift) & (e_ref - 1);  // (c - S) mod e_ref
    const int ia = e / ng;
    o[k] = e < n ? xa[r * ng + ia] + xb[r * ng + e - ia * ng] : FLT_MAX;
  }
}

size_t roll_smem(int tile, int ng) {
  return 2 * static_cast<size_t>(round_up4(tile * ng)) * sizeof(float);
}

template <int MODE>
cudaError_t launch_rows(const float* a, const float* b, const float* w2,
                        const float* edges, float* out, int rows, int ng,
                        int tile, int device, cudaStream_t s) {
  const auto kernel = variant_row_kernel<MODE>;
  int sm_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return err;
  const size_t block_bytes = mode_block_bytes<MODE>();
  const size_t per_warp = mode_warp_bytes<MODE>(ng * ng);
  const int warps = resident_warps(block_bytes, per_warp, sm_smem,
                                   min(tile, kMaxWarps));
  if (warps == 0) return cudaErrorInvalidValue;
  const size_t smem = block_bytes + warps * per_warp;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((rows + tile - 1) / tile);
  kernel<<<grid, warps * kWarp, smem, s>>>(a, b, w2, edges, out, rows, ng,
                                           tile);
  return cudaGetLastError();
}

cudaError_t launch_roll(const float* a, const float* b, float* out, int rows,
                        int ng, int e_ref, int shift, int tile,
                        cudaStream_t s) {
  const size_t smem = roll_smem(tile, ng);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        roll_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((rows + tile - 1) / tile);
  roll_kernel<<<grid, kRollThreads, smem, s>>>(a, b, out, rows, ng, e_ref,
                                               shift, tile);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes): one launch of `mode` (0 full,
// 1 edges, 2 sortonly, 3 rollonly) at `rows_per_block` rows per block on
// float32 (rows, ng) a, b; w2 holds the ng*ng pair weights, edges the
// ng + 1 bin edges (neither read by sortonly or rollonly); e_ref (a power
// of two >= ng*ng) and shift are rollonly's padded length and rotation.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.
extern "C" int overlap_variant_f32(const void* a, const void* b,
                                   const void* w2, const void* edges,
                                   void* out, int rows, int ng, int mode,
                                   int rows_per_block, int e_ref, int shift,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return 0;
  if (ng < 1 || ng > kWarp || rows_per_block < 1 || e_ref < ng * ng ||
      (e_ref & (e_ref - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  const float* pw = static_cast<const float*>(w2);
  const float* pe = static_cast<const float*>(edges);
  float* po = static_cast<float*>(out);
  switch (mode) {
    case kModeFull:
      err = launch_rows<kModeFull>(pa, pb, pw, pe, po, rows, ng,
                                   rows_per_block, device, s);
      break;
    case kModeEdges:
      err = launch_rows<kModeEdges>(pa, pb, pw, pe, po, rows, ng,
                                    rows_per_block, device, s);
      break;
    case kModeSortOnly:
      err = launch_rows<kModeSortOnly>(pa, pb, pw, pe, po, rows, ng,
                                       rows_per_block, device, s);
      break;
    case kModeRollOnly:
      err = launch_roll(pa, pb, po, rows, ng, e_ref, shift, rows_per_block,
                        s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
