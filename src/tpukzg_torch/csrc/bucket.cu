// B3: inclusive segmented EC-sum scan over sorted bucket keys.
//
// Replaces tpukzg/pallas/bucket.py::_scan_kernel.  On the TPU the grid
// ran (row, tile) steps in order on one core and carried the trailing
// segment's sum from one tile to the next in scratch memory.  Hopper
// blocks run in no fixed order, so here ONE BLOCK PER ROW walks its
// row's tiles in order and keeps that carry (point and key) in shared
// memory.  Within a tile, a segmented Hillis-Steele scan runs on points
// held in shared memory: two buffers (read one, write the other), each
// point 36 32-bit words (144 bytes), word-major so that neighbouring
// lanes hit neighbouring banks.  A tile holds up to 768 lanes
// (2 x 768 x 144 bytes + keys = 224 KB of the SM's 227 KB), so the main
// path's rows (513 and 255 lanes) are one tile each and the scan adds in
// the same order as the reference's `loop` scan.
//
// What bounds it on the H100: integer multiplies.  A step of the scan
// is one complete add (12 Fp products) per lane whose partner lies in
// its segment, log2(n) steps, against one read and one write of the
// coordinates.  Occupancy is the weak point of this first version: one
// block (256 threads) per row, and the main path has 64 rows, so 64 of
// the 132 SMs work; filling the card (several blocks per row with a
// second pass for the carries) is left for a later version.
//
// Lanes are not padded: the reference padded each row with sentinel-
// keyed lanes above all real lanes, which never reach a real lane; the
// kernel stops at the row's length instead.
#include "ec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 768;
constexpr int kWords = 36;
constexpr int32_t kSentinel = 0x7FFFFFF0;

__device__ __forceinline__ void smem_load(tk::G1& p, const uint32_t* buf,
                                          int tile, int l) {
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    p.x[j] = buf[j * tile + l];
    p.y[j] = buf[(12 + j) * tile + l];
    p.z[j] = buf[(24 + j) * tile + l];
  }
}

__device__ __forceinline__ void smem_store(uint32_t* buf, int tile, int l,
                                           const tk::G1& p) {
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    buf[j * tile + l] = p.x[j];
    buf[(12 + j) * tile + l] = p.y[j];
    buf[(24 + j) * tile + l] = p.z[j];
  }
}

// Coordinates are limb-major (24, g, n) int32 16-bit limbs; keys (g, n).
__global__ void __launch_bounds__(kThreads, 1)
seg_scan_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                int32_t* __restrict__ oz, const int32_t* __restrict__ x,
                const int32_t* __restrict__ y, const int32_t* __restrict__ z,
                const int32_t* __restrict__ keys, long long g, long long n,
                int tile) {
  extern __shared__ uint32_t smem[];
  uint32_t* buf0 = smem;
  uint32_t* buf1 = smem + kWords * tile;
  int32_t* kb = reinterpret_cast<int32_t*>(smem + 2 * kWords * tile);
  __shared__ uint32_t carry[kWords];
  __shared__ int32_t carry_key;

  const long long row = blockIdx.x;
  const long long ls = g * n;
  const int32_t* krow = keys + row * n;
  // carry starts as the point at infinity (0 : 1 : 0) with a key that
  // matches no digit
  if (threadIdx.x < kWords)
    carry[threadIdx.x] = (threadIdx.x >= 12 && threadIdx.x < 24)
                             ? tk::kFpOne[threadIdx.x - 12]
                             : 0u;
  if (threadIdx.x == 0) carry_key = kSentinel;

  for (long long t0 = 0; t0 < n; t0 += tile) {
    const int len = (int)min((long long)tile, n - t0);
    for (int l = threadIdx.x; l < len; l += kThreads) {
      const long long off = row * n + t0 + l;
      tk::G1 p;
      tk::load_words<tk::FpT>(p.x, x + off, ls);
      tk::load_words<tk::FpT>(p.y, y + off, ls);
      tk::load_words<tk::FpT>(p.z, z + off, ls);
      smem_store(buf0, tile, l, p);
      kb[l] = krow[t0 + l];
    }
    __syncthreads();

    uint32_t* cur = buf0;
    uint32_t* nxt = buf1;
    for (int d = 1; d < len; d <<= 1) {
      for (int l = threadIdx.x; l < len; l += kThreads) {
        tk::G1 p;
        smem_load(p, cur, tile, l);
        if (l >= d && kb[l] == kb[l - d]) {
          tk::G1 q;
          smem_load(q, cur, tile, l - d);
          tk::ec_add(p, p, q);
        }
        smem_store(nxt, tile, l, p);
      }
      __syncthreads();
      uint32_t* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }

    // add the previous tile's trailing-segment sum into the lanes of the
    // same key, then write the tile out
    for (int l = threadIdx.x; l < len; l += kThreads) {
      tk::G1 p;
      smem_load(p, cur, tile, l);
      if (kb[l] == carry_key) {
        tk::G1 q;
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          q.x[j] = carry[j];
          q.y[j] = carry[12 + j];
          q.z[j] = carry[24 + j];
        }
        tk::ec_add(p, p, q);
        smem_store(cur, tile, l, p);
      }
      const long long off = row * n + t0 + l;
      tk::store_limbs<tk::FpT>(ox + off, ls, p.x);
      tk::store_limbs<tk::FpT>(oy + off, ls, p.y);
      tk::store_limbs<tk::FpT>(oz + off, ls, p.z);
    }
    __syncthreads();
    // the new carry: the tile's last lane (keys are sorted: its key is
    // the tile's largest)
    if (threadIdx.x < kWords)
      carry[threadIdx.x] = cur[threadIdx.x * tile + len - 1];
    if (threadIdx.x == 0) carry_key = kb[len - 1];
    __syncthreads();
  }
}

}  // namespace

extern "C" int tpukzg_seg_scan(void* ox, void* oy, void* oz, const void* x,
                               const void* y, const void* z, const void* keys,
                               long long g, long long n, void* stream) {
  const int tile = (int)(n < kMaxTile ? n : kMaxTile);
  const size_t smem = (size_t)(2 * kWords + 1) * tile * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      seg_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  seg_scan_kernel<<<(unsigned)g, kThreads, smem, (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)x,
      (const int32_t*)y, (const int32_t*)z, (const int32_t*)keys, g, n, tile);
  return (int)cudaGetLastError();
}
