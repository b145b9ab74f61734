// Hopper (sm_90a) building blocks for the port's tensor-core kernels, in
// inline PTX: mbarriers, TMA tile loads, thread-block clusters (barriers
// and distributed shared memory), wgmma with its shared-memory
// descriptors, and the map from a wgmma accumulator element to its row and
// column.  The bf16 and fp16 flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu), block-sparse kernel
// (sparse_attention.cu) and ragged paged prefill kernel
// (ragged_paged_attention.cu) are built from them.
//
// Element types.  The wgmma wrappers, acc_to_a and the tensor maps take the
// tile's element type E, __nv_bfloat16 or __half (no default: a call must
// name it, so no fp16 tile is read as bf16 by omission): both are 2
// bytes, so every tile, box, swizzle and descriptor below is the same for
// both; only the instruction's operand type (.bf16 / .f16), the packing of
// fp32 values into A-operand registers and the tensor map's data type
// differ (is_f16, pack2, map_type).
//
// Shared-memory tiles.  A tile of R rows by D columns (one head's rows of
// a [B, S, Hx, D] tensor, D 64, 80, 96, 128 or 256) is loaded by TMA as
// boxes<D>() boxes of R rows by 64 columns, each R * 128 bytes, with the
// 128-byte swizzle: the 16-byte chunk c of row r lands at chunk c ^ (r % 8)
// of that row, so an 8-row group is one 1024-byte swizzle atom.  At D = 80
// and 96 the second box reaches past D: TMA reads only the D columns that
// exist and fills the rest of the box with zeros, which no product reads.
// Tiles start on 1024-byte boundaries, where the swizzle pattern of TMA and
// of wgmma line up.  The same tile feeds wgmma two ways:
//   K-major (the D columns are the product's depth, e.g. K in Q K^T):
//     desc_kmajor(tile + kslice(k, box)) is the k-th 16-column slice, k <
//     D / 16: slices 0-3 in the first box, 4 and up in the second (eight
//     at D = 128, six at 96, five at 80, four at 64; ``box`` = R * 128, the
//     bytes of one box);
//   MN-major (the rows are the depth, e.g. V in P V): desc_mnmajor(tile +
//     k * 2048, box) is the k-th 16-row slice, its columns across the
//     boxes, with the transpose bit set on the instruction; D is then the
//     product's N (wgmma_rs<E, D>: m64nD, the first 64 columns in the first
//     box's swizzle atoms, the rest in the second's).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run
                   // time through cudaGetDriverEntryPoint, not linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

constexpr int kBoxCols = 64;             // columns of a TMA box (128 bytes)
constexpr int kAtomBytes = 1024;         // 8 rows of 128 bytes

// The 64-column boxes of a D-column tile, and the columns they hold: a
// tile's shared-memory size is R * box_cols<D>() * 2 bytes.
template <int D>
__host__ __device__ constexpr int boxes() {
  static_assert(D == 64 || D == 80 || D == 96 || D == 128 || D == 256,
                "the tensor-core tiles take head dims 64, 80, 96, 128 and "
                "256");
  return (D + kBoxCols - 1) / kBoxCols;
}
template <int D>
__host__ __device__ constexpr int box_cols() {
  return boxes<D>() * kBoxCols;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// After the initialising thread's mbar_init calls, before __syncthreads.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// (mbar_arrive and mbar_wait also take the barrier's shared-memory
// address as a 32-bit value, which a loop can step through without a
// 64-bit pointer.)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  mbar_arrive(smem_u32(bar));
}

// One arrival that also announces ``bytes`` of TMA data to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Announce ``bytes`` of TMA data to come, without an arrival (the thread
// arrives later, once its own writes for the phase are done).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(smem_u32(bar), parity);
}

// ---- TMA -----------------------------------------------------------------

// Box at coordinates (c0, c1, c2, c3) of a 4-d tensor map -> dst; its bytes
// complete a transaction on ``bar``.  One thread issues it.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Box at coordinates (c0, c1) of a 2-d tensor map, and (c0, c1, c2) of a
// 3-d one -> dst, as tma_load_4d.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Rows [r0, r0 + R) of head hx, batch b, of the tensor behind ``map`` (made
// by make_head_map with box rows R and head dim D) -> the boxes<D>() boxes
// of 64 columns at dst, dst + R * 128, ...; columns past D read as zeros,
// and every box's full R * 128 bytes complete the transaction on ``bar``.
template <int D>
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int rows, int hx,
                                              int r0, int b) {
#pragma unroll
  for (int c = 0; c < boxes<D>(); ++c)
    tma_load_4d(static_cast<char*>(dst) + c * rows * kBoxCols * 2, map, bar,
                c * kBoxCols, hx, r0, b);
}

// ---- thread-block clusters -------------------------------------------------

// This block's rank in its cluster, and the cluster's size (1 when the
// kernel was launched without a cluster dimension).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// Every thread of every block of the cluster: arrive (release: this
// thread's shared-memory writes become visible to the cluster), then wait
// for all of them (acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared-memory address ``addr`` (of this block) as the same offset
// in block ``rank`` of the cluster, for ld.shared::cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr,
                                                 uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// Four floats from a cluster shared-memory address (cluster_addr).  No
// memory clobber: loads issued back to back stay in flight together; the
// cluster barriers around them (volatile, with a clobber) keep their
// order.
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// ---- register budget of warp-specialised kernels ---------------------------

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// K-major operand: rows of 128 bytes along the depth, 8-row atoms 1024
// bytes apart (the leading offset is unused with this swizzle).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return make_desc(addr, 16, kAtomBytes);
}

// MN-major operand (transposed): 64-column atoms ``half`` bytes apart
// along N, 8-row groups 1024 bytes apart along the depth.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr,
                                                 uint32_t half) {
  return make_desc(addr, half, kAtomBytes);
}

// Byte offset of the k-th 16-column depth slice of a K-major tile whose
// 64-column boxes are ``box`` bytes long: slices 0-3 lie in the first box,
// 4-7 in the second (a tile of D columns walks k < D / 16).
__device__ __forceinline__ uint32_t kslice(int k, uint32_t box) {
  return (k / 4) * box + (k % 4) * 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma registers across
// this point (around the asynchronous products' issue and wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The four wrappers below are one asm statement each, stamped with the
// operand type by a macro (TY: "bf16" or "f16"); E picks the stamp.
template <typename E>
__host__ __device__ constexpr bool is_f16() {
  static_assert(std::is_same<E, __nv_bfloat16>::value ||
                    std::is_same<E, __half>::value,
                "tensor-core tiles are bf16 or fp16");
  return std::is_same<E, __half>::value;
}

#define DS_WGMMA_SS_N128(TY)                                        \
  asm volatile(                                                     \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                            \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                      \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                    \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                    \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                    \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                    \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                    \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                   \
      "%64, %65, p, 1, 1, 0, 0;\n}\n"                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),             \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),             \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),         \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),         \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),         \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),         \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),         \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),         \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),         \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])          \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

#define DS_WGMMA_SS_N64(TY)                                        \
  asm volatile(                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                 \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                           \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                     \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                   \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                  \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                              \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),            \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),            \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),          \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),        \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),        \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),        \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])         \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

#define DS_WGMMA_RS_N128(TY)                                             \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"      \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                           \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                         \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                         \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                         \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                         \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                         \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                        \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                  \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),              \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),              \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),              \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),              \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),              \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),              \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),              \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),              \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),              \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),              \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),              \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

#define DS_WGMMA_RS_N64(TY)                                              \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"       \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                           \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                         \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                        \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                  \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),              \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),              \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),              \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

#define DS_WGMMA_RS_N80(TY)                                              \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n80k16.f32." TY "." TY " {"       \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                           \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                         \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                         \
      "%32, %33, %34, %35, %36, %37, %38, %39}, "                        \
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                  \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),              \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),              \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),              \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),              \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),              \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

#define DS_WGMMA_RS_N96(TY)                                              \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY " {"       \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                           \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                         \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                         \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                         \
      "%40, %41, %42, %43, %44, %45, %46, %47}, "                        \
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                  \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),              \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),              \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),              \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),              \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),              \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),              \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),              \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

#define DS_WGMMA_RS_N256(TY)                                             \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"      \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                               \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                       \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                       \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                       \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                       \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                       \
      "%56, %57, %58, %59, %60, %61, %62, %63, "                       \
      "%64, %65, %66, %67, %68, %69, %70, %71, "                       \
      "%72, %73, %74, %75, %76, %77, %78, %79, "                       \
      "%80, %81, %82, %83, %84, %85, %86, %87, "                       \
      "%88, %89, %90, %91, %92, %93, %94, %95, "                       \
      "%96, %97, %98, %99, %100, %101, %102, %103, "                   \
      "%104, %105, %106, %107, %108, %109, %110, %111, "               \
      "%112, %113, %114, %115, %116, %117, %118, %119, "               \
      "%120, %121, %122, %123, %124, %125, %126, %127}, "              \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),              \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),            \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),            \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),            \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),            \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),            \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),            \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),            \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),            \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),            \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),            \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),            \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),            \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),            \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),            \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),            \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),            \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),            \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),            \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),            \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),            \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),            \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),        \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),        \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),        \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),        \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),        \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),        \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B K-major in shared
// memory; D is zeroed first unless ``accumulate``.
template <typename E>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int accumulate) {
  if constexpr (is_f16<E>()) DS_WGMMA_SS_N128("f16");
  else DS_WGMMA_SS_N128("bf16");
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B K-major in shared
// memory; D is zeroed first unless ``accumulate``.
template <typename E>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  if constexpr (is_f16<E>()) DS_WGMMA_SS_N64("f16");
  else DS_WGMMA_SS_N64("bf16");
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers (four packed
// pairs per thread, the layout of an accumulator's 16-column slice), B
// MN-major in shared memory (read transposed).
template <typename E>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  if constexpr (is_f16<E>()) DS_WGMMA_RS_N128("f16");
  else DS_WGMMA_RS_N128("bf16");
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers as in
// wgmma_rs_n128, B MN-major in shared memory (one 64-column atom).
template <typename E>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  if constexpr (is_f16<E>()) DS_WGMMA_RS_N64("f16");
  else DS_WGMMA_RS_N64("bf16");
}

// D[64 x N] += A[64 x 16] * B[16 x N] with B MN-major, N the head dim
// (64, 80, 96, 128 or 256): the products whose N is D (O += P V, dQ += dS
// K, dV += P^T dO, dK += dS^T Q).  At N = 80 and 96, B's columns 64 and up
// are the first 16 or 32 of the second box's atoms (the descriptor's
// leading offset, ``box``, reaches them as at N = 128); its zero columns
// past N are not read.  At N = 256 (O += P V and dQ += dS K at head dim
// 256) the four boxes' atoms are ``box`` bytes apart in the same way.
template <typename E, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  static_assert(N == 64 || N == 80 || N == 96 || N == 128 || N == 256,
                "wgmma_rs takes N = 64, 80, 96, 128 or 256");
  if constexpr (N == 256) {
    if constexpr (is_f16<E>()) DS_WGMMA_RS_N256("f16");
    else DS_WGMMA_RS_N256("bf16");
  } else if constexpr (N == 128) {
    wgmma_rs_n128<E>(d, a, desc_b);
  } else if constexpr (N == 96) {
    if constexpr (is_f16<E>()) DS_WGMMA_RS_N96("f16");
    else DS_WGMMA_RS_N96("bf16");
  } else if constexpr (N == 80) {
    if constexpr (is_f16<E>()) DS_WGMMA_RS_N80("f16");
    else DS_WGMMA_RS_N80("bf16");
  } else {
    wgmma_rs_n64<E>(d, a, desc_b);
  }
}

#undef DS_WGMMA_SS_N128
#undef DS_WGMMA_SS_N64
#undef DS_WGMMA_RS_N128
#undef DS_WGMMA_RS_N64
#undef DS_WGMMA_RS_N96
#undef DS_WGMMA_RS_N80
#undef DS_WGMMA_RS_N256

// ---- accumulator layout ----------------------------------------------------

// Element i of thread t's (t = 0..127 in the warpgroup) m64nN fp32
// accumulator is row acc_row(i, t) (0..63) and column acc_col(i, t): warp
// t / 32 owns rows 16 (t / 32) .. +15, a row is spread over the 4 lanes of
// a quad, each holding column pairs 8 j + 2 (t % 4) + {0, 1}.
__device__ __forceinline__ int acc_row(int i, int t) {
  return (t / 32) * 16 + (t % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i / 4) + 2 * (t % 4) + (i % 2);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit, denormal results flushed to 0: one
// MUFU.EX2 (exp2f adds a denormal range check and a select per call).
// x = -1e30-scale gives exactly 0, which masked scores rely on.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to E and packed into one 32-bit register, lo in
// the low half: an A-operand pair, or two adjacent output columns.
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_f16<E>()) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack2<__nv_bfloat16>(lo, hi);
}

// The 16-column slice j of an fp32 accumulator as E A-operand registers of
// the next product (wgmma's register-A layout matches the accumulator's
// slice by slice): a[4 j .. 4 j + 3] from acc[8 j .. 8 j + 7].
template <typename E, int N>
__device__ __forceinline__ void acc_to_a(const float (&acc)[N],
                                         uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack2<E>(acc[2 * i], acc[2 * i + 1]);
}

// ---- host: tensor maps -----------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map's data type of an element type.
template <typename E>
constexpr CUtensorMapDataType map_type() {
  return is_f16<E>() ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// Tensor map of a contiguous E tensor of ``rank`` dims (dims[0] the
// columns, contiguous; strides in bytes of dims 1..rank-1), boxes of
// ``box`` elements per dim (box[0] = 64 columns: 128 bytes), 128-byte
// swizzle.  Elements past a dim's end (and only those) read as zeros.
// Built at every launch: nothing is cached by pointer, and the map travels
// by value in the kernel's parameters, so CUDA-graph capture keeps it.
// Returns 0 or a CUDA error code.
template <typename E>
inline int make_map(CUtensorMap* map, const void* ptr, int rank,
                    const cuuint64_t* dims, const cuuint64_t* strides,
                    const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, map_type<E>(), rank, const_cast<void*>(ptr),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Tensor map of a contiguous E [B, S, Hx, D] tensor (D 64, 80, 96, 128 or
// 256: rows of a multiple of 16 bytes) as 4-d (column, head, row, batch),
// boxes of ``rows`` rows of one head by 64 columns.  Rows at or past S, and
// columns at or past D, read as zeros.
template <typename E>
inline int make_head_map(CUtensorMap* map, const void* ptr, int B, int S,
                         int Hx, int rows, int D) {
  const cuuint64_t row = D * sizeof(E);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(Hx),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {row, row * Hx, row * Hx * S};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(rows), 1};
  return make_map<E>(map, ptr, 4, dims, strides, box);
}

}  // namespace hopper
