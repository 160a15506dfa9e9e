// BabyBear field arithmetic on the card: four kernels over int32 words in
// Montgomery form, the arithmetic itself in field.cuh.
//
// No Pallas kernel: the JAX package writes this arithmetic as u32 code
// (valida_tpu/field/babybear.py, field/ext.py) and XLA fuses it inside its
// jitted stages.  The port's plain versions (valida_tpu_torch/field) widen
// to int64 and take about 7 device passes for a product (12 for an
// extension product); each kernel here is one pass.
//
// (K1) field_elementwise: out = op(a, b) for the ops of field.cuh's `Op`,
//      each operand an int32 tensor read through strides (0 where it
//      broadcasts) or one scalar word; the output contiguous.
// (K2) field_ext_mul: the product mod x^5 - 2 of two extension operands,
//      the coefficient axis last (its stride given), leading dims
//      broadcast.
// (K3) field_inv: a^(p-2) per word (0 -> 0), by field.cuh's addition
//      chain.
// (K4) field_ext_inv: the inverse of one extension element per thread.
//
// What bounds them: K1 and K2, device memory (8-12 bytes a word for some
// 5-20 integer instructions; 60 bytes an element for 25 wide products and
// 5 reductions); K3 and K4, the integer units (39 products for 8 bytes a
// word; some 245 multiplies for 40 bytes an element).  So each kernel is
// one grid-stride pass that reads each operand word where it lies and
// writes each result once: no copy for a broadcast or a strided view.  A
// linear index becomes operand offsets by division over the dims (32-bit
// division below 2^31 elements); a layout of one dim, the common case
// after the wrapper merges dims, takes one multiply.
//
// Every entry launches on the caller's stream, allocates nothing and does
// not synchronise, so a CUDA graph may capture it.  The layout is a host
// array of int64 (valida_tpu_torch/field/babybear.py `_layout`):
//   [n, ndim, size[6], a_stride[6], b_stride[6], a_coef, b_coef]
// with n the elements (words for K1/K3, extension elements for K2/K4),
// dims outer to inner, strides in words.

#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int MAX_DIMS = 6;
constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 1 << 16;

struct Layout {
  int64_t n;
  int64_t ndim;
  int64_t size[MAX_DIMS];
  int64_t stride[2][MAX_DIMS];
  int64_t coef[2];
};

Layout read_layout(const int64_t* h) {
  Layout L;
  L.n = h[0];
  L.ndim = h[1];
  for (int d = 0; d < MAX_DIMS; ++d) {
    L.size[d] = h[2 + d];
    L.stride[0][d] = h[2 + MAX_DIMS + d];
    L.stride[1][d] = h[2 + 2 * MAX_DIMS + d];
  }
  L.coef[0] = h[2 + 3 * MAX_DIMS];
  L.coef[1] = h[3 + 3 * MAX_DIMS];
  return L;
}

// the two operands' word offsets of element i
template <typename Idx>
__device__ __forceinline__ void offsets(const Layout& L, Idx i, int64_t& oa,
                                        int64_t& ob) {
  if (L.ndim == 1) {
    oa = (int64_t)i * L.stride[0][0];
    ob = (int64_t)i * L.stride[1][0];
    return;
  }
  oa = 0;
  ob = 0;
#pragma unroll
  for (int d = MAX_DIMS - 1; d >= 0; --d) {
    if (d < L.ndim) {
      const Idx s = (Idx)L.size[d];
      const Idx q = i / s;
      const Idx r = i - q * s;
      oa += (int64_t)r * L.stride[0][d];
      ob += (int64_t)r * L.stride[1][d];
      i = q;
    }
  }
}

template <int OP, typename Idx>
__global__ void field_elementwise_kernel(const int32_t* __restrict__ a,
                                         const int32_t* __restrict__ b,
                                         int32_t a_word, int32_t b_word,
                                         int32_t* __restrict__ out,
                                         const Layout L) {
  const Idx step = (Idx)gridDim.x * blockDim.x;
  for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x; i < (Idx)L.n;
       i += step) {
    int64_t oa, ob;
    offsets<Idx>(L, i, oa, ob);
    const int32_t x = a ? a[oa] : a_word;
    const int32_t y = b ? b[ob] : b_word;
    out[i] = (int32_t)bbf::apply_elementwise<OP>(x, y);
  }
}

template <typename Idx>
__global__ void field_ext_mul_kernel(const int32_t* __restrict__ a,
                               const int32_t* __restrict__ b,
                               int32_t* __restrict__ out, const Layout L) {
  const Idx step = (Idx)gridDim.x * blockDim.x;
  for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x; i < (Idx)L.n;
       i += step) {
    int64_t oa, ob;
    offsets<Idx>(L, i, oa, ob);
    bbf::apply_ext_mul(a + oa, L.coef[0], b + ob, L.coef[1],
                       out + (int64_t)i * bbf::D);
  }
}

template <typename Idx>
__global__ void field_inv_kernel(const int32_t* __restrict__ a,
                           int32_t* __restrict__ out, const Layout L) {
  const Idx step = (Idx)gridDim.x * blockDim.x;
  for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x; i < (Idx)L.n;
       i += step) {
    int64_t oa, ob;
    offsets<Idx>(L, i, oa, ob);
    out[i] = bbf::apply_inv(a[oa]);
  }
}

template <typename Idx>
__global__ void field_ext_inv_kernel(const int32_t* __restrict__ a,
                               int32_t* __restrict__ out, const Layout L) {
  const Idx step = (Idx)gridDim.x * blockDim.x;
  for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x; i < (Idx)L.n;
       i += step) {
    int64_t oa, ob;
    offsets<Idx>(L, i, oa, ob);
    bbf::apply_ext_inv(a + oa, L.coef[0], out + (int64_t)i * bbf::D);
  }
}

bool valid(const Layout& L) {
  return L.n >= 0 && L.ndim >= 1 && L.ndim <= MAX_DIMS;
}

int blocks(const Layout& L) {
  const int64_t want = (L.n + THREADS - 1) / THREADS;
  return (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
}

// 32-bit indices while i + the grid's stride cannot pass 2^32
bool small(const Layout& L) { return L.n < ((int64_t)1 << 31); }

template <int OP>
void launch_elementwise(const int32_t* a, const int32_t* b, int32_t a_word,
                        int32_t b_word, int32_t* out, const Layout& L,
                        cudaStream_t s) {
  if (small(L))
    field_elementwise_kernel<OP, uint32_t><<<blocks(L), THREADS, 0, s>>>(
        a, b, a_word, b_word, out, L);
  else
    field_elementwise_kernel<OP, uint64_t><<<blocks(L), THREADS, 0, s>>>(
        a, b, a_word, b_word, out, L);
}

}  // namespace

// K1.  a or b null: that operand is the scalar word a_word or b_word.
extern "C" int field_elementwise_launch(int op, const void* a, const void* b,
                                        int a_word, int b_word, void* out,
                                        const void* layout, void* stream) {
  const Layout L = read_layout((const int64_t*)layout);
  if (!valid(L) || op < 0 || op >= bbf::N_OPS)
    return (int)cudaErrorInvalidValue;
  if (L.n == 0) return 0;
  const int32_t* pa = (const int32_t*)a;
  const int32_t* pb = (const int32_t*)b;
  int32_t* po = (int32_t*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case bbf::OP_MUL:
      launch_elementwise<bbf::OP_MUL>(pa, pb, a_word, b_word, po, L, s);
      break;
    case bbf::OP_ADD:
      launch_elementwise<bbf::OP_ADD>(pa, pb, a_word, b_word, po, L, s);
      break;
    case bbf::OP_SUB:
      launch_elementwise<bbf::OP_SUB>(pa, pb, a_word, b_word, po, L, s);
      break;
    case bbf::OP_NEG:
      launch_elementwise<bbf::OP_NEG>(pa, pb, a_word, b_word, po, L, s);
      break;
    case bbf::OP_TO_MONTY:
      launch_elementwise<bbf::OP_TO_MONTY>(pa, pb, a_word, b_word, po, L, s);
      break;
    case bbf::OP_FROM_MONTY:
      launch_elementwise<bbf::OP_FROM_MONTY>(pa, pb, a_word, b_word, po, L,
                                             s);
      break;
    default:
      launch_elementwise<bbf::OP_FROM_WRAPPED_U32>(pa, pb, a_word, b_word, po,
                                                   L, s);
  }
  return (int)cudaGetLastError();
}

// K2.  out: [n, 5] contiguous.
extern "C" int field_ext_mul_launch(const void* a, const void* b, void* out,
                                    const void* layout, void* stream) {
  const Layout L = read_layout((const int64_t*)layout);
  if (!valid(L)) return (int)cudaErrorInvalidValue;
  if (L.n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (small(L))
    field_ext_mul_kernel<uint32_t><<<blocks(L), THREADS, 0, s>>>(
        (const int32_t*)a, (const int32_t*)b, (int32_t*)out, L);
  else
    field_ext_mul_kernel<uint64_t><<<blocks(L), THREADS, 0, s>>>(
        (const int32_t*)a, (const int32_t*)b, (int32_t*)out, L);
  return (int)cudaGetLastError();
}

// K3.  out: [n] contiguous.
extern "C" int field_inv_launch(const void* a, void* out, const void* layout,
                                void* stream) {
  const Layout L = read_layout((const int64_t*)layout);
  if (!valid(L)) return (int)cudaErrorInvalidValue;
  if (L.n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (small(L))
    field_inv_kernel<uint32_t><<<blocks(L), THREADS, 0, s>>>(
        (const int32_t*)a, (int32_t*)out, L);
  else
    field_inv_kernel<uint64_t><<<blocks(L), THREADS, 0, s>>>(
        (const int32_t*)a, (int32_t*)out, L);
  return (int)cudaGetLastError();
}

// K4.  out: [n, 5] contiguous.
extern "C" int field_ext_inv_launch(const void* a, void* out,
                                    const void* layout, void* stream) {
  const Layout L = read_layout((const int64_t*)layout);
  if (!valid(L)) return (int)cudaErrorInvalidValue;
  if (L.n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (small(L))
    field_ext_inv_kernel<uint32_t><<<blocks(L), THREADS, 0, s>>>(
        (const int32_t*)a, (int32_t*)out, L);
  else
    field_ext_inv_kernel<uint64_t><<<blocks(L), THREADS, 0, s>>>(
        (const int32_t*)a, (int32_t*)out, L);
  return (int)cudaGetLastError();
}
