// Kernel 24: LayerNorm over the trailing dim of a (rows, D) bf16 or fp32
// array, with bf16 or fp32 weight and bias; the output has x's dtype.
//
// Replaces grasp_any_region_tpu/ops/norms.py:layer_norm_fused (_ln_kernel).
// The row body, and what bounds it, are in layer_norm.cuh; the TPU kernel's
// row padding has no counterpart.
#include "layer_norm.cuh"

// x_f32 / w_f32 / b_f32: 1 for fp32, 0 for bf16.
extern "C" int gar_layer_norm(const void* x, const void* w, const void* b, void* out, int rows,
                              int d, int x_f32, int w_f32, int b_f32, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || d % 8 != 0 || d > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return x_f32 ? gar::dispatch_layer_norm<float>(x, w, b, out, rows, d, w_f32, b_f32, eps, s)
               : gar::dispatch_layer_norm<gar::bf16>(x, w, b, out, rows, d, w_f32, b_f32, eps, s);
}
