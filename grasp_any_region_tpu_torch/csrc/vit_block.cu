// Kernels D and G: the LayerNorm-fed GEMMs of the fused ViT block, as a
// LayerNorm pass and then the Hopper GEMM of gemm_sm90.cu (kernel F's TMA +
// wgmma main loop, gemm_sm90.cuh), launched one after the other on the
// caller's stream. Activations are bf16 rows (T * S of them, the tiles of
// the batch flattened; the ragged edge is zero-filled by TMA on the way in
// and clipped on the way out, nothing is padded), every sum is fp32, and
// the epilogues keep the JAX kernels' rounding points.
//
// D  replaces grasp_any_region_tpu/ops/vit_block.py:vit_ln_qkv (_ln_qkv_kernel):
//    xn = bf16(LayerNorm(x)) by kernel 24's row body (layer_norm.cuh), then
//    out = bf16(xn @ wqkv + bqkv).
// G  replaces vit_block.py:vit_mlp_residual (_mlp_kernel):
//    xn as D's, h = bf16(gelu(xn @ fc1 + b1)) (fc1: the tanh or the erf
//    form in fp32), then out = bf16(x + ls * (h @ fc2 + b2)), kernel F's
//    epilogue with K = M.
//
// The TPU kernel keeps G's (rows, M) hidden in VMEM. On this card one CTA
// cannot hold the fc2 accumulator of a 128-row tile (128 x D fp32: 512 KB
// at D = 1024), so h goes to device memory and back: 286 MB at gar_1b,
// ~0.085 ms at 3.35 TB/s, under products whose bound is 0.2956 ms (G stays
// above the card's 295 FLOP/byte line). fc2's N-fastest tile order lets
// the D / 128 column tiles of a row block read its h rows from the L2.
// xn (35.7 MB at gar_1b) fits in the 50 MB L2. The caller allocates xn and
// h; the LayerNorm pass writes no row past `rows`.
//
// Bound by the tensor cores: D 109.6 GFLOP (0.1108 ms at 989 TFLOP/s), G
// 292.3 GFLOP (0.2956 ms) at gar_1b.
#include "gemm_sm90.cuh"
#include "layer_norm.cuh"

namespace {

// xn = bf16(LayerNorm(x)) with fp32 weight and bias; d, n multiples of 128.
int ln_pass(const void* x, const void* ln_w, const void* ln_b, void* xn, int rows, int d,
            float eps, cudaStream_t s) {
  if (rows <= 0 || d <= 0 || d % 128 || d > 8192) return static_cast<int>(cudaErrorInvalidValue);
  return gar::dispatch_layer_norm<gar::bf16>(x, ln_w, ln_b, xn, rows, d, true, true, eps, s);
}

}  // namespace

// x (rows, d), xn (rows, d) a workspace, out (rows, n): bf16 contiguous;
// w (d, n) bf16 row-major; ln_w, ln_b (d,), bias (n,) fp32. d and n
// multiples of 128; all bases 16-byte aligned.
extern "C" int gar_vit_ln_qkv(const void* x, const void* ln_w, const void* ln_b, const void* w,
                              const void* bias, void* xn, void* out, int rows, int d, int n,
                              float eps, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n % 128) return static_cast<int>(cudaErrorInvalidValue);
  int err = ln_pass(x, ln_w, ln_b, xn, rows, d, eps, s);
  if (err) return err;
  return gar::gemm90::gemm(gar::gemm90::kBias, xn, w, nullptr, static_cast<const float*>(bias),
                           nullptr, out, rows, n, d, s);
}

// x, out (rows, d), xn (rows, d) and h (rows, m) workspaces: bf16
// contiguous; fc1 (d, m), fc2 (m, d) bf16 row-major; ln_w, ln_b, b2, ls
// (d,), b1 (m,) fp32. d and m multiples of 128; all bases 16-byte aligned.
extern "C" int gar_vit_mlp_residual(const void* x, const void* ln_w, const void* ln_b,
                                    const void* fc1, const void* b1, const void* fc2,
                                    const void* b2, const void* ls, void* xn, void* h, void* out,
                                    int rows, int d, int m, float eps, int fast_gelu,
                                    void* stream) {
  using namespace gar::gemm90;
  const auto s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || m % 128) return static_cast<int>(cudaErrorInvalidValue);
  int err = ln_pass(x, ln_w, ln_b, xn, rows, d, eps, s);
  if (!err)
    err = gemm(fast_gelu ? kBiasGelu : kBiasGeluErf, xn, fc1, nullptr,
               static_cast<const float*>(b1), nullptr, h, rows, m, d, s);
  if (!err)
    err = gemm(kResidual, h, fc2, x, static_cast<const float*>(b2),
               static_cast<const float*>(ls), out, rows, d, m, s);
  return err;
}
