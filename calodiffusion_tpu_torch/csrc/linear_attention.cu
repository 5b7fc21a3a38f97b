// LinearAttention (heads = 1) with its 1x1 convolutions fused in, forward,
// for Hopper (sm_90a): K3, which replaces the Pallas kernel
// calodiffusion_tpu/ops/pallas_linear_attention.py::_kernel (entry
// fused_linear_attention).
//
//   y = W_o^T (ctx^T softmax_d(q) d^-1/2) + b_o,
//   q/k/v = W_{q,k,v}^T x, ctx = softmax_N(k) v^T
//
// It is K1 (linear_attention_block.cu) without its two GroupNorms and its
// residual: the same cluster layout, tensor-core products, merges and
// plan, compiled with CALO_LINEAR = 1 (xn = x; phase B writes y, rounded
// to x's dtype, straight out).  The design, bound and numerics are
// described there.  Its backward is autograd of the plain version
// (ops/linear_attention.py), as the JAX custom VJP is.
//
// C entries: calo_linear_attention_plan and calo_linear_attention_forward.

#define CALO_LINEAR 1
#include "linear_attention_block.cu"
