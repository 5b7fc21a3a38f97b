"""How far each CUDA kernel may lie from its plain PyTorch version, with the
reasons; ``chip_smoke.py`` and the kernel tests hold the kernels to these.

K1, K3, K4, K5: elementwise, |kernel - plain| <= atol + rtol * |plain|, as
(atol, rtol) by dtype.  K2 and K4's backward: max-norm relative error of
each gradient, max|kernel - plain| / max|plain|, by dtype.
"""

import torch

# K1 (the attention block's forward) against attention_block_reference:
# - f32 (TF32 off on both sides): only the order of f32 sums differs, over
#   up to N*C = 207k terms in the GroupNorm statistics: 1e-4 absolute.
# - bf16: the kernel keeps the q/k projections and the softmax numerators in
#   f32 (as the Pallas kernel does) where the plain version rounds them to
#   bf16 first, so the unit-scale post-GN term may differ by a few bf16 ulps
#   (1/64 each below 2), and the residual sum rounds to bf16 at the output's
#   magnitude: 0.0625 plus 2 ulps of the output (2 * 2^-7 relative).
K1_TOL = {torch.bfloat16: (0.0625, 2.0**-6), torch.float32: (1e-4, 0.0)}

# K2 (its backward) against attention_block_backward_reference:
# - f32: both sides compute in f32 and differ in the order of their sums,
#   over up to N*C = 207k terms a sample (the GroupNorm-backward sums) and
#   B*N = 830k positions (the weight gradients), which the GroupNorm
#   backward's cancellations amplify; the JAX package holds its Pallas
#   backward to the XLA VJP at 3e-3 (tests/test_pallas_linear_attention.py).
#   1e-4 here: 40x the largest seen on the card and under CPU emulation.
# - bf16: the kernel rounds to bf16 only where the Pallas kernel casts and
#   accumulates in f32; the plain version's autograd rounds every product's
#   output and every intermediate gradient to bf16 (2^-8 relative each) along
#   a chain of ~6 products and two GroupNorm backwards: 5e-2, about 3x the
#   largest seen on the card (dx at N = 6480).
K2_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-4}

# K3 (LinearAttention alone) against linear_attention_reference: the JAX
# package's own bounds for its Pallas kernel against the same plain version
# (tests/test_pallas_linear_attention.py:36-48).
# - f32 (TF32 off): only the order of the f32 sums differs (over N up to
#   40,500 positions in ctx): 2e-5 + 2e-4 relative.
# - bf16: the kernel keeps the q/k projections and the softmax numerators in
#   f32 where the plain version rounds them to bf16 first; outputs of order
#   one then differ by a few bf16 ulps: 3e-2 + 3e-2 relative.
K3_TOL = {torch.bfloat16: (3e-2, 3e-2), torch.float32: (2e-5, 2e-4)}

# K4 (blockwise softmax attention) against dense_attention.  Both widen q,
# k, v to f32 and compute scores, exponentials and sums in f32, in other
# orders (N up to 40,500 keys); outputs are weighted means of v, of order
# 0.1 at unit-normal inputs.
# - f32: 1e-4 absolute, 10x below the JAX package's card check of its kernel
#   (scripts/pallas_tpu_check.py:50: 1e-3 at N = 4096).
# - bf16: the same f32 results rounded once each to bf16 may land one bf16
#   ulp apart (at most 2^-7 of the value): 1e-4 + 2^-7 relative.
K4_TOL = {torch.bfloat16: (1e-4, 2.0**-7), torch.float32: (1e-4, 0.0)}

# K4's backward (csrc/blockwise_attention_bwd.cu) against
# attention_backward_reference, autograd of dense_attention, on dq, dk, dv:
# - f32: both sides compute in f32 and differ in the order of their sums
#   (over up to N = 40,500 keys for dq, queries for dk and dv), in Drow taken
#   from K4's f32 output (within 1e-4 of the dense one) against autograd's
#   own sum, and in the exponentials; dS = P (dP - Drow) cancels where a few
#   keys carry the weight: 1e-4, as K2_TOL (the card: at most 1.7e-5, q x 8).
# - bf16: the plain version rounds each gradient to bf16 once (2^-9 of the
#   largest entry); the kernel also rounds P and dS to bf16 as operands of
#   its products (2^-9 relative a term) and takes Drow from the bf16 output
#   (2^-9 relative an element).  Simulated at N = 512 and 2048, q x 1 and x 8
#   (scripts/torch_attention_backward_rounding.py): at most 7.4e-3; the
#   card: at most 7.5e-3.  2e-2, about 3x that, as K2_TOL was set.
K4B_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# K5 (GroupNorm + SiLU) against gn_silu_reference.  Both take the group
# statistics in f32 over up to 162,000 terms a group (ds3 level 0: 40,500
# positions x 4 channels), in other orders, two-pass; |out| up to ~5.
# - f32: 1e-4 absolute.
# - bf16: one rounding each of nearly equal f32 values: 1e-4 + 2^-7 relative
#   (the JAX card check, pallas_tpu_check.py:72, allowed 0.04 for a one-pass
#   kernel against a two-pass reference).
K5_TOL = {torch.bfloat16: (1e-4, 2.0**-7), torch.float32: (1e-4, 0.0)}
