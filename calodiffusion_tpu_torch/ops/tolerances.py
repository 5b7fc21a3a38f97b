"""How far each CUDA kernel may lie from its plain PyTorch version, with the
reasons; ``chip_smoke.py`` and the kernel tests hold the kernels to these.

K1, K3, K4, K5: elementwise, |kernel - plain| <= atol + rtol * |plain|, as
(atol, rtol) by dtype.  K2 and K4's backward: max-norm relative error of
each gradient, max|kernel - plain| / max|plain|, by dtype.
"""

import torch

# K1 (the attention block's forward) against attention_block_reference_f32,
# the plain version in f32 from the same bf16 values, rounded to bf16:
# - f32 (TF32 off on both sides): only the order of f32 sums differs, over
#   up to N*C = 207k terms in the GroupNorm statistics: 1e-4 absolute.
# - bf16: the kernel keeps the q/k projections and the softmax numerators in
#   f32 (as the Pallas kernel does), so the unit-scale post-GN term may
#   differ by a few bf16 ulps (1/64 each below 2), and the residual sum
#   rounds to bf16 at the output's magnitude: 0.0625 plus 2 ulps of the
#   output (2 * 2^-7 relative).  The plain version run in bf16 rounds the
#   projections and numerators to bf16 first; at C = 96 and N >= 105 (HGCal's
#   deep blocks) that alone puts it up to 0.117 from float64 (CPU, B = 128,
#   chip_smoke's inputs), past this bound, while the f32 plain version
#   rounded to bf16 stays within 0.031: so K1 is held to the latter.
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

# Q1 (the W8A8 int8 convolution) against int8_conv3d_reference, and the
# port's int8 convolutions against the JAX package's on the same input: the
# s32 sums are exact everywhere (|q| <= 127, K <= 2^17), and the
# dequantization, float(sum) * (sw * sx) + b, takes the same two f32
# roundings and one cast.  Q1 and its plain version: equal bit for bit, f32
# and bf16.  Against XLA (which may contract the two into one FMA): within
# one ulp of the activation dtype.
Q1_ULPS = 1

# A whole int8 network call (the port's against the JAX package's, or the
# card's against the CPU's, from the same weights, scale table and inputs)
# is not held elementwise: the float activations of the two sides differ by
# ~1e-6 relative (other orders of f32 sums), and every quantized conv
# rounds its input to a step of absmax / 127, so a difference that flips one
# input step feeds the next conv's input a change that flips a few per cent
# of its steps.  Within a few convs the two runs differ by int8 noise of
# their own: on tests/test_torch_port_quant.py's U-Net (widths 16, f32), a
# 1e-6 relative perturbation of the input alone moves the port's int8
# denoise by 4.1 % max-norm and 3.1 % RMS, as much as int8 moves it from
# float (4.1 % and 3.7 %).  Each quantized conv of the call is held to the
# JAX op on its own input instead (Q1_ULPS), and the call's RMS difference
# to INT8_NOISE_RMS times the JAX package's own int8-vs-float RMS gap: two
# independent int8 roundings of one float call lie sqrt(2) gaps apart.
INT8_NOISE_RMS = 2.0
