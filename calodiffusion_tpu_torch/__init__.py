"""PyTorch / CUDA port of calodiffusion_tpu for NVIDIA Hopper GPUs."""
