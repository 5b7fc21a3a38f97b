"""The benchmark of calodiffusion_tpu_torch: see README.md."""
