from calodiffusion_tpu_torch.samplers.registry import SAMPLER_REGISTRY, get_sampler  # noqa: F401
