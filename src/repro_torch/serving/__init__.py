from repro_torch.serving.sampling import make_sampler  # noqa: F401
