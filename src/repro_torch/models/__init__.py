from repro_torch.models.model import Model  # noqa: F401
