"""Model zoo of the PyTorch port (dense decoder stacks so far)."""
from repro_torch.models.api import Model, build_model  # noqa: F401
