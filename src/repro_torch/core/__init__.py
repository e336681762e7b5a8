"""The paper's contribution: edge-inference system model, DFTSP scheduler,
quantization trade-off, and the epoch-based serving simulation."""
from repro_torch.core.request import Request, RequestGenerator     # noqa: F401
from repro_torch.core.environment import EdgeEnv, paper_env        # noqa: F401
from repro_torch.core.dftsp import dftsp_schedule                  # noqa: F401
