from repro_torch.models.api import ModelFns, build_model  # noqa: F401
from repro_torch.models.common import ExecConfig  # noqa: F401
