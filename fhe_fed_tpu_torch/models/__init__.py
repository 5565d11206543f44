from .zoo import build, ModelSpec, MODEL_NAMES, LADDER
from .layers import param_count

__all__ = ["build", "ModelSpec", "MODEL_NAMES", "LADDER", "param_count"]
