from .optimizer import DirectConfig, DirectResult, direct_optimize
from .service import DirectService

__all__ = ["DirectConfig", "DirectResult", "direct_optimize",
           "DirectService"]
