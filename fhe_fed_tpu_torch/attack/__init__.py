"""Attack suite: DLG gradient inversion (recovers inputs from shared
gradients; fails when sensitive layers are protected), gradient
sensitivity + top-k masking, and the similarity metrics, the counterpart
of fhe_fed_tpu.attack (reference code/attack/: code.py,
masking/masking.py, similarity.py)."""

from .dlg import dlg_attack, model_gradients, DLGResult
from .masking import gradient_sensitivity, top_k_mask, mask_gradients
from .similarity import mssim, uqi, vifp, msssim

__all__ = ["dlg_attack", "model_gradients", "DLGResult",
           "gradient_sensitivity", "top_k_mask", "mask_gradients",
           "mssim", "msssim", "uqi", "vifp"]
