"""det_sam2_tpu_torch: the PyTorch / CUDA port of det_sam2_tpu for the H100.

The JAX package ``det_sam2_tpu`` is the reference; this package mirrors its
module names (configs, convert, modeling/*, ops/*, state, track) and imports
nothing of it. Its Pallas TPU kernels are hand-written CUDA C++ under
``csrc/``, built at first use (see ``ops/attention.py``).

The builders and predictors are exported lazily, as in the JAX package:
``from det_sam2_tpu_torch import build_sam2_video_predictor`` imports the
modules that hold them only when the name is first read.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level exports (importing the package imports no model code)."""
    if name in ("build_sam2", "build_sam2_video_predictor",
                "build_sam2_engine"):
        from det_sam2_tpu_torch import build

        return getattr(build, name)
    if name == "SAM2VideoPredictor":
        from det_sam2_tpu_torch.video_predictor import SAM2VideoPredictor

        return SAM2VideoPredictor
    if name == "SAM2ImagePredictor":
        from det_sam2_tpu_torch.image_predictor import SAM2ImagePredictor

        return SAM2ImagePredictor
    if name == "SAM2AutomaticMaskGenerator":
        from det_sam2_tpu_torch.automatic_mask_generator import (
            SAM2AutomaticMaskGenerator,
        )

        return SAM2AutomaticMaskGenerator
    raise AttributeError(f"module 'det_sam2_tpu_torch' has no attribute {name!r}")
