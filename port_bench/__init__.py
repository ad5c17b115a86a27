"""The benchmark of det_sam2_tpu_torch on one H100: see README.md."""
