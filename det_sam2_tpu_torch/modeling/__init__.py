"""Model modules of the port (NHWC feature maps, torch.nn)."""
