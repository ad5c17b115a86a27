"""Device ms a step of the program's ``engine.fill`` span (hole filling of
the window's mask logits): from the CUDA event at its entry to the one at
its exit on the stream, so any time the card waited for the host inside the
span counts too (not a sum of kernel times). From the spans that
det_sam2_tpu_torch.utils.profiling recorded in the traced window; nothing
without a card or spans."""


def read(trace):
    try:
        from det_sam2_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    got = [r.device_ms for r in spans() if r.name == "engine.fill" and r.device_ms is not None]
    return sum(got) / trace.steps if got else None
