"""Host ms a step of the program's ``streamer.window`` span (the whole
``BatchedVideoStreamer.propagate_window`` call), from the spans that
det_sam2_tpu_torch.utils.profiling recorded in the traced window. Nothing
when the program records no spans."""


def read(trace):
    try:
        from det_sam2_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    got = [r.host_ms for r in spans() if r.name == "streamer.window"]
    return sum(got) / trace.steps if got else None
