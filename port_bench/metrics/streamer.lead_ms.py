"""Ms a step by which the device end of the program's ``streamer.window``
span follows its host end: the work still queued on the card when
``propagate_window`` returns (near 0 when the host waited for the card
inside the window). From the spans that det_sam2_tpu_torch.utils.profiling
recorded in the traced window; nothing without a card or spans."""


def read(trace):
    try:
        from det_sam2_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    got = [(r.device_end_ns - r.host_end_ns) / 1e6 for r in spans()
           if r.name == "streamer.window" and r.device_end_ns is not None]
    return sum(got) / trace.steps if got else None
