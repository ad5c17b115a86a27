"""Device ms a step of the kernels launched inside image_encoder's range
(the Hiera trunk and the FPN neck)."""


def read(trace):
    s = trace.range_device_s("image_encoder")
    return None if s is None else 1e3 * s / trace.steps
