"""Device ms a step of the kernels launched inside memory_attention's range
(self-attention on K1, cross-attention on K2, the MLPs)."""


def read(trace):
    s = trace.range_device_s("memory_attention")
    return None if s is None else 1e3 * s / trace.steps
