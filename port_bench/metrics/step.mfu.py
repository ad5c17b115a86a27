"""The whole step's share of the bf16 peak: the model FLOPs of each traced
step (the family's ``step_flops`` in the trace's cell; for SAM 2.1
flops.step_model_flops: trunk, neck, memory attention, SAM heads, memory
encoder, from the cell's shapes and the step's memory) over the traced
window's seconds times 989 TFLOP/s."""

from port_bench import flops


def read(trace):
    c = trace.cell
    total = sum(c["step_flops"](k) for k in c["frame_indices"])
    return 100.0 * total / (trace.window_s * flops.PEAK_BF16)
