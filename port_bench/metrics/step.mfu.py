"""The whole step's share of the bf16 peak: the model FLOPs of each traced
step (flops.step_model_flops: trunk, neck, memory attention, SAM heads,
memory encoder, from the cell's shapes and the step's memory) over the
traced window's seconds times 989 TFLOP/s."""

from port_bench import flops


def read(trace):
    c = trace.cell
    per_memory = {}
    total = 0.0
    for k in c["frame_indices"]:
        key = flops.memory_live(c["cfg"], k)
        if key not in per_memory:
            per_memory[key] = flops.step_model_flops(c["cfg"], c["frames"], c["rows"], k)
        total += per_memory[key]
    return 100.0 * total / (trace.window_s * flops.PEAK_BF16)
