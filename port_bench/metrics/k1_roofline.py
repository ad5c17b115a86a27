"""K1's share of its roofline over the traced window (csrc/flash_fwd.cu):
the sum of each launch's bound (flops.k1_launch, from the cell's shapes)
over the sum of the launches' device time. Nothing when the profiler saw
another number of K1 launches than the shapes imply. (torch's own flash
attention kernels, which run Hiera's windowed blocks, are named
``flash_fwd_kernel``: the match takes K1's instances only.)"""

from port_bench import flops


def read(trace):
    got = trace.kernels("::flash_fwd_bf16<") + trace.kernels("::flash_fwd_f32<")
    c = trace.cell
    launches = flops.k1_step_launches(c["cfg"], c["frames"], c["rows"])
    if not got or len(got) != len(launches) * trace.steps:
        return None
    bound = trace.steps * sum(flops.bound_s(*flops.k1_launch(*shape)) for shape in launches)
    return 100.0 * bound / (sum(us for _, us in got) / 1e6)
