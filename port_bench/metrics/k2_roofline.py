"""K2's share of its roofline over the traced window: the key pre-pass
(csrc/flash_banked_keys.cu) and the main kernel (csrc/flash_banked_fwd.cu)
together, the sum of each launch's bound (flops.k2_launches, over the live
keys of each step's frame) over their device time. Nothing when the
profiler saw another number of launches than the shapes imply."""

from port_bench import flops


def read(trace):
    c = trace.cell
    cfg = c["cfg"]
    layers = cfg.memory_attention.num_layers
    main = [us for _, us in trace.kernels("::flash_banked_bf16<")
            + trace.kernels("::flash_banked_f32<")]
    keys = [us for _, us in trace.kernels("flash_banked_keys_kernel")]
    if not main or len(main) != layers * trace.steps or len(keys) != len(main):
        return None
    bound = 0.0
    for k in c["frame_indices"]:
        for f, b in flops.k2_launches(cfg, c["rows"], k):
            bound += layers * flops.bound_s(f, b)
    return 100.0 * bound / ((sum(main) + sum(keys)) / 1e6)
