"""Share of its HBM roofline that the direct cubic warp takes in the step
(``csrc/warp_cubic.cu``, ``warp_cubic_kernel``): bytes a launch must move
(``harness/flops.py``) over the HBM bandwidth, over its device time."""
LAYER, UNIT, SOURCE, MOVES, BETTER = ("kernels", "%", "device_trace", "train_slices_per_s",
                                      "higher")


def read(ctx):
    s = ctx["summary"]
    if s is None:
        return None
    us, n = s.kernel_us("::warp_cubic_kernel")
    if not n:
        return None
    least_s = n * ctx["flops"].warp_cubic_bytes(ctx["flags"]) / ctx["peaks"].HBM_BYTES_PER_S
    return 100.0 * least_s / (us / 1e6)
