"""The device's idle share of the traced window: one minus the union of
its intervals (kernels, copies, memsets) over the window."""


def read(ctx, result, trace):
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
