"""Host ms a step from the frames' hand-over to propagate_window's return
(the streamer's and the engine's host path queueing the step), the mean
over the traced steps."""


def read(trace):
    return 1e3 * sum(trace.dispatch_s) / len(trace.dispatch_s)
