"""Host-device synchronisations a step inside the program's
``streamer.window`` span and the spans under it (blocking copies,
``.item()``, nonzero and boolean indexing, stream and event synchronises:
each one holds the host until the card catches up), from the spans that
det_sam2_tpu_torch.utils.profiling recorded in the traced window. Nothing
when the program records no spans."""


def read(trace):
    try:
        from det_sam2_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    recs = spans()
    inside, syncs = [], 0
    for r in recs:
        inside.append(r.name == "streamer.window"
                      or (r.parent is not None and inside[r.parent]))
        syncs += r.syncs if inside[-1] else 0
    if not any(inside):
        return None
    return syncs / trace.steps
