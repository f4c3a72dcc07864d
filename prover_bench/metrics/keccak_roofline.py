"""The hash layer's share of its roofline over the recorded jobs (Merkle
trees and row leaves): the least time its calls' work needs (`yardstick`),
summed, over the device time of everything launched inside their ranges
(`tracing.reduce_trace`), in %."""


def read(run):
    if run.profile is None:
        return None
    return run.profile["rooflines"].get("hash")
