"""``kernels_roofline``: the least device time that the requests answered
inside the profiled span need (their bytes over the card's memory
bandwidth, ``roofline.py``), as a share of the time the device was busy
in that span.  The span starts and ends on request boundaries."""


def read(run):
    peaks = run.peaks()
    t = run.trace
    if peaks is None or t is None or not t["busy_s"] > 0 or not run.traced:
        return None
    need = sum(run.bytes_needed(r) for r in run.traced if r.error is None)
    return 100.0 * need / peaks["hbm_bytes_per_s"] / t["busy_s"]
