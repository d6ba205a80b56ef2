"""Frame pacing: the 95th percentile of the window's present-to-present
intervals, ms (the upstream's "low" FPS; a stall shows here).  In a traced
run the intervals the profiler slows are left out."""

from benchmark import window


def read(run):
    return window.frame_ms_p95(run.presents, run.window_frames,
                               run.profiled)
