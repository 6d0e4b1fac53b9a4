"""Rate of the serving API's host staging (GB/s): the bytes the program's
``predictor.stage`` spans count in the window (the chunks' rows and pad rows
copied into the pinned staging slots) over the summed host seconds of those
spans.  Against the engine's pace it says whether the host's staging sets
the pace of a call.  A program that records no such span reads nothing."""

from benchmark.metrics.step_idle_pct import program_spans


def read(ctx):
    stage = [s for s in program_spans(ctx) or () if s.name == "predictor.stage"]
    nbytes = sum(s.counts.get("bytes", 0) for s in stage)
    seconds = sum(s.end_ns - s.start_ns for s in stage) / 1e9
    if not nbytes or not seconds:
        return None
    return nbytes / seconds / 1e9
