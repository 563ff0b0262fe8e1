"""The host's time in G's call, ms a request: the program's
``infer.generate`` spans of the traced requests over their count (one a
request), beside g_call_ms.sample's device time. Each request ends in a
read-back, so the launches find an empty queue and the span is the
host's own time, under the profiler. Moves sample_faces_per_s."""

from benchmark.lib.spans import host_ms_per


def read(outcome):
    return host_ms_per(outcome, "infer.generate")
