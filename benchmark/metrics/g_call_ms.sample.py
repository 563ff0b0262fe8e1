"""Device time under the harness's span around GanInference.generate, ms
a request. Moves sample_faces_per_s."""

from benchmark.lib.readers import span_device_ms


def read(outcome):
    return span_device_ms(outcome, "inference.generate", "requests")
