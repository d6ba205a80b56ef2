"""The host's milliseconds a frame in the replay's enqueue: the mean
``frame.enqueue`` span over the traced run's window frames."""


def read(run):
    ms = [1e3 * (e - s) for n, s, e in run.window_spans
          if n == "frame.enqueue"]
    return sum(ms) / len(ms) if ms else None
