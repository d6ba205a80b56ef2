"""The card's memory the scene takes: ``torch.cuda.max_memory_allocated``
over set-up and window (reset at the run's start), GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
