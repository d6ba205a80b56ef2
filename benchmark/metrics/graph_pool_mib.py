"""The memory the card reserved for the scene's captured frame programs
(``graphs.Program.stats["pool_bytes"]`` summed over ``Scene._programs``),
MiB."""


def read(run):
    return run.pool_bytes / 2 ** 20 if run.pool_bytes else None
