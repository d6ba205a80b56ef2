"""The walks' work rate over the profiled stretch: the stretch's
``rays_traced`` summed (the algorithm's count: camera, bounce and shadow
rays; each frame's copied as it is made) over the stretch's walk time
(``walk_ms`` times its frames), Mrays/s."""

from benchmark.metrics import walk_ms


def read(run):
    ms = walk_ms.read(run)
    if ms is None or not run.rays_profiled:
        return None
    return run.rays_profiled / (ms * run.profile.frames / 1e3) / 1e6
