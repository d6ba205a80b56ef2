"""Seconds from the process's start to the window's first present: imports,
the kernels' build (first run in a checkout), the scene, the host BVH
build and upload, the capture and the warm frames."""


def read(run):
    return run.setup_s
