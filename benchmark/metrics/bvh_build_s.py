"""Set-up seconds of the scene's device state: the host BVH8 build of every
triangle and the upload of the tables (the ``setup.device_state`` span)."""


def read(run):
    s = run.spans.seconds("setup.device_state")
    return s[0] if s else None
