"""Multi-device pixel tiles (``sharding``) and the multi-device dry run
(``dryrun``)."""

from ptrt_tpu_torch.parallel.sharding import (  # noqa: F401
    make_pixel_mesh,
    replicate,
    shard_pixels,
)
