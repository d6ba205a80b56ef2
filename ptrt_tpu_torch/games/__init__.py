"""The example games (counterpart of ``ptrt_tpu/games``): the cube slider,
the heightfield fluid and the tycoon, each driven through the unified
scene's handles (``run_headless``) or as fused frames (``run_fused``,
``games/fused.py``: the step, the instance update and the frame with no host
scene edit)."""
