"""Video analogies: frame sequences over the batch runner, with the warm
start, the temporal term (`SynthConfig.tau`) and delta scheduling of
warm frames (`sequence`; the `IA_VIDEO_WARM` seam)."""

from .sequence import (  # noqa: F401
    VideoStream,
    field_delta,
    flicker_metric,
    frame_delta,
    set_warm_mode,
    synthesize_video,
    warm_enabled,
    warm_mode,
    warm_schedule,
)

__all__ = [
    "VideoStream",
    "field_delta",
    "flicker_metric",
    "frame_delta",
    "set_warm_mode",
    "synthesize_video",
    "warm_enabled",
    "warm_mode",
    "warm_schedule",
]
