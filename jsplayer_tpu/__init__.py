"""jsplayer_tpu — accelerator-native batched video-decode framework.

From-scratch re-build of thedeemon/jsplayer's capabilities (ScreenPressor
v2/v3/v4 + MSVideo1 AVI streaming playback) as a jax/XLA/Pallas + C++
pipeline for ML ingestion and headless serving.  See README.md for the
architecture and SURVEY.md for the behavior contract.

Public surface:
  Player / PlayerConfig          — interactive playback API (Main.hx parity)
  VideoIngestPipeline            — batched AVI → model-tensor windows
  transcode_sp                   — re-encode SP streams between versions
  transcode_to_lane              — re-encode into the device-entropy lane
                                   container (ingest sp_device_path="lane")
  open_source                    — byte-range sources (file / memory)
"""

__version__ = "0.2.0"

from .core.source import ByteSource, FileSource, MemorySource, open_source  # noqa: F401
from .core.types import CodecType, VideoInfo  # noqa: F401


def __getattr__(name):  # lazy imports: keep `import jsplayer_tpu` light
    if name in ("Player", "PlayerConfig"):
        from . import player

        return getattr(player, name)
    if name in ("VideoIngestPipeline", "IngestConfig"):
        from .pipeline import ingest

        return getattr(ingest, name)
    if name in ("transcode_sp", "transcode_to_lane"):
        from . import transcode

        return getattr(transcode, name)
    raise AttributeError(name)
