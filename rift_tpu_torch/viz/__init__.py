from .render import BEVRenderer, VideoRecorder

__all__ = ["BEVRenderer", "VideoRecorder"]
