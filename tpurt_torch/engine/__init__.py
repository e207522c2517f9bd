from .renderer import Renderer, RendererConfig  # noqa: F401
from .frame_timer import FrameTimer  # noqa: F401
