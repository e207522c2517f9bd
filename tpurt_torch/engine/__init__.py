from .renderer import Renderer, RendererConfig  # noqa: F401
